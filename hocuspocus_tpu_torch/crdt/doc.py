"""Doc and Transaction — the Y.js-compatible document container.

Transaction lifecycle mirrors yjs: nested transact calls share one
transaction; cleanup runs observers, GCs deleted content, merges adjacent
structs, and emits the 'update' event with the v1-encoded delta of the
transaction (consumed by the server broadcast path, reference
`packages/server/src/Document.ts:228`).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Optional

from .delete_set import DeleteSet
from .encoding import Encoder
from .ids import ID
from .structs import GC, Item, StructStore
from .types.base import clear_search_markers
from .types.ytext import cleanup_ytext_after_transaction
from .update import transaction_changed, write_update_message_from_transaction


class Observable:
    """Minimal event emitter (on/once/off/emit)."""

    def __init__(self) -> None:
        self._observers: dict[str, list[Callable]] = {}

    def on(self, name: str, fn: Callable) -> Callable:
        self._observers.setdefault(name, []).append(fn)
        return fn

    def once(self, name: str, fn: Callable) -> None:
        def wrapper(*args: Any) -> None:
            self.off(name, wrapper)
            fn(*args)

        self.on(name, wrapper)

    def off(self, name: str, fn: Callable) -> None:
        listeners = self._observers.get(name)
        if listeners and fn in listeners:
            listeners.remove(fn)

    def emit(self, name: str, *args: Any) -> None:
        listeners = self._observers.get(name)
        if not listeners:
            # fast path: transaction plumbing emits 7 lifecycle events
            # per transact and most go unobserved — don't allocate
            return
        for fn in list(listeners):
            fn(*args)

    def has_listeners(self, name: str) -> bool:
        return bool(self._observers.get(name))


def generate_new_client_id() -> int:
    return random.getrandbits(32)


class Transaction:
    __slots__ = (
        "doc",
        "delete_set",
        "before_state",
        "after_state",
        "changed",
        "changed_parent_types",
        "_merge_structs",
        "origin",
        "local",
        "meta",
        "subdocs_added",
        "subdocs_removed",
        "subdocs_loaded",
        "_need_formatting_cleanup",
    )

    def __init__(self, doc: "Doc", origin: Any, local: bool) -> None:
        self.doc = doc
        self.delete_set = DeleteSet()
        self.before_state: dict[int, int] = doc.store.get_state_vector()
        self.after_state: dict[int, int] = {}
        # AbstractType -> set of changed parentSubs (None = list changed)
        self.changed: dict[Any, set[Optional[str]]] = {}
        # AbstractType -> [YEvent] for deep observers
        self.changed_parent_types: dict[Any, list[Any]] = {}
        self._merge_structs: list[Any] = []
        self.origin = origin
        self.local = local
        self.meta: dict[Any, Any] = {}
        self.subdocs_added: set[Doc] = set()
        self.subdocs_removed: set[Doc] = set()
        self.subdocs_loaded: set[Doc] = set()
        self._need_formatting_cleanup = False

    def add_changed_type(self, ytype: Any, parent_sub: Optional[str]) -> None:
        item = ytype._item
        if item is None or (
            item.id.clock < self.before_state.get(item.id.client, 0) and not item.deleted
        ):
            self.changed.setdefault(ytype, set()).add(parent_sub)

    def next_id(self) -> ID:
        doc = self.doc
        return ID(doc.client_id, doc.store.get_state(doc.client_id))


def _try_to_merge_with_lefts(structs: list, pos: int) -> int:
    right = structs[pos]
    i = pos
    while i > 0:
        left = structs[i - 1]
        if left.deleted == right.deleted and type(left) is type(right) and left.merge_with(right):
            if (
                isinstance(right, Item)
                and right.parent_sub is not None
                and right.parent is not None
                and not isinstance(right.parent, (ID, str))
                and right.parent._map.get(right.parent_sub) is right
            ):
                right.parent._map[right.parent_sub] = left
            i -= 1
            right = left
            continue
        break
    merged = pos - i
    if merged:
        del structs[pos + 1 - merged : pos + 1]
    return merged


def _try_gc_delete_set(ds: DeleteSet, store: StructStore, gc_filter: Callable) -> None:
    for client, ranges in ds.clients.items():
        structs = store.clients.get(client)
        if not structs:
            continue
        for clock, length in reversed(ranges):
            end = clock + length
            si = StructStore.find_index(structs, clock)
            while si < len(structs):
                struct = structs[si]
                if struct.id.clock >= end:
                    break
                if isinstance(struct, Item) and struct.deleted and not struct.keep and gc_filter(struct):
                    struct.gc(store, False)
                si += 1


def _try_merge_delete_set(ds: DeleteSet, store: StructStore) -> None:
    for client, ranges in ds.clients.items():
        structs = store.clients.get(client)
        if not structs:
            continue
        for clock, length in reversed(ranges):
            most_right = min(len(structs) - 1, 1 + StructStore.find_index(structs, clock + length - 1))
            si = most_right
            while si > 0 and structs[si].id.clock >= clock:
                si -= 1 + _try_to_merge_with_lefts(structs, si)


def _cleanup_transactions(cleanups: list[Transaction], i: int) -> None:
    if i >= len(cleanups):
        return
    transaction = cleanups[i]
    doc = transaction.doc
    store = doc.store
    ds = transaction.delete_set
    try:
        ds.sort_and_merge()
        transaction.after_state = store.get_state_vector()
        if not transaction.local:
            # remote structs land via integrate, not the marker-aware
            # list ops — cached index anchors are stale wholesale
            # (yjs AbstractType._callObserver does the same)
            for ytype in transaction.changed:
                clear_search_markers(ytype)
        doc.emit("beforeObserverCalls", transaction, doc)
        for ytype, subs in list(transaction.changed.items()):
            if ytype._item is None or not ytype._item.deleted:
                ytype._call_observer(transaction, subs)
        # deep observers, sorted by path length
        for ytype, events in list(transaction.changed_parent_types.items()):
            if ytype._deep_handlers and (ytype._item is None or not ytype._item.deleted):
                live = [e for e in events if e.target._item is None or not e.target._item.deleted]
                for event in live:
                    event.current_target = ytype
                    event._path = None
                live.sort(key=lambda e: len(e.path))
                for fn in list(ytype._deep_handlers):
                    fn(live, transaction)
        doc.emit("afterTransaction", transaction, doc)
        if transaction._need_formatting_cleanup:
            cleanup_ytext_after_transaction(transaction)
    finally:
        if doc.gc:
            _try_gc_delete_set(ds, store, doc.gc_filter)
        _try_merge_delete_set(ds, store)
        for client, clock in transaction.after_state.items():
            before_clock = transaction.before_state.get(client, 0)
            if before_clock != clock:
                structs = store.clients[client]
                first_change = max(StructStore.find_index(structs, before_clock), 1)
                si = len(structs) - 1
                while si >= first_change:
                    si -= 1 + _try_to_merge_with_lefts(structs, si)
        for struct in transaction._merge_structs:
            client, clock = struct.id
            structs = store.clients.get(client)
            if not structs:
                continue
            replaced_pos = StructStore.find_index(structs, clock)
            if replaced_pos + 1 < len(structs):
                _try_to_merge_with_lefts(structs, replaced_pos + 1)
            if 0 < replaced_pos < len(structs):
                _try_to_merge_with_lefts(structs, replaced_pos)
        if not transaction.local and transaction.after_state.get(doc.client_id) != transaction.before_state.get(
            doc.client_id
        ):
            doc.client_id = generate_new_client_id()
        doc.emit("afterTransactionCleanup", transaction, doc)
        if doc.has_listeners("update"):
            wire = transaction.meta.get("wire_update")
            if wire is not None and transaction_changed(transaction):
                # clean remote apply (see update.apply_update): the
                # transaction is exactly the received update, so re-emit
                # the wire bytes and skip the store re-encode
                doc.emit("update", wire, transaction.origin, doc, transaction)
            else:
                encoder = Encoder()
                if write_update_message_from_transaction(encoder, transaction):
                    doc.emit("update", encoder.to_bytes(), transaction.origin, doc, transaction)
        if transaction.subdocs_added or transaction.subdocs_removed or transaction.subdocs_loaded:
            for subdoc in transaction.subdocs_added:
                subdoc.client_id = doc.client_id
                if subdoc.collection_id is None:
                    subdoc.collection_id = doc.collection_id
                doc.subdocs.add(subdoc)
            doc.emit(
                "subdocs",
                {
                    "loaded": set(transaction.subdocs_loaded),
                    "added": set(transaction.subdocs_added),
                    "removed": set(transaction.subdocs_removed),
                },
                doc,
                transaction,
            )
            for subdoc in transaction.subdocs_removed:
                doc.subdocs.discard(subdoc)
                subdoc.destroy()
        if len(cleanups) <= i + 1:
            doc._transaction_cleanups = []
            doc.emit("afterAllTransactions", doc, cleanups)
        else:
            _cleanup_transactions(cleanups, i + 1)


class Doc(Observable):
    """A Y.js-compatible CRDT document."""

    def __init__(
        self,
        guid: Optional[str] = None,
        collection_id: Optional[str] = None,
        gc: bool = True,
        gc_filter: Callable = lambda item: True,
        meta: Any = None,
        auto_load: bool = False,
        should_load: bool = True,
    ) -> None:
        super().__init__()
        self.client_id = generate_new_client_id()
        self.guid = guid if guid is not None else _random_guid()
        self.collection_id = collection_id
        self.gc = gc
        self.gc_filter = gc_filter
        self.meta = meta
        self.auto_load = auto_load
        self.should_load = should_load
        self.share: dict[str, Any] = {}
        self.store = StructStore()
        self.subdocs: set[Doc] = set()
        self.is_loaded = False
        self.is_synced = False
        self.is_destroyed = False
        self._item: Optional[Item] = None
        self._transaction: Optional[Transaction] = None
        self._transaction_cleanups: list[Transaction] = []

    # -- transactions ------------------------------------------------------

    def transact(self, fn: Callable[[Transaction], Any], origin: Any = None, local: bool = True) -> Any:
        initial = self._transaction is None
        if initial:
            self._transaction = Transaction(self, origin, local)
            self._transaction_cleanups.append(self._transaction)
            if len(self._transaction_cleanups) == 1:
                self.emit("beforeAllTransactions", self)
            self.emit("beforeTransaction", self._transaction, self)
        try:
            return fn(self._transaction)
        finally:
            if initial:
                finish = self._transaction is self._transaction_cleanups[0]
                self._transaction = None
                if finish:
                    _cleanup_transactions(self._transaction_cleanups, 0)

    # -- root types --------------------------------------------------------

    def get(self, name: str, type_constructor: Optional[type] = None):
        from .types.base import AbstractType

        constructor = type_constructor or AbstractType
        ytype = self.share.get(name)
        if ytype is None:
            ytype = constructor()
            ytype._integrate(self, None)
            self.share[name] = ytype
            return ytype
        if constructor is not AbstractType and type(ytype) is not constructor:
            if type(ytype) is AbstractType:
                upgraded = constructor()
                upgraded._map = ytype._map
                for item in ytype._map.values():
                    node = item
                    while node is not None:
                        node.parent = upgraded
                        node = node.left
                upgraded._start = ytype._start
                node = upgraded._start
                while node is not None:
                    node.parent = upgraded
                    node = node.right
                upgraded._length = ytype._length
                # state observed while the root was still generic must
                # survive the retype (ContentFormat integrates set this
                # before anyone called get_text)
                upgraded._has_formatting = ytype._has_formatting
                self.share[name] = upgraded
                upgraded._integrate(self, None)
                return upgraded
            raise TypeError(
                f"root type {name!r} already defined as {type(ytype).__name__}, "
                f"requested {constructor.__name__}"
            )
        return ytype

    def get_text(self, name: str = ""):
        from .types.ytext import YText

        return self.get(name, YText)

    def get_array(self, name: str = ""):
        from .types.yarray import YArray

        return self.get(name, YArray)

    def get_map(self, name: str = ""):
        from .types.ymap import YMap

        return self.get(name, YMap)

    def get_xml_fragment(self, name: str = ""):
        from .types.yxml import YXmlFragment

        return self.get(name, YXmlFragment)

    def to_json(self) -> dict[str, Any]:
        return {key: value.to_json() for key, value in self.share.items()}

    # -- subdoc lifecycle --------------------------------------------------

    def load(self) -> None:
        item = self._item
        if item is not None and not self.should_load:
            parent_doc = item.parent.doc  # type: ignore[union-attr]
            parent_doc.transact(lambda tr: tr.subdocs_loaded.add(self), local=True)
        self.should_load = True

    def get_subdoc_guids(self) -> set[str]:
        return {d.guid for d in self.subdocs}

    def destroy(self) -> None:
        self.is_destroyed = True
        for subdoc in list(self.subdocs):
            subdoc.destroy()
        item = self._item
        if item is not None:
            self._item = None
            content = item.content
            from .content import ContentDoc, create_doc_from_opts

            if isinstance(content, ContentDoc):
                replacement = create_doc_from_opts(self.guid, {**content.opts, "shouldLoad": False})
                replacement.should_load = False
                content.doc = replacement
                replacement._item = item
        self.emit("destroyed", True)
        self.emit("destroy", self)
        self._observers = {}


def _random_guid() -> str:
    import uuid

    return str(uuid.uuid4())
