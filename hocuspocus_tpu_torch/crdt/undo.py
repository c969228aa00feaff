"""UndoManager — selective undo/redo over shared types.

The Y.js-ecosystem capability users expect alongside the CRDT engine:
undo/redo of LOCAL changes (by transaction origin) that cooperates with
concurrent remote edits — undoing an insert deletes exactly that
content; undoing a delete recreates the content at its causal position
via redone chains, never reverting other clients' work.

Semantics follow yjs's UndoManager/StackItem/redoItem design (scope
types, trackedOrigins, captureTimeout merge, keep-flags protecting
undo targets from GC); the implementation is in this engine's idioms.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Optional

from .delete_set import DeleteSet
from .doc import Observable, Transaction
from .ids import ID
from .structs import GC, Item, StructStore
from .types.base import AbstractType, clear_search_markers


class StackItem:
    __slots__ = ("deletions", "insertions", "meta")

    def __init__(self, deletions: DeleteSet, insertions: DeleteSet) -> None:
        self.deletions = deletions
        self.insertions = insertions
        self.meta: dict = {}


def _is_parent_of(parent: AbstractType, item: Optional[Item]) -> bool:
    while item is not None:
        if item.parent is parent:
            return True
        item = item.parent._item if isinstance(item.parent, AbstractType) else None
    return False


def _keep_item(item: Optional[Item], keep: bool) -> None:
    while item is not None and item.keep != keep:
        item.keep = keep
        item = item.parent._item if isinstance(item.parent, AbstractType) else None


def _find_item(store: StructStore, sid: ID):
    structs = store.clients.get(sid.client)
    if not structs:
        return None
    index = StructStore.find_index(structs, sid.clock)
    return structs[index]


def _follow_redone(store: StructStore, sid: ID) -> tuple[Any, int]:
    """Walk redone pointers; returns (item, diff into that item)."""
    next_id: Optional[ID] = sid
    diff = 0
    item = None
    while next_id is not None:
        if diff > 0:
            next_id = ID(next_id.client, next_id.clock + diff)
        item = _find_item(store, next_id)
        if item is None:
            return None, 0
        diff = next_id.clock - item.id.clock
        next_id = item.redone if isinstance(item, Item) else None
    return item, diff


def _iterate_deleted_structs(
    transaction: Transaction, ds: DeleteSet, fn: Callable[[Any], None]
) -> None:
    store = transaction.doc.store
    for client, clock, length in list(ds.iterate()):
        structs = store.clients.get(client)
        if not structs:
            continue
        store.iterate_structs(transaction, client, clock, length, fn)


class UndoManager(Observable):
    def __init__(
        self,
        scope: AbstractType | Iterable[AbstractType],
        tracked_origins: Optional[Iterable[Any]] = None,
        capture_timeout: float = 500.0,
        delete_filter: Callable[[Item], bool] = lambda item: True,
        ignore_remote_map_changes: bool = False,
    ) -> None:
        super().__init__()
        self.scope: list[AbstractType] = (
            [scope] if isinstance(scope, AbstractType) else list(scope)
        )
        if not self.scope:
            raise ValueError("UndoManager needs at least one scope type")
        self.doc = self.scope[0].doc
        self.delete_filter = delete_filter
        self.ignore_remote_map_changes = ignore_remote_map_changes
        # None = local transactions with no explicit origin (the default
        # origin of direct type mutations); the manager itself is always
        # tracked so undo transactions land on the redo stack
        self.tracked_origins: set[Any] = {None, self}
        if tracked_origins:
            self.tracked_origins |= set(tracked_origins)
        self.capture_timeout = capture_timeout
        self.undo_stack: list[StackItem] = []
        self.redo_stack: list[StackItem] = []
        self.undoing = False
        self.redoing = False
        self._last_change = 0.0
        self.doc.on("afterTransaction", self._after_transaction)

    # -- capture -----------------------------------------------------------

    def _in_scope(self, transaction: Transaction) -> bool:
        changed = transaction.changed_parent_types
        return any(t in changed or t in transaction.changed for t in self.scope)

    def _tracks(self, transaction: Transaction) -> bool:
        # origin None is tracked only for LOCAL transactions: remote updates
        # applied via apply_update run with origin=None/local=False and must
        # never land on the undo stack (yjs providers pass themselves as
        # origin; our apply path signals remoteness via transaction.local)
        if transaction.origin not in self.tracked_origins:
            return False
        return transaction.origin is not None or transaction.local

    def _after_transaction(self, transaction: Transaction, doc: Any) -> None:
        if not self._in_scope(transaction) or (
            not self._tracks(transaction)
            and not (self.undoing or self.redoing)
        ):
            return
        if self.undoing:
            stack = self.redo_stack
        elif self.redoing:
            stack = self.undo_stack
        else:
            stack = self.undo_stack
            self._clear_stack(self.redo_stack)

        insertions = DeleteSet()
        for client, after_clock in transaction.after_state.items():
            before_clock = transaction.before_state.get(client, 0)
            if after_clock > before_clock:
                insertions.add(client, before_clock, after_clock - before_clock)
        deletions = DeleteSet()
        for client, clock, length in transaction.delete_set.iterate():
            deletions.add(client, clock, length)
        deletions.sort_and_merge()

        now = time.monotonic() * 1000
        merged = False
        if (
            not self.undoing
            and not self.redoing
            and stack
            and now - self._last_change < self.capture_timeout
        ):
            last = stack[-1]
            for client, clock, length in deletions.iterate():
                last.deletions.add(client, clock, length)
            for client, clock, length in insertions.iterate():
                last.insertions.add(client, clock, length)
            last.deletions.sort_and_merge()
            last.insertions.sort_and_merge()
            merged = True
        else:
            stack.append(StackItem(deletions, insertions))
        if not self.undoing and not self.redoing:
            self._last_change = now

        # protect undo targets from GC: deleted structs we may recreate
        _iterate_deleted_structs(
            transaction,
            deletions,
            lambda struct: _keep_item(struct, True)
            if isinstance(struct, Item)
            and any(_is_parent_of(t, struct) for t in self.scope)
            else None,
        )
        self.emit(
            "stack-item-added",
            {
                "stack_item": stack[-1],
                "origin": transaction.origin,
                "type": "undo" if stack is self.undo_stack else "redo",
                "merged": merged,
            },
            self,
        )

    # -- operations --------------------------------------------------------

    def undo(self) -> Optional[StackItem]:
        self.undoing = True
        try:
            return self._pop(self.undo_stack, "undo")
        finally:
            self.undoing = False

    def redo(self) -> Optional[StackItem]:
        self.redoing = True
        try:
            return self._pop(self.redo_stack, "redo")
        finally:
            self.redoing = False

    def stop_capturing(self) -> None:
        """The next tracked change starts a fresh stack item."""
        self._last_change = 0.0

    def can_undo(self) -> bool:
        return len(self.undo_stack) > 0

    def can_redo(self) -> bool:
        return len(self.redo_stack) > 0

    def clear(self, clear_undo: bool = True, clear_redo: bool = True) -> None:
        if clear_undo:
            self._clear_stack(self.undo_stack)
        if clear_redo:
            self._clear_stack(self.redo_stack)

    def destroy(self) -> None:
        self.doc.off("afterTransaction", self._after_transaction)

    def _clear_stack(self, stack: list[StackItem]) -> None:
        stack.clear()

    # -- the undo/redo core ------------------------------------------------

    def _pop(self, stack: list[StackItem], kind: str) -> Optional[StackItem]:
        result: Optional[StackItem] = None

        def run(transaction: Transaction) -> None:
            nonlocal result
            store = self.doc.store
            while stack and result is None:
                stack_item = stack.pop()
                items_to_delete: list[Item] = []
                items_to_redo: list[Item] = []
                performed = False

                def collect_insertion(struct: Any) -> None:
                    if not isinstance(struct, Item):
                        return
                    item = struct
                    if item.redone is not None:
                        followed, diff = _follow_redone(store, struct.id)
                        if followed is None:
                            return
                        if diff > 0:
                            followed = store.get_item_clean_start(
                                transaction, ID(followed.id.client, followed.id.clock + diff)
                            )
                        item = followed
                    if not item.deleted and any(
                        _is_parent_of(t, item) for t in self.scope
                    ):
                        items_to_delete.append(item)

                _iterate_deleted_structs(
                    transaction, stack_item.insertions, collect_insertion
                )

                def collect_deletion(struct: Any) -> None:
                    if (
                        isinstance(struct, Item)
                        and any(_is_parent_of(t, struct) for t in self.scope)
                        and not stack_item.insertions.is_deleted(
                            struct.id.client, struct.id.clock
                        )
                    ):
                        items_to_redo.append(struct)

                _iterate_deleted_structs(
                    transaction, stack_item.deletions, collect_deletion
                )

                for item in items_to_redo:
                    performed = (
                        self._redo_item(
                            transaction,
                            item,
                            set(items_to_redo),
                            stack_item.insertions,
                        )
                        is not None
                    ) or performed
                # delete later insertions first to keep earlier positions
                for item in reversed(items_to_delete):
                    if self.delete_filter(item):
                        item.delete(transaction)
                        performed = True
                result = stack_item if performed else None
            # undo manipulates items directly (redo copies, deletes),
            # bypassing the marker-aware list ops — structurally changed
            # types must drop their cached index anchors (yjs does the
            # same at the end of its pop transaction)
            for ytype, subs in transaction.changed.items():
                if None in subs:
                    clear_search_markers(ytype)

        self.doc.transact(run, origin=self)
        if result is not None:
            self.emit(
                "stack-item-popped",
                {"stack_item": result, "type": kind},
                self,
            )
        return result

    def _redo_item(
        self,
        transaction: Transaction,
        item: Item,
        redo_items: set[Item],
        items_to_delete: DeleteSet,
    ) -> Optional[Item]:
        doc = self.doc
        store = doc.store
        if item.redone is not None:
            return store.get_item_clean_start(transaction, item.redone)

        parent_item = (
            item.parent._item if isinstance(item.parent, AbstractType) else None
        )
        left: Optional[Item] = None
        right: Optional[Item] = None
        if parent_item is not None and parent_item.deleted:
            # the parent itself was deleted: redo it first
            if parent_item.redone is None:
                if parent_item not in redo_items or (
                    self._redo_item(transaction, parent_item, redo_items, items_to_delete)
                    is None
                ):
                    return None
            while parent_item.redone is not None:
                parent_item = store.get_item_clean_start(transaction, parent_item.redone)

        parent_type = (
            item.parent
            if parent_item is None
            # collected parents have ContentDeleted: `.type` is gone
            else getattr(parent_item.content, "type", None)
        )
        if parent_type is None:
            # the parent's redone chain ended at a collected item:
            # there is no live type to redo into — refuse the redo
            # (the downstream list/map walks would dereference it)
            return None

        if item.parent_sub is None:
            # list position: walk left/right neighbors through redone
            # chains until ones alive under the (possibly redone) parent
            left = item.left
            right = item
            while left is not None:
                trace = left
                while trace is not None and (
                    trace.parent._item
                    if isinstance(trace.parent, AbstractType)
                    else None
                ) is not parent_item:
                    trace = (
                        store.get_item_clean_start(transaction, trace.redone)
                        if trace.redone is not None
                        else None
                    )
                if trace is not None:
                    left = trace
                    break
                left = left.left
            while right is not None:
                trace = right
                while trace is not None and (
                    trace.parent._item
                    if isinstance(trace.parent, AbstractType)
                    else None
                ) is not parent_item:
                    trace = (
                        store.get_item_clean_start(transaction, trace.redone)
                        if trace.redone is not None
                        else None
                    )
                if trace is not None:
                    right = trace
                    break
                right = right.right
        else:
            right = None
            if item.right is not None and not self.ignore_remote_map_changes:
                left = item
                while left is not None and left.right is not None and (
                    left.right.redone is not None
                    or items_to_delete.is_deleted(
                        left.right.id.client, left.right.id.clock
                    )
                ):
                    left = left.right
                    while left.redone is not None:
                        left = store.get_item_clean_start(transaction, left.redone)
                if left is not None and left.right is not None:
                    return None  # a concurrent map set won; keep it
            else:
                left = parent_type._map.get(item.parent_sub)

        next_id = transaction.next_id()
        redone = Item(
            next_id,
            left,
            left.last_id if left is not None else None,
            right,
            right.id if right is not None else None,
            parent_type,
            item.parent_sub,
            item.content.copy(),
        )
        item.redone = next_id
        _keep_item(redone, True)
        redone.integrate(transaction, 0)
        return redone
