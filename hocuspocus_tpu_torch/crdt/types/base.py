"""AbstractType, YEvent and shared list/map primitives (Y.js semantics)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Iterable, Optional

from ..content import (
    Content,
    ContentAny,
    ContentBinary,
    ContentDoc,
    ContentType,
)
from ..encoding import UNDEFINED, Encoder
from ..ids import ID
from ..structs import Item

if TYPE_CHECKING:
    from ..doc import Doc, Transaction

# Type refs in ContentType encoding (yjs typeRefs order).
YARRAY_REF = 0
YMAP_REF = 1
YTEXT_REF = 2
YXML_ELEMENT_REF = 3
YXML_FRAGMENT_REF = 4
YXML_HOOK_REF = 5
YXML_TEXT_REF = 6


class AbstractType:
    """Base of all shared types. Holds the item linked list and key map."""

    _type_ref: int = -1

    def __init__(self) -> None:
        self._item: Optional[Item] = None
        self._map: dict[str, Item] = {}
        self._start: Optional[Item] = None
        self.doc: Optional["Doc"] = None
        self._length = 0
        self._handlers: list[Callable] = []
        self._deep_handlers: list[Callable] = []
        self._has_formatting = False
        # sequence types (YText/YArray/YXmlFragment) set this to [] —
        # cached (item, visible-index) anchors that turn index->position
        # walks from O(doc) into O(distance); None = markers disabled
        self._search_markers: "Optional[list[SearchMarker]]" = None

    # -- wiring ------------------------------------------------------------

    def _integrate(self, doc: "Doc", item: Optional[Item]) -> None:
        self.doc = doc
        self._item = item

    def _copy(self) -> "AbstractType":
        return type(self)()

    def _write(self, encoder: Encoder) -> None:
        encoder.write_var_uint(self._type_ref)

    @property
    def parent(self) -> Optional["AbstractType"]:
        return self._item.parent if self._item else None  # type: ignore[return-value]

    # -- observers ---------------------------------------------------------

    def observe(self, fn: Callable) -> Callable:
        self._handlers.append(fn)
        return fn

    def unobserve(self, fn: Callable) -> None:
        if fn in self._handlers:
            self._handlers.remove(fn)

    def observe_deep(self, fn: Callable) -> Callable:
        self._deep_handlers.append(fn)
        return fn

    def unobserve_deep(self, fn: Callable) -> None:
        if fn in self._deep_handlers:
            self._deep_handlers.remove(fn)

    def _call_observer(self, transaction: "Transaction", parent_subs: set[Optional[str]]) -> None:
        """Subclasses create their event and call `call_type_observers`."""

    # -- helpers -----------------------------------------------------------

    def _transact(self, fn: Callable[["Transaction"], Any]) -> Any:
        doc = self.doc
        if doc is None:
            raise RuntimeError("type is not attached to a document")
        return doc.transact(fn)

    def to_json(self) -> Any:
        return None

    def __len__(self) -> int:
        return self._length


# -- search markers --------------------------------------------------------
#
# Index->position lookups on the item list are linear from _start; on a
# busy document (config1: 14M chars by the end of one bench run) every
# local edit paid an O(doc) walk. Markers cache (item, visible-index)
# anchors near recent edit positions, yjs ArraySearchMarker semantics
# (vendored yjs in this image: rx/rT/rM around `maxSearchMarker`):
# nearest-anchor lookup, refresh-or-LRU replacement, left-normalization
# to mergeable-run starts so transaction-cleanup merges keep anchors
# valid, incremental shifts on local edits, wholesale invalidation on
# remote transactions and undo/redo pops (doc.py / undo.py).

MAX_SEARCH_MARKERS = 16

_marker_clock = 0


class SearchMarker:
    __slots__ = ("item", "index", "timestamp")

    def __init__(self, item: Item, index: int) -> None:
        global _marker_clock
        _marker_clock += 1
        item.marker = True
        self.item = item
        self.index = index
        self.timestamp = _marker_clock


def _refresh_marker(marker: SearchMarker, item: Item, index: int) -> None:
    global _marker_clock
    _marker_clock += 1
    marker.item.marker = False
    item.marker = True
    marker.item = item
    marker.index = index
    marker.timestamp = _marker_clock


def find_search_marker(parent: AbstractType, index: int) -> Optional[SearchMarker]:
    """Anchor at (or left of) visible position `index`, or None.

    The returned marker's item CONTAINS the target position with
    marker.index <= index being the item's first visible unit; callers
    finish with a short forward walk of (index - marker.index).
    """
    markers = parent._search_markers
    if parent._start is None or index == 0 or markers is None:
        return None
    marker = (
        min(markers, key=lambda m: abs(index - m.index)) if markers else None
    )
    item: Item = parent._start
    idx = 0
    if marker is not None:
        item = marker.item
        idx = marker.index
        global _marker_clock
        _marker_clock += 1
        marker.timestamp = _marker_clock  # keep the hot anchor alive
    while item.right is not None and idx < index:
        if not item.deleted and item.countable:
            if index < idx + item.length:
                break
            idx += item.length
        item = item.right
    while item.left is not None and idx > index:
        item = item.left
        if not item.deleted and item.countable:
            idx -= item.length
    # normalize to the start of the same-client run: cleanup merges
    # absorb right halves INTO the run head, so only run-head anchors
    # survive a merge
    while (
        item.left is not None
        and item.left.id.client == item.id.client
        and item.left.id.clock + item.left.length == item.id.clock
    ):
        item = item.left
        if not item.deleted and item.countable:
            idx -= item.length
    if (
        marker is not None
        and abs(marker.index - idx) < (parent._length / MAX_SEARCH_MARKERS)
    ):
        _refresh_marker(marker, item, idx)
        return marker
    if len(markers) >= MAX_SEARCH_MARKERS:
        oldest = min(markers, key=lambda m: m.timestamp)
        _refresh_marker(oldest, item, idx)
        return oldest
    fresh = SearchMarker(item, idx)
    markers.append(fresh)
    return fresh


def update_search_markers(parent: AbstractType, index: int, delta: int) -> None:
    """Shift anchors after a LOCAL list change: `delta` visible units
    inserted (+) or deleted (-) at visible position `index`."""
    markers = parent._search_markers
    if not markers:
        return
    for i in range(len(markers) - 1, -1, -1):
        marker = markers[i]
        if delta > 0:
            # an insert may have split/tombstoned the anchored item:
            # rebind to the nearest live countable item to the left
            item: Optional[Item] = marker.item
            item.marker = False
            while item is not None and (item.deleted or not item.countable):
                item = item.left
                if item is not None and not item.deleted and item.countable:
                    marker.index -= item.length
            if item is None or item.marker:
                del markers[i]  # dead end, or another anchor owns it
                continue
            marker.item = item
            item.marker = True
        if index < marker.index or (delta > 0 and index == marker.index):
            marker.index = max(index, marker.index + delta)


def clear_search_markers(parent: AbstractType) -> None:
    markers = parent._search_markers
    if markers:
        for marker in markers:
            marker.item.marker = False
        markers.clear()


def call_type_observers(ytype: AbstractType, transaction: "Transaction", event: Any) -> None:
    changed_type = ytype
    node = ytype
    while True:
        transaction.changed_parent_types.setdefault(node, []).append(event)
        if node._item is None:
            break
        node = node._item.parent  # type: ignore[assignment]
    for fn in list(changed_type._handlers):
        fn(event, transaction)


class YEvent:
    """Change description delivered to observers (delta/keys/path)."""

    def __init__(self, target: AbstractType, transaction: "Transaction") -> None:
        self.target = target
        self.current_target: AbstractType = target
        self.transaction = transaction
        self._changes: Optional[dict] = None
        self._keys: Optional[dict] = None
        self._delta: Optional[list] = None
        self._path: Optional[list] = None

    @property
    def path(self) -> list:
        if self._path is None:
            self._path = _get_path_to(self.current_target, self.target)
        return self._path

    def adds(self, struct: Any) -> bool:
        return struct.id.clock >= self.transaction.before_state.get(struct.id.client, 0)

    def deletes(self, struct: Any) -> bool:
        return self.transaction.delete_set.is_deleted(struct.id.client, struct.id.clock)

    @property
    def keys(self) -> dict[str, dict]:
        if self._keys is None:
            keys: dict[str, dict] = {}
            changed = self.transaction.changed.get(self.target, set())
            for key in changed:
                if key is None:
                    continue
                item = self.target._map.get(key)
                if item is None:
                    continue
                action: Optional[str] = None
                old_value: Any = None
                if self.adds(item):
                    prev = item.left
                    while prev is not None and self.adds(prev):
                        prev = prev.left
                    if self.deletes(item):
                        if prev is not None and self.deletes(prev):
                            action = "delete"
                            old_value = _last_content(prev)
                        else:
                            continue
                    elif prev is not None and self.deletes(prev):
                        action = "update"
                        old_value = _last_content(prev)
                    else:
                        action = "add"
                        old_value = UNDEFINED
                elif self.deletes(item):
                    action = "delete"
                    old_value = _last_content(item)
                else:
                    continue
                keys[key] = {"action": action, "oldValue": old_value}
            self._keys = keys
        return self._keys

    @property
    def delta(self) -> list[dict]:
        return self.changes["delta"]

    @property
    def changes(self) -> dict:
        if self._changes is None:
            target = self.target
            added: set = set()
            deleted: set = set()
            delta: list[dict] = []
            changed = self.transaction.changed.get(target, set())
            if None in changed:
                last_op: Optional[dict] = None

                def pack() -> None:
                    nonlocal last_op
                    if last_op is not None:
                        delta.append(last_op)
                        last_op = None

                item = target._start
                while item is not None:
                    if item.deleted:
                        if self.deletes(item) and not self.adds(item):
                            if last_op is None or "delete" not in last_op:
                                pack()
                                last_op = {"delete": 0}
                            last_op["delete"] += item.length
                            deleted.add(item)
                    elif self.adds(item):
                        if last_op is None or "insert" not in last_op:
                            pack()
                            last_op = {"insert": []}
                        last_op["insert"] = last_op["insert"] + item.content.get_content()
                        added.add(item)
                    else:
                        if last_op is None or "retain" not in last_op:
                            pack()
                            last_op = {"retain": 0}
                        last_op["retain"] += item.length
                    item = item.right
                if last_op is not None and "retain" not in last_op:
                    pack()
            self._changes = {"added": added, "deleted": deleted, "delta": delta, "keys": self.keys}
        return self._changes


def _last_content(item: Item) -> Any:
    content = item.content.get_content()
    return content[-1] if content else None


def _get_path_to(parent: AbstractType, child: AbstractType) -> list:
    path: list = []
    while child._item is not None and child is not parent:
        item = child._item
        if item.parent_sub is not None:
            path.insert(0, item.parent_sub)
        else:
            # list index of item within parent
            i = 0
            node = item.parent._start  # type: ignore[union-attr]
            while node is not item and node is not None:
                if not node.deleted and node.countable:
                    i += node.length
                node = node.right
            path.insert(0, i)
        child = item.parent  # type: ignore[assignment]
    return path


# -- list primitives -------------------------------------------------------


def type_list_to_array(ytype: AbstractType) -> list:
    result: list = []
    item = ytype._start
    while item is not None:
        if item.countable and not item.deleted:
            result.extend(item.content.get_content())
        item = item.right
    return result


def type_list_slice(ytype: AbstractType, start: int, end: int) -> list:
    if start < 0:
        start = ytype._length + start
    if end < 0:
        end = ytype._length + end
    length = end - start
    result: list = []
    item = ytype._start
    while item is not None and length > 0:
        if item.countable and not item.deleted:
            values = item.content.get_content()
            if len(values) <= start:
                start -= len(values)
            else:
                for value in values[start : start + length]:
                    result.append(value)
                    length -= 1
                start = 0
        item = item.right
    return result


def type_list_get(ytype: AbstractType, index: int) -> Any:
    marker = find_search_marker(ytype, index)
    item = ytype._start
    if marker is not None:
        item = marker.item
        index -= marker.index
    while item is not None:
        if item.countable and not item.deleted:
            if index < item.length:
                return item.content.get_content()[index]
            index -= item.length
        item = item.right
    return None


def type_list_for_each(ytype: AbstractType, fn: Callable[[Any, int, AbstractType], None]) -> None:
    index = 0
    item = ytype._start
    while item is not None:
        if item.countable and not item.deleted:
            for value in item.content.get_content():
                fn(value, index, ytype)
                index += 1
        item = item.right


def _content_for_value(value: Any) -> Content:
    from ..doc import Doc

    if isinstance(value, (bytes, bytearray, memoryview)):
        return ContentBinary(bytes(value))
    if isinstance(value, Doc):
        return ContentDoc(value)
    if isinstance(value, AbstractType):
        return ContentType(value)
    raise TypeError(f"unsupported content type: {type(value)!r}")


def _is_primitive(value: Any) -> bool:
    return value is None or isinstance(value, (bool, int, float, str, list, tuple, dict))


def type_list_insert_generics_after(
    transaction: "Transaction",
    parent: AbstractType,
    reference_item: Optional[Item],
    contents: Iterable[Any],
) -> None:
    left = reference_item
    doc = transaction.doc
    store = doc.store
    right = parent._start if reference_item is None else reference_item.right
    json_buffer: list = []

    def pack_json() -> None:
        nonlocal left
        if json_buffer:
            item = Item(
                ID(doc.client_id, store.get_state(doc.client_id)),
                left,
                left.last_id if left is not None else None,
                right,
                right.id if right is not None else None,
                parent,
                None,
                ContentAny(list(json_buffer)),
            )
            item.integrate(transaction, 0)
            left = item
            json_buffer.clear()

    for value in contents:
        if _is_primitive(value):
            json_buffer.append(value)
        else:
            pack_json()
            content = _content_for_value(value)
            item = Item(
                ID(doc.client_id, store.get_state(doc.client_id)),
                left,
                left.last_id if left is not None else None,
                right,
                right.id if right is not None else None,
                parent,
                None,
                content,
            )
            item.integrate(transaction, 0)
            left = item
    pack_json()


def type_list_insert_generics(
    transaction: "Transaction", parent: AbstractType, index: int, contents: list
) -> None:
    if index > parent._length:
        raise IndexError("index out of range")
    if index == 0:
        if parent._search_markers is not None:
            update_search_markers(parent, 0, len(contents))
        type_list_insert_generics_after(transaction, parent, None, contents)
        return
    orig_index = index
    store = transaction.doc.store
    marker = find_search_marker(parent, index)
    item = parent._start
    if marker is not None:
        item = marker.item
        index -= marker.index
        if index == 0:
            # boundary: step to the previous LIVE item so the insert
            # lands BEFORE the marked item, not after it (yjs rH's
            # `l = l.prev` dance)
            item = item.left
            while item is not None and item.deleted:
                item = item.left
            if item is not None and item.countable:
                index += item.length
    while item is not None:
        if not item.deleted and item.countable:
            if index <= item.length:
                if index < item.length:
                    store.get_item_clean_start(
                        transaction, ID(item.id.client, item.id.clock + index)
                    )
                break
            index -= item.length
        item = item.right
    if parent._search_markers is not None:
        update_search_markers(parent, orig_index, len(contents))
    type_list_insert_generics_after(transaction, parent, item, contents)


def type_list_push_generics(transaction: "Transaction", parent: AbstractType, contents: list) -> None:
    # start from the furthest-right anchor instead of _start (appends
    # into a long list were an O(doc) walk per push)
    item = parent._start
    markers = parent._search_markers
    if markers:
        best = max(markers, key=lambda m: m.index)
        item = best.item
    last = None
    while item is not None:
        last = item
        item = item.right
    type_list_insert_generics_after(transaction, parent, last, contents)


def type_list_delete(transaction: "Transaction", parent: AbstractType, index: int, length: int) -> None:
    if length == 0:
        return
    start_length = length
    orig_index = index
    store = transaction.doc.store
    marker = find_search_marker(parent, index)
    item = parent._start
    if marker is not None:
        item = marker.item
        index -= marker.index
    while item is not None and index > 0:
        if not item.deleted and item.countable:
            if index < item.length:
                store.get_item_clean_start(transaction, ID(item.id.client, item.id.clock + index))
            index -= item.length
        item = item.right
    while length > 0 and item is not None:
        if not item.deleted:
            if length < item.length:
                store.get_item_clean_start(transaction, ID(item.id.client, item.id.clock + length))
            item.delete(transaction)
            length -= item.length
        item = item.right
    if length > 0:
        raise IndexError(f"delete length exceeded (missing {length} of {start_length})")
    if parent._search_markers is not None:
        update_search_markers(parent, orig_index, -start_length)


# -- map primitives --------------------------------------------------------


def type_map_set(transaction: "Transaction", parent: AbstractType, key: str, value: Any) -> None:
    left = parent._map.get(key)
    doc = transaction.doc
    if _is_primitive(value):
        content: Content = ContentAny([value])
    else:
        content = _content_for_value(value)
    Item(
        ID(doc.client_id, doc.store.get_state(doc.client_id)),
        left,
        left.last_id if left is not None else None,
        None,
        None,
        parent,
        key,
        content,
    ).integrate(transaction, 0)


def type_map_get(ytype: AbstractType, key: str) -> Any:
    item = ytype._map.get(key)
    if item is not None and not item.deleted:
        return item.content.get_content()[item.length - 1]
    return None


def type_map_has(ytype: AbstractType, key: str) -> bool:
    item = ytype._map.get(key)
    return item is not None and not item.deleted


def type_map_delete(transaction: "Transaction", parent: AbstractType, key: str) -> None:
    item = parent._map.get(key)
    if item is not None:
        item.delete(transaction)


def type_map_entries(ytype: AbstractType) -> Iterable[tuple[str, Item]]:
    for key, item in ytype._map.items():
        if not item.deleted:
            yield key, item


def read_type_from_decoder(decoder) -> AbstractType:
    from .yarray import YArray
    from .ymap import YMap
    from .ytext import YText
    from .yxml import YXmlElement, YXmlFragment, YXmlHook, YXmlText

    ref = decoder.read_var_uint()
    if ref == YARRAY_REF:
        return YArray()
    if ref == YMAP_REF:
        return YMap()
    if ref == YTEXT_REF:
        return YText()
    if ref == YXML_ELEMENT_REF:
        return YXmlElement(decoder.read_var_string())
    if ref == YXML_FRAGMENT_REF:
        return YXmlFragment()
    if ref == YXML_HOOK_REF:
        return YXmlHook(decoder.read_var_string())
    if ref == YXML_TEXT_REF:
        return YXmlText()
    raise ValueError(f"unknown type ref {ref}")
