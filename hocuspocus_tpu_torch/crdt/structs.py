"""CRDT structs (Item / GC / Skip) and the StructStore.

The YATA integration algorithm, struct splitting/merging and the v1 binary
struct layout follow Yjs semantics exactly (the reference server delegates
these to the yjs package — SURVEY.md §2.2). Item info byte: low 5 bits =
content ref (0=GC, 10=Skip), 0x80 = has origin, 0x40 = has right origin,
0x20 = has parentSub.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import TYPE_CHECKING, Any, Optional, Union

from .content import Content, ContentDeleted, ContentFormat, ContentType, read_item_content
from .encoding import Decoder, Encoder
from .ids import ID, compare_ids

if TYPE_CHECKING:
    from .doc import Transaction

BIT_ORIGIN = 0x80
BIT_RIGHT_ORIGIN = 0x40
BIT_PARENT_SUB = 0x20
STRUCT_GC_REF = 0
STRUCT_SKIP_REF = 10


class GC:
    """Garbage-collected range: keeps clock continuity, no content."""

    __slots__ = ("id", "length")
    deleted = True

    def __init__(self, sid: ID, length: int) -> None:
        self.id = sid
        self.length = length

    def merge_with(self, right: "GC") -> bool:
        if isinstance(right, GC):
            self.length += right.length
            return True
        return False

    def integrate(self, transaction: "Transaction", offset: int) -> None:
        if offset > 0:
            self.id = ID(self.id.client, self.id.clock + offset)
            self.length -= offset
        transaction.doc.store.add_struct(self)

    def get_missing(self, transaction: "Transaction", store: "StructStore") -> Optional[int]:
        return None

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_uint8(STRUCT_GC_REF)
        encoder.write_var_uint(self.length - offset)


class Skip:
    """Placeholder for a clock range not contained in an update (merge gaps)."""

    __slots__ = ("id", "length")
    deleted = True

    def __init__(self, sid: ID, length: int) -> None:
        self.id = sid
        self.length = length

    def merge_with(self, right: "Skip") -> bool:
        if isinstance(right, Skip):
            self.length += right.length
            return True
        return False

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_uint8(STRUCT_SKIP_REF)
        encoder.write_var_uint(self.length - offset)


class Item:
    """A single CRDT struct: a run of content with YATA ordering metadata."""

    __slots__ = (
        "id",
        "left",
        "right",
        "origin",
        "right_origin",
        "parent",
        "parent_sub",
        "content",
        "length",
        "deleted",
        "keep",
        "redone",
        "marker",  # a types.base.SearchMarker anchors here
    )

    def __init__(
        self,
        sid: ID,
        left: Optional["Item"],
        origin: Optional[ID],
        right: Optional["Item"],
        right_origin: Optional[ID],
        parent: Any,  # AbstractType | ID | str | None
        parent_sub: Optional[str],
        content: Content,
    ) -> None:
        self.id = sid
        self.left = left
        self.right = right
        self.origin = origin
        self.right_origin = right_origin
        self.parent = parent
        self.parent_sub = parent_sub
        self.content = content
        # maintained, not derived: content.get_length() on every access
        # dominated integrate/position profiles. Updated at the four
        # content-mutation sites (integrate-offset, split, merge_with;
        # gc preserves length).
        self.length = content.get_length()
        self.deleted = False
        self.keep = False
        self.redone: Optional[ID] = None
        self.marker = False

    @property
    def countable(self) -> bool:
        return self.content.countable

    @property
    def last_id(self) -> ID:
        length = self.length
        if length == 1:
            return self.id
        return ID(self.id.client, self.id.clock + length - 1)

    def mark_deleted(self) -> None:
        self.deleted = True

    # -- integration -------------------------------------------------------

    def get_missing(self, transaction: "Transaction", store: "StructStore") -> Optional[int]:
        """Return a client whose structs must arrive first, else resolve refs.

        Mirrors yjs Item.getMissing: on success also materializes
        left/right neighbor pointers and the parent type.
        """
        origin = self.origin
        if origin is not None and origin.client != self.id.client and origin.clock >= store.get_state(origin.client):
            return origin.client
        right_origin = self.right_origin
        if (
            right_origin is not None
            and right_origin.client != self.id.client
            and right_origin.clock >= store.get_state(right_origin.client)
        ):
            return right_origin.client
        parent = self.parent
        if (
            isinstance(parent, ID)
            and self.id.client != parent.client
            and parent.clock >= store.get_state(parent.client)
        ):
            return parent.client

        # All dependencies present — resolve them.
        if origin is not None:
            self.left = store.get_item_clean_end(transaction, origin)
            # the origin may resolve into a GC struct (deleted + collected
            # range from a real yjs peer): no last_id to take, and the
            # GC-left check below nulls the parent so this item itself
            # integrates as a GC struct (yjs Item.getMissing semantics)
            self.origin = self.left.last_id if isinstance(self.left, Item) else None
        if right_origin is not None:
            self.right = store.get_item_clean_start(transaction, right_origin)
            self.right_origin = self.right.id
        if isinstance(self.left, GC) or isinstance(self.right, GC):
            self.parent = None
        elif self.parent is None:
            if isinstance(self.left, Item):
                self.parent = self.left.parent
                self.parent_sub = self.left.parent_sub
            if isinstance(self.right, Item):
                self.parent = self.right.parent
                self.parent_sub = self.right.parent_sub
        elif isinstance(self.parent, ID):
            parent_item = store.get_item(self.parent)
            # the parent item may be a GC struct, or a deleted item
            # whose content was collected to ContentDeleted: yjs reads
            # `.type` off it and gets `undefined` (JS member access on
            # a content without the field), integrating the child
            # parentless — mirror that instead of raising
            content = getattr(parent_item, "content", None)
            parent_type = getattr(content, "type", None)
            self.parent = parent_type
        elif isinstance(self.parent, str):
            # root type reference by name
            self.parent = transaction.doc.get(self.parent)
        return None

    def integrate(self, transaction: "Transaction", offset: int) -> None:
        store = transaction.doc.store
        if offset > 0:
            self.id = ID(self.id.client, self.id.clock + offset)
            self.left = store.get_item_clean_end(transaction, ID(self.id.client, self.id.clock - 1))
            self.origin = self.left.last_id
            self.content = self.content.splice(offset)
            self.length -= offset

        parent = self.parent
        if parent is not None:
            left = self.left
            right = self.right
            if (left is None and (right is None or right.left is not None)) or (
                left is not None and left.right is not right
            ):
                # YATA conflict resolution: find the correct left neighbor.
                if left is not None:
                    o = left.right
                elif self.parent_sub is not None:
                    o = parent._map.get(self.parent_sub)
                    while o is not None and o.left is not None:
                        o = o.left
                else:
                    o = parent._start
                conflicting: set[int] = set()
                items_before_origin: set[int] = set()
                while o is not None and o is not right:
                    items_before_origin.add(id(o))
                    conflicting.add(id(o))
                    if compare_ids(self.origin, o.origin):
                        if o.id.client < self.id.client:
                            left = o
                            conflicting.clear()
                        elif compare_ids(self.right_origin, o.right_origin):
                            break
                    elif o.origin is not None:
                        o_origin_item = store.find(o.origin)
                        if id(o_origin_item) in items_before_origin:
                            if id(o_origin_item) not in conflicting:
                                left = o
                                conflicting.clear()
                        else:
                            break
                    else:
                        break
                    o = o.right
                self.left = left

            # Reconnect linked list + parent maps.
            if self.left is not None:
                self.right = self.left.right
                self.left.right = self
            else:
                if self.parent_sub is not None:
                    r = parent._map.get(self.parent_sub)
                    while r is not None and r.left is not None:
                        r = r.left
                else:
                    r = parent._start
                    parent._start = self
                self.right = r
            if self.right is not None:
                self.right.left = self
            elif self.parent_sub is not None:
                parent._map[self.parent_sub] = self
                if self.left is not None:
                    self.left.delete(transaction)  # superseded map entry
            if self.parent_sub is None and self.countable and not self.deleted:
                parent._length += self.length
            store.add_struct(self)
            self.content.integrate(transaction, self)
            transaction.add_changed_type(parent, self.parent_sub)
            if (parent._item is not None and parent._item.deleted) or (
                self.parent_sub is not None and self.right is not None
            ):
                # Parent deleted, or a newer map entry exists for this key.
                self.delete(transaction)
        else:
            # Parent not defined (GC'd) — integrate a GC struct instead.
            GC(self.id, self.length).integrate(transaction, 0)

    def delete(self, transaction: "Transaction") -> None:
        if not self.deleted:
            parent = self.parent
            if self.countable and self.parent_sub is None and parent is not None:
                parent._length -= self.length
            self.mark_deleted()
            transaction.delete_set.add(self.id.client, self.id.clock, self.length)
            if parent is not None:
                transaction.add_changed_type(parent, self.parent_sub)
            self.content.delete(transaction)

    def gc(self, store: "StructStore", parent_gcd: bool) -> None:
        if not self.deleted:
            raise RuntimeError("cannot GC a live item")
        self.content.gc(store)
        if parent_gcd:
            store.replace_struct(self, GC(self.id, self.length))
        else:
            self.content = ContentDeleted(self.length)

    # -- splitting / merging ----------------------------------------------

    def split(self, transaction: "Transaction", diff: int) -> "Item":
        """Split so this item has length `diff`; returns the right part."""
        client, clock = self.id
        right = Item(
            ID(client, clock + diff),
            self,
            ID(client, clock + diff - 1),
            self.right,
            self.right_origin,
            self.parent,
            self.parent_sub,
            self.content.splice(diff),
        )
        self.length = diff
        if self.deleted:
            right.deleted = True
        if self.keep:
            right.keep = True
        if self.redone is not None:
            right.redone = ID(self.redone.client, self.redone.clock + diff)
        self.right = right
        if right.right is not None:
            right.right.left = right
        transaction._merge_structs.append(right)
        if right.parent_sub is not None and right.right is None and right.parent is not None:
            right.parent._map[right.parent_sub] = right
        return right

    def merge_with(self, right: "Item") -> bool:
        if (
            type(right) is Item
            and compare_ids(right.origin, self.last_id)
            and self.right is right
            and compare_ids(self.right_origin, right.right_origin)
            and self.id.client == right.id.client
            and self.id.clock + self.length == right.id.clock
            and self.deleted == right.deleted
            and self.redone is None
            and right.redone is None
            and type(self.content) is type(right.content)
            and self.content.merge_with(right.content)
        ):
            if right.marker:
                # search anchors on the absorbed item rebase onto the
                # survivor (yjs Item.mergeWith does the same)
                markers = getattr(self.parent, "_search_markers", None)
                if markers:
                    for m in markers:
                        if m.item is right:
                            m.item = self
                            self.marker = True
                            if not self.deleted and self.countable:
                                m.index -= self.length
            if right.keep:
                self.keep = True
            self.length += right.length
            self.right = right.right
            if self.right is not None:
                self.right.left = self
            return True
        return False

    # -- encoding ----------------------------------------------------------

    def write(self, encoder: Encoder, offset: int) -> None:
        origin = ID(self.id.client, self.id.clock + offset - 1) if offset > 0 else self.origin
        right_origin = self.right_origin
        parent_sub = self.parent_sub
        info = (
            (self.content.ref & 0x1F)
            | (BIT_ORIGIN if origin is not None else 0)
            | (BIT_RIGHT_ORIGIN if right_origin is not None else 0)
            | (BIT_PARENT_SUB if parent_sub is not None else 0)
        )
        encoder.write_uint8(info)
        if origin is not None:
            encoder.write_var_uint(origin.client)
            encoder.write_var_uint(origin.clock)
        if right_origin is not None:
            encoder.write_var_uint(right_origin.client)
            encoder.write_var_uint(right_origin.clock)
        if origin is None and right_origin is None:
            parent = self.parent
            if isinstance(parent, str):
                encoder.write_var_uint(1)
                encoder.write_var_string(parent)
            elif isinstance(parent, ID):
                encoder.write_var_uint(0)
                encoder.write_var_uint(parent.client)
                encoder.write_var_uint(parent.clock)
            else:
                # integrated AbstractType parent
                item = parent._item
                if item is None:
                    encoder.write_var_uint(1)
                    encoder.write_var_string(find_root_type_key(parent))
                else:
                    encoder.write_var_uint(0)
                    encoder.write_var_uint(item.id.client)
                    encoder.write_var_uint(item.id.clock)
            if parent_sub is not None:
                encoder.write_var_string(parent_sub)
        self.content.write(encoder, offset)


def find_root_type_key(ytype: Any) -> str:
    for key, value in ytype.doc.share.items():
        if value is ytype:
            return key
    raise RuntimeError("root type not attached to a doc")


Struct = Union[Item, GC, Skip]


def read_struct(decoder: Decoder, sid: ID) -> Struct:
    info = decoder.read_uint8()
    ref = info & 0x1F
    if ref == STRUCT_GC_REF:
        return GC(sid, decoder.read_var_uint())
    if ref == STRUCT_SKIP_REF:
        return Skip(sid, decoder.read_var_uint())
    origin = None
    right_origin = None
    if info & BIT_ORIGIN:
        origin = ID(decoder.read_var_uint(), decoder.read_var_uint())
    if info & BIT_RIGHT_ORIGIN:
        right_origin = ID(decoder.read_var_uint(), decoder.read_var_uint())
    parent: Any = None
    parent_sub: Optional[str] = None
    if origin is None and right_origin is None:
        if decoder.read_var_uint() == 1:
            parent = decoder.read_var_string()
        else:
            parent = ID(decoder.read_var_uint(), decoder.read_var_uint())
        if info & BIT_PARENT_SUB:
            parent_sub = decoder.read_var_string()
    content = read_item_content(decoder, info)
    return Item(sid, None, origin, None, right_origin, parent, parent_sub, content)


class StructStore:
    """Per-client sorted struct lists with binary search and splitting."""

    __slots__ = ("clients", "pending_structs", "pending_ds")

    def __init__(self) -> None:
        self.clients: dict[int, list[Struct]] = {}
        # pending update bytes that couldn't integrate yet (missing deps)
        self.pending_structs: Optional[dict[str, Any]] = None  # {missing: {client: clock}, update: bytes}
        self.pending_ds: Optional[bytes] = None

    def get_state(self, client: int) -> int:
        structs = self.clients.get(client)
        if not structs:
            return 0
        last = structs[-1]
        return last.id.clock + last.length

    def get_state_vector(self) -> dict[int, int]:
        return {client: self.get_state(client) for client in self.clients}

    def add_struct(self, struct: Struct) -> None:
        structs = self.clients.get(struct.id.client)
        if structs is None:
            self.clients[struct.id.client] = [struct]
            return
        last = structs[-1]
        if last.id.clock + last.length != struct.id.clock:
            raise RuntimeError("unexpected struct clock (causality violation)")
        structs.append(struct)

    @staticmethod
    def find_index(structs: list[Struct], clock: int) -> int:
        left = 0
        right = len(structs) - 1
        mid = structs[right]
        mid_clock = mid.id.clock
        if mid_clock == clock:
            return right
        # pivot guess assuming uniform distribution
        mid_index = (clock * right) // (mid_clock + mid.length - 1) if mid_clock + mid.length > 1 else 0
        mid_index = min(max(mid_index, 0), right)
        while left <= right:
            mid = structs[mid_index]
            mid_clock = mid.id.clock
            if mid_clock <= clock:
                if clock < mid_clock + mid.length:
                    return mid_index
                left = mid_index + 1
            else:
                right = mid_index - 1
            mid_index = (left + right) // 2
        raise RuntimeError(f"struct for clock {clock} not found")

    def find(self, sid: ID) -> Struct:
        structs = self.clients[sid.client]
        return structs[self.find_index(structs, sid.clock)]

    get_item = find

    def find_index_clean_start(self, transaction: "Transaction", structs: list[Struct], clock: int) -> int:
        index = self.find_index(structs, clock)
        struct = structs[index]
        if struct.id.clock < clock and isinstance(struct, Item):
            structs.insert(index + 1, struct.split(transaction, clock - struct.id.clock))
            return index + 1
        return index

    def get_item_clean_start(self, transaction: "Transaction", sid: ID) -> Struct:
        structs = self.clients[sid.client]
        return structs[self.find_index_clean_start(transaction, structs, sid.clock)]

    def get_item_clean_end(self, transaction: "Transaction", sid: ID) -> Struct:
        structs = self.clients[sid.client]
        index = self.find_index(structs, sid.clock)
        struct = structs[index]
        if sid.clock != struct.id.clock + struct.length - 1 and not isinstance(struct, GC):
            structs.insert(index + 1, struct.split(transaction, sid.clock - struct.id.clock + 1))
        return structs[index]

    def replace_struct(self, old: Struct, new: Struct) -> None:
        structs = self.clients[old.id.client]
        structs[self.find_index(structs, old.id.clock)] = new

    def iterate_structs(self, transaction: "Transaction", client: int, clock_start: int, length: int, fn) -> None:
        if length <= 0:
            return
        clock_end = clock_start + length
        structs = self.clients.get(client)
        if not structs:
            return
        index = self.find_index_clean_start(transaction, structs, clock_start)
        while index < len(structs):
            struct = structs[index]
            if struct.id.clock >= clock_end:
                break
            if clock_end < struct.id.clock + struct.length and isinstance(struct, Item):
                structs.insert(index + 1, struct.split(transaction, clock_end - struct.id.clock))
            fn(struct)
            index += 1
