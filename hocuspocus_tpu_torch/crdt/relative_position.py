"""Relative positions — cursor anchors that survive concurrent edits.

Y.js-compatible (lib0 byte format, yjs `RelativePosition` semantics —
vendored bundle fns eE/eA/ex/eI/eT/eM/eO): a relative position pins a
spot in a sequence to the ID of the character it sits on (`assoc >= 0`)
or after (`assoc < 0`), or to the type itself for the start/end.
Editor bindings and the provider awareness cursor layer resolve them
back to indices after any amount of concurrent editing; undo/redo is
followed through redone pointers.

Reference counterpart: the reference playground's collaboration-cursor
traffic carries these via y-protocols; `tests/crdt/
test_relative_position.py` pins byte-compat against the documented
lib0 layout.
"""

from __future__ import annotations

from typing import Any, Optional

from .encoding import Decoder, Encoder
from .ids import ID, compare_ids
from .structs import Item, StructStore, find_root_type_key


class RelativePosition:
    __slots__ = ("type", "tname", "item", "assoc")

    def __init__(
        self,
        type_id: Optional[ID],
        tname: Optional[str],
        item: Optional[ID],
        assoc: int = 0,
    ) -> None:
        self.type = type_id
        self.tname = tname
        self.item = item
        self.assoc = assoc

    def to_json(self) -> dict:
        out: dict = {}
        if self.type is not None:
            out["type"] = {"client": self.type.client, "clock": self.type.clock}
        if self.tname is not None:
            out["tname"] = self.tname
        if self.item is not None:
            out["item"] = {"client": self.item.client, "clock": self.item.clock}
        out["assoc"] = self.assoc
        return out

    @staticmethod
    def from_json(data: dict) -> "RelativePosition":
        def _id(v) -> Optional[ID]:
            return None if v is None else ID(v["client"], v["clock"])

        return RelativePosition(
            _id(data.get("type")),
            data.get("tname"),
            _id(data.get("item")),
            data.get("assoc", 0),
        )


class AbsolutePosition:
    __slots__ = ("type", "index", "assoc")

    def __init__(self, ytype: Any, index: int, assoc: int = 0) -> None:
        self.type = ytype
        self.index = index
        self.assoc = assoc


def _relative_position(ytype: Any, item: Optional[ID], assoc: int) -> RelativePosition:
    if ytype._item is None:
        return RelativePosition(None, find_root_type_key(ytype), item, assoc)
    return RelativePosition(
        ID(ytype._item.id.client, ytype._item.id.clock), None, item, assoc
    )


def create_relative_position_from_type_index(
    ytype: Any, index: int, assoc: int = 0
) -> RelativePosition:
    """Anchor visible position `index`. assoc >= 0 pins to the unit AT
    the index (stays left of content inserted there); assoc < 0 pins to
    the unit BEFORE it (follows content inserted at the index)."""
    item = ytype._start
    if assoc < 0:
        if index == 0:
            return _relative_position(ytype, None, assoc)
        index -= 1
    while item is not None:
        if not item.deleted and item.countable:
            if item.length > index:
                return _relative_position(
                    ytype, ID(item.id.client, item.id.clock + index), assoc
                )
            index -= item.length
        if item.right is None and assoc < 0:
            return _relative_position(ytype, item.last_id, assoc)
        item = item.right
    return _relative_position(ytype, None, assoc)


def _follow_redone(store: StructStore, sid: ID) -> "tuple[Optional[Any], int]":
    next_id: Optional[ID] = sid
    diff = 0
    item = None
    while True:
        if diff > 0:
            next_id = ID(next_id.client, next_id.clock + diff)
        try:
            item = store.find(next_id)
        except (KeyError, IndexError, RuntimeError):
            # unknown client (KeyError) or in-range client with a clock
            # no struct covers (find_index raises RuntimeError)
            return None, 0
        if item is None:
            return None, 0
        diff = next_id.clock - item.id.clock
        next_id = item.redone if isinstance(item, Item) else None
        if next_id is None or not isinstance(item, Item):
            return item, diff


def create_absolute_position_from_relative_position(
    rpos: RelativePosition, doc: Any
) -> Optional[AbsolutePosition]:
    """Resolve back to (type, index), or None when the anchor's ID is
    unknown to this doc (peer ahead of us) or its type was deleted."""
    store = doc.store
    if rpos.item is not None:
        if store.get_state(rpos.item.client) <= rpos.item.clock:
            return None  # anchor from a future we haven't seen
        right, diff = _follow_redone(store, rpos.item)
        if not isinstance(right, Item):
            return None
        ytype = right.parent
        index = 0
        if ytype._item is None or not ytype._item.deleted:
            if not right.deleted and right.countable:
                index = diff + (1 if rpos.assoc < 0 else 0)
            node = right.left
            while node is not None:
                if not node.deleted and node.countable:
                    index += node.length
                node = node.left
        return AbsolutePosition(ytype, index, rpos.assoc)
    if rpos.tname is not None:
        ytype = doc.get(rpos.tname)
    elif rpos.type is not None:
        if store.get_state(rpos.type.client) <= rpos.type.clock:
            return None
        item, _diff = _follow_redone(store, rpos.type)
        from .content import ContentType

        if not isinstance(item, Item) or not isinstance(item.content, ContentType):
            return None  # the nested type (or its subtree) is gone
        ytype = item.content.type
    else:
        raise ValueError("relative position carries no anchor")
    index = ytype._length if rpos.assoc >= 0 else 0
    return AbsolutePosition(ytype, index, rpos.assoc)


def write_relative_position(encoder: Encoder, rpos: RelativePosition) -> None:
    if rpos.item is not None:
        encoder.write_var_uint(0)
        encoder.write_var_uint(rpos.item.client)
        encoder.write_var_uint(rpos.item.clock)
    elif rpos.tname is not None:
        encoder.write_var_uint(1)
        encoder.write_var_string(rpos.tname)
    elif rpos.type is not None:
        encoder.write_var_uint(2)
        encoder.write_var_uint(rpos.type.client)
        encoder.write_var_uint(rpos.type.clock)
    else:
        raise ValueError("relative position carries no anchor")
    encoder.write_var_int(rpos.assoc)


def encode_relative_position(rpos: RelativePosition) -> bytes:
    encoder = Encoder()
    write_relative_position(encoder, rpos)
    return encoder.to_bytes()


def read_relative_position(decoder: Decoder) -> RelativePosition:
    type_id = tname = item = None
    tag = decoder.read_var_uint()
    if tag == 0:
        item = ID(decoder.read_var_uint(), decoder.read_var_uint())
    elif tag == 1:
        tname = decoder.read_var_string()
    elif tag == 2:
        type_id = ID(decoder.read_var_uint(), decoder.read_var_uint())
    else:
        raise ValueError(f"unknown relative-position tag {tag}")
    # assoc appended by yjs >= 13.5; older encodings end here
    assoc = decoder.read_var_int() if decoder.has_content() else 0
    return RelativePosition(type_id, tname, item, assoc)


def decode_relative_position(data: bytes) -> RelativePosition:
    return read_relative_position(Decoder(data))


def compare_relative_positions(
    a: Optional[RelativePosition], b: Optional[RelativePosition]
) -> bool:
    return a is b or (
        a is not None
        and b is not None
        and a.tname == b.tname
        and compare_ids(a.item, b.item)
        and compare_ids(a.type, b.type)
        and a.assoc == b.assoc
    )
