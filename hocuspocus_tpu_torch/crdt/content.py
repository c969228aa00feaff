"""Item content classes — Y.js-compatible (update format v1 content refs 1-9).

Mirrors the capability surface of yjs's Content* classes (the reference
delegates to yjs for these; see SURVEY.md §2.2). Content ref numbers and
binary layouts follow the Yjs v1 update encoding:

  0 GC (struct, not content)   5 ContentEmbed
  1 ContentDeleted             6 ContentFormat
  2 ContentJSON                7 ContentType
  3 ContentBinary              8 ContentAny
  4 ContentString              9 ContentDoc
  10 Skip (struct, not content)

String lengths are UTF-16 code-unit counts (JS semantics) — this governs
clock arithmetic and must match for wire compatibility.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from .encoding import Decoder, Encoder, json_parse, json_stringify

if TYPE_CHECKING:
    from .doc import Transaction


def utf16_len(s: str) -> int:
    """Length of `s` in UTF-16 code units (JS string .length semantics)."""
    if s.isascii():  # C-speed fast path; virtually all real text
        return len(s)
    return len(s) + sum(1 for ch in s if ch > "￿")


def utf16_index(s: str, offset: int, units: int = -1) -> tuple[int, bool]:
    """Map a UTF-16 offset to a Python str index.

    Returns (index, mid_surrogate): mid_surrogate is True when the offset
    falls inside a surrogate pair (an astral char split point).

    `units` is the string's UTF-16 length when the caller has it cached
    (ContentString._len16): no-astral detection then costs O(1) instead
    of a scan.
    """
    # C-speed fast paths first: the update writer calls this with
    # offset ~ len(s) for every merged-item append, and the O(offset)
    # ord() walk below dominated the whole client edit path (measured
    # ~440us/edit at 3k chars, ~90% in this function)
    if s.isascii() or (units if units >= 0 else utf16_len(s)) == len(s):
        return min(offset, len(s)), False  # no astral chars: unit == char
    cursor = 0
    for i, ch in enumerate(s):
        if cursor == offset:
            return i, False
        step = 2 if ord(ch) > 0xFFFF else 1
        if cursor + step > offset:
            return i, True
        cursor += step
    return len(s), False


class Content:
    """Base class; subclasses define ref/countable and the codec hooks."""

    ref: int = -1
    countable: bool = True

    def get_length(self) -> int:
        raise NotImplementedError

    def get_content(self) -> list[Any]:
        raise NotImplementedError

    def copy(self) -> "Content":
        raise NotImplementedError

    def splice(self, offset: int) -> "Content":
        raise NotImplementedError

    def merge_with(self, right: "Content") -> bool:
        return False

    def integrate(self, transaction: "Transaction", item: Any) -> None:
        pass

    def delete(self, transaction: "Transaction") -> None:
        pass

    def gc(self, store: Any) -> None:
        pass

    def write(self, encoder: Encoder, offset: int) -> None:
        raise NotImplementedError


class ContentDeleted(Content):
    ref = 1
    countable = False

    __slots__ = ("length",)

    def __init__(self, length: int) -> None:
        self.length = length

    def get_length(self) -> int:
        return self.length

    def get_content(self) -> list[Any]:
        return []

    def copy(self) -> "ContentDeleted":
        return ContentDeleted(self.length)

    def splice(self, offset: int) -> "ContentDeleted":
        right = ContentDeleted(self.length - offset)
        self.length = offset
        return right

    def merge_with(self, right: Content) -> bool:
        self.length += right.length  # type: ignore[attr-defined]
        return True

    def integrate(self, transaction: "Transaction", item: Any) -> None:
        transaction.delete_set.add(item.id.client, item.id.clock, self.length)
        item.deleted = True

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_var_uint(self.length - offset)


class ContentJSON(Content):
    ref = 2
    countable = True

    __slots__ = ("arr",)

    def __init__(self, arr: list[Any]) -> None:
        self.arr = arr

    def get_length(self) -> int:
        return len(self.arr)

    def get_content(self) -> list[Any]:
        return list(self.arr)

    def copy(self) -> "ContentJSON":
        return ContentJSON(list(self.arr))

    def splice(self, offset: int) -> "ContentJSON":
        right = ContentJSON(self.arr[offset:])
        self.arr = self.arr[:offset]
        return right

    def merge_with(self, right: Content) -> bool:
        self.arr = self.arr + right.arr  # type: ignore[attr-defined]
        return True

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_var_uint(len(self.arr) - offset)
        for value in self.arr[offset:]:
            encoder.write_var_string(json_stringify(value))


class ContentBinary(Content):
    ref = 3
    countable = True

    __slots__ = ("data",)

    def __init__(self, data: bytes) -> None:
        self.data = data

    def get_length(self) -> int:
        return 1

    def get_content(self) -> list[Any]:
        return [self.data]

    def copy(self) -> "ContentBinary":
        return ContentBinary(self.data)

    def splice(self, offset: int) -> Content:
        raise RuntimeError("ContentBinary cannot be spliced")

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_var_uint8_array(self.data)


class ContentString(Content):
    ref = 4
    countable = True

    __slots__ = ("s", "_len16")

    def __init__(self, s: str) -> None:
        self.s = s
        self._len16 = -1  # lazy UTF-16 length cache; -1 = unknown

    def get_length(self) -> int:
        # Item.length hits this on every integrate/position walk — the
        # UTF-16 unit count is cached until the string mutates (splice
        # and merge_with below are the only mutation sites)
        if self._len16 < 0:
            self._len16 = utf16_len(self.s)
        return self._len16

    def get_content(self) -> list[Any]:
        # one entry per UTF-16 code unit position is what yjs returns; we
        # return per-character entries, with astral chars as single entries
        # counting double — consumers use get_string() on YText instead.
        return list(self.s)

    def get_string(self) -> str:
        return self.s

    def copy(self) -> "ContentString":
        return ContentString(self.s)

    def splice(self, offset: int) -> "ContentString":
        idx, mid = utf16_index(self.s, offset, self._len16)
        if mid:
            # Splitting a surrogate pair: replace both halves with U+FFFD
            # (yjs ContentString.splice does the same).
            left = self.s[:idx] + "�"
            right_s = "�" + self.s[idx + 1 :]
        else:
            left = self.s[:idx]
            right_s = self.s[idx:]
        self.s = left
        self._len16 = -1
        return ContentString(right_s)

    def merge_with(self, right: Content) -> bool:
        if self._len16 >= 0 and getattr(right, "_len16", -1) >= 0:
            self._len16 += right._len16  # type: ignore[attr-defined]
        else:
            self._len16 = -1
        self.s = self.s + right.s  # type: ignore[attr-defined]
        return True

    def write(self, encoder: Encoder, offset: int) -> None:
        if offset == 0:
            encoder.write_var_string(self.s)
        else:
            idx, mid = utf16_index(self.s, offset, self._len16)
            s = ("�" + self.s[idx + 1 :]) if mid else self.s[idx:]
            encoder.write_var_string(s)


class ContentEmbed(Content):
    ref = 5
    countable = True

    __slots__ = ("embed",)

    def __init__(self, embed: Any) -> None:
        self.embed = embed

    def get_length(self) -> int:
        return 1

    def get_content(self) -> list[Any]:
        return [self.embed]

    def copy(self) -> "ContentEmbed":
        return ContentEmbed(self.embed)

    def splice(self, offset: int) -> Content:
        raise RuntimeError("ContentEmbed cannot be spliced")

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_var_string(json_stringify(self.embed))


class ContentFormat(Content):
    ref = 6
    countable = False

    __slots__ = ("key", "value")

    def __init__(self, key: str, value: Any) -> None:
        self.key = key
        self.value = value

    def get_length(self) -> int:
        return 1

    def get_content(self) -> list[Any]:
        return []

    def copy(self) -> "ContentFormat":
        return ContentFormat(self.key, self.value)

    def splice(self, offset: int) -> Content:
        raise RuntimeError("ContentFormat cannot be spliced")

    def integrate(self, transaction: "Transaction", item: Any) -> None:
        parent = item.parent
        if parent is not None:
            parent._has_formatting = True
            # search anchors are position caches for UNFORMATTED walks;
            # once formatting exists they are never consulted again —
            # unset the items' anchor flags and drop the list so edits
            # stop maintaining it (yjs ContentFormat.integrate nulls
            # _searchMarker the same way). Lazy import: content.py sits
            # below types/ in the module graph.
            from .types.base import clear_search_markers

            clear_search_markers(parent)
            parent._search_markers = None

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_var_string(self.key)
        encoder.write_var_string(json_stringify(self.value))


class ContentAny(Content):
    ref = 8
    countable = True

    __slots__ = ("arr",)

    def __init__(self, arr: list[Any]) -> None:
        self.arr = arr

    def get_length(self) -> int:
        return len(self.arr)

    def get_content(self) -> list[Any]:
        return list(self.arr)

    def copy(self) -> "ContentAny":
        return ContentAny(list(self.arr))

    def splice(self, offset: int) -> "ContentAny":
        right = ContentAny(self.arr[offset:])
        self.arr = self.arr[:offset]
        return right

    def merge_with(self, right: Content) -> bool:
        self.arr = self.arr + right.arr  # type: ignore[attr-defined]
        return True

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_var_uint(len(self.arr) - offset)
        for value in self.arr[offset:]:
            encoder.write_any(value)


class ContentType(Content):
    ref = 7
    countable = True

    __slots__ = ("type",)

    def __init__(self, ytype: Any) -> None:
        self.type = ytype

    def get_length(self) -> int:
        return 1

    def get_content(self) -> list[Any]:
        return [self.type]

    def copy(self) -> "ContentType":
        return ContentType(self.type._copy())

    def splice(self, offset: int) -> Content:
        raise RuntimeError("ContentType cannot be spliced")

    def integrate(self, transaction: "Transaction", item: Any) -> None:
        self.type._integrate(transaction.doc, item)

    def delete(self, transaction: "Transaction") -> None:
        item = self.type._start
        while item is not None:
            if not item.deleted:
                item.delete(transaction)
            else:
                transaction._merge_structs.append(item)
            item = item.right
        for map_item in self.type._map.values():
            if not map_item.deleted:
                map_item.delete(transaction)
            else:
                transaction._merge_structs.append(map_item)
        transaction.changed.pop(self.type, None)

    def gc(self, store: Any) -> None:
        item = self.type._start
        while item is not None:
            item.gc(store, True)
            item = item.right
        self.type._start = None
        for map_item in self.type._map.values():
            while map_item is not None:
                map_item.gc(store, True)
                map_item = map_item.left
        self.type._map = {}

    def write(self, encoder: Encoder, offset: int) -> None:
        self.type._write(encoder)


class ContentDoc(Content):
    ref = 9
    countable = True

    __slots__ = ("doc", "opts")

    def __init__(self, doc: Any) -> None:
        self.doc = doc
        opts: dict[str, Any] = {}
        if not doc.gc:
            opts["gc"] = False
        if doc.auto_load:
            opts["autoLoad"] = True
        if doc.meta is not None:
            opts["meta"] = doc.meta
        self.opts = opts

    def get_length(self) -> int:
        return 1

    def get_content(self) -> list[Any]:
        return [self.doc]

    def copy(self) -> "ContentDoc":
        return ContentDoc(create_doc_from_opts(self.doc.guid, self.opts))

    def splice(self, offset: int) -> Content:
        raise RuntimeError("ContentDoc cannot be spliced")

    def integrate(self, transaction: "Transaction", item: Any) -> None:
        self.doc._item = item
        transaction.subdocs_added.add(self.doc)
        if self.doc.should_load:
            transaction.subdocs_loaded.add(self.doc)

    def delete(self, transaction: "Transaction") -> None:
        if self.doc in transaction.subdocs_added:
            transaction.subdocs_added.discard(self.doc)
        else:
            transaction.subdocs_removed.add(self.doc)

    def write(self, encoder: Encoder, offset: int) -> None:
        encoder.write_var_string(self.doc.guid)
        encoder.write_any(self.opts)


def create_doc_from_opts(guid: str, opts: dict[str, Any]):
    from .doc import Doc

    return Doc(
        guid=guid,
        gc=opts.get("gc", True),
        auto_load=opts.get("autoLoad", False),
        meta=opts.get("meta"),
        should_load=opts.get("autoLoad", False),
    )


def read_item_content(decoder: Decoder, info: int) -> Content:
    ref = info & 0x1F
    if ref == 1:
        return ContentDeleted(decoder.read_var_uint())
    if ref == 2:
        length = decoder.read_var_uint()
        return ContentJSON([json_parse(decoder.read_var_string()) for _ in range(length)])
    if ref == 3:
        return ContentBinary(decoder.read_var_uint8_array())
    if ref == 4:
        return ContentString(decoder.read_var_string())
    if ref == 5:
        return ContentEmbed(json_parse(decoder.read_var_string()))
    if ref == 6:
        return ContentFormat(decoder.read_var_string(), json_parse(decoder.read_var_string()))
    if ref == 7:
        from .types.base import read_type_from_decoder

        return ContentType(read_type_from_decoder(decoder))
    if ref == 8:
        length = decoder.read_var_uint()
        return ContentAny([decoder.read_any() for _ in range(length)])
    if ref == 9:
        guid = decoder.read_var_string()
        opts = decoder.read_any()
        return ContentDoc(create_doc_from_opts(guid, opts if isinstance(opts, dict) else {}))
    raise ValueError(f"unknown content ref {ref}")
