"""Host-side lowering: Yjs binary updates → dense device ops.

Decodes update structs and routes every item to the YATA *sequence* it
belongs to. The device arena is sequence-granular: one arena row per
sequence (a root type's child list, or an element item's child list),
so tree-shaped documents (ProseMirror XML, nested types) batch onto the
same kernel as plain text — the reference serves every Y type through
one hot loop (reference `packages/server/src/MessageReceiver.ts`
readUpdate), and so does the plane.

Content handling:
- ContentString / ContentDeleted: unit payloads (UTF-16 code units /
  zeros) ride the host unit log; the device sees only ids/origins.
- ContentFormat / ContentEmbed / ContentType / ContentAny / ContentJSON
  / ContentBinary: each clock tick is one arena unit; the decoded
  Content object stays host-side and is re-written byte-faithfully at
  serve time. Formats are zero-width for text extraction, exactly as in
  Yjs (countable=False).
- Map items (parent_sub set, e.g. Y.Map entries and XML attributes) are
  host-only: last-writer-wins needs no device ordering, so they go
  straight to the doc's serve log. Successor map writes arrive with an
  origin pointing at the previous entry and are routed by id.

GC structs (collected subtrees) are host-side clock ranges re-encoded
verbatim at serve time; items anchored into a collected range become GC
themselves, mirroring the CPU engine. Documents containing Skip structs
or subdocs are flagged unsupported — the CPU path stays authoritative
for them.

Decoding uses the port's native C++ codec (hocuspocus_tpu_torch.native)
as the fast screen: updates made only of origin-carrying string/delete
runs (the steady-state typing stream) lower straight from its output;
anything structural re-decodes through the pure-Python CRDT decoder,
which yields full Items (parent, parent_sub, rich content).
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Any, Optional

from ..crdt.content import (
    ContentAny,
    ContentBinary,
    ContentDeleted,
    ContentDoc,
    ContentEmbed,
    ContentFormat,
    ContentJSON,
    ContentString,
    ContentType,
)
from ..crdt.delete_set import DeleteSet
from ..crdt.encoding import Decoder
import numpy as np

from ..crdt.ids import ID
from ..crdt.structs import GC, Item, Skip
from ..crdt.update import _read_client_struct_refs
from ..native import get_codec
from .kernels import KIND_DELETE, KIND_INSERT, NONE_CLIENT

# struct kinds produced by decoding (0-4 match the native codec)
STRUCT_STRING = 0
STRUCT_DELETED = 1
STRUCT_GC = 2
STRUCT_SKIP = 3
STRUCT_OTHER = 4  # native "other" / ContentDoc — needs python / unsupported
STRUCT_FORMAT = 5
STRUCT_EMBED = 6
STRUCT_TYPE = 7
STRUCT_ANY = 8  # ContentAny / ContentJSON: one value per clock tick
STRUCT_BINARY = 9

# sequence keys: ("root", name) for a root type's child list,
# ("item", client, clock) for the child list of the element item with
# that id. Map routes are ("map", parent_key, sub).


@dataclass
class DenseOp:
    kind: int
    client: int
    clock: int
    run_len: int
    left_client: int = NONE_CLIENT
    left_clock: int = 0
    right_client: int = NONE_CLIENT
    right_clock: int = 0
    chars: tuple = ()
    # insert lowered from a ContentDeleted struct: the arena stores the
    # units (as zeros) but serving re-encodes the struct as ContentDeleted
    deleted_content: bool = False
    # GC struct (collected subtree): host-only clock range with no
    # content/origins, re-encoded verbatim at serve time
    gc: bool = False
    # decoded Content object for non-string payloads (format/embed/type/
    # any/binary and every map value) — re-written verbatim at serve time
    content: Any = None
    # explicit wire parent for origin-less items: ("root", name) |
    # ("item", client, clock). Items with origins don't need it.
    parent: Optional[tuple] = None
    parent_sub: Optional[str] = None
    # snapshot ops: receivers get pre-load state via sync, not broadcast
    presync: bool = False


@dataclass
class LoweredStruct:
    """Decoder-neutral struct record (native tuples or Python Items)."""

    client: int
    clock: int
    kind: int
    length: int
    payload: Any  # str | int | Content (kind-dependent)
    origin: Optional[tuple]  # (client, clock)
    right_origin: Optional[tuple]
    parent: Optional[tuple] = None  # ("root", name) | ("item", c, k)
    parent_sub: Optional[str] = None


def _classify_content(content) -> tuple[int, int, Any]:
    """(kind, length, payload) for a decoded Content object."""
    if isinstance(content, ContentString):
        return STRUCT_STRING, content.get_length(), content.s
    if isinstance(content, ContentDeleted):
        return STRUCT_DELETED, content.length, content.length
    if isinstance(content, ContentFormat):
        return STRUCT_FORMAT, 1, content
    if isinstance(content, ContentEmbed):
        return STRUCT_EMBED, 1, content
    if isinstance(content, ContentType):
        return STRUCT_TYPE, 1, content
    if isinstance(content, (ContentAny, ContentJSON)):
        return STRUCT_ANY, content.get_length(), content
    if isinstance(content, ContentBinary):
        return STRUCT_BINARY, 1, content
    # ContentDoc (subdocs) and anything unknown: host-only
    return STRUCT_OTHER, content.get_length(), None


def _python_decode(update: bytes) -> tuple[list[LoweredStruct], list[tuple]]:
    decoder = Decoder(update)
    refs = _read_client_struct_refs(decoder)
    ds = DeleteSet.read(decoder)
    structs = []
    for entry in refs.values():
        for struct in entry["refs"]:
            if isinstance(struct, Skip):
                structs.append(
                    LoweredStruct(
                        struct.id.client, struct.id.clock, STRUCT_SKIP,
                        struct.length, None, None, None,
                    )
                )
                continue
            if isinstance(struct, GC):
                structs.append(
                    LoweredStruct(
                        struct.id.client, struct.id.clock, STRUCT_GC,
                        struct.length, None, None, None,
                    )
                )
                continue
            assert isinstance(struct, Item)
            kind, length, payload = _classify_content(struct.content)
            parent = None
            if isinstance(struct.parent, str):
                parent = ("root", struct.parent)
            elif isinstance(struct.parent, ID):
                parent = ("item", struct.parent.client, struct.parent.clock)
            structs.append(
                LoweredStruct(
                    client=struct.id.client,
                    clock=struct.id.clock,
                    kind=kind,
                    length=length,
                    payload=payload,
                    origin=tuple(struct.origin) if struct.origin is not None else None,
                    right_origin=(
                        tuple(struct.right_origin)
                        if struct.right_origin is not None
                        else None
                    ),
                    parent=parent,
                    parent_sub=struct.parent_sub,
                )
            )
    return structs, list(ds.iterate())


def _decode_update(update: bytes) -> tuple[list[LoweredStruct], list[tuple]]:
    raw_structs, deletes = get_codec().decode_update(update)
    structs = []
    for client, clock, kind, oc, ok, rc, rk, payload in raw_structs:
        origin = None if oc == NONE_CLIENT else (oc, ok)
        right_origin = None if rc == NONE_CLIENT else (rc, rk)
        if kind == STRUCT_OTHER or (
            kind in (STRUCT_STRING, STRUCT_DELETED)
            and origin is None
            and right_origin is None
        ):
            # rich content, or an origin-less item whose wire parent the
            # native screen skipped — the python decoder recovers both
            return _python_decode(update)
        if kind == STRUCT_STRING:
            text = payload
            length = _utf16_len(payload)
        else:
            text = payload  # int length for DELETED/GC/SKIP
            length = payload
        structs.append(
            LoweredStruct(
                client=client,
                clock=clock,
                kind=kind,
                length=length,
                payload=text,
                origin=origin,
                right_origin=right_origin,
            )
        )
    return structs, [tuple(d) for d in deletes]


@dataclass
class DocLowerer:
    """Per-document lowering state: known clocks, id routing, pending ops.

    lower_update() returns (seq_ops, map_ops, map_tombstones):
    - seq_ops: {seq_key: [DenseOp]} destined for device arena rows
    - map_ops: [DenseOp] host-only map items (already integrated here)
    - map_tombstones: [(client, clock, len)] delete ranges that target
      map items (host-applied; merged into served delete sets)
    """

    known: dict[int, int] = field(default_factory=dict)  # client -> next clock
    pending: list = field(default_factory=list)  # LoweredStructs waiting on deps
    pending_deletes: list = field(default_factory=list)  # (client, clock, len)
    unsupported: bool = False
    # id routing: client -> parallel sorted lists of run starts and
    # (start, end, route) runs, where route is ("seq", seq_key) or
    # ("map", parent_key, sub)
    _id_starts: dict[int, list[int]] = field(default_factory=dict)
    _id_runs: dict[int, list[tuple]] = field(default_factory=dict)

    def _record_route(self, client: int, start: int, length: int, route: tuple) -> None:
        starts = self._id_starts.setdefault(client, [])
        runs = self._id_runs.setdefault(client, [])
        # emits per client are clock-ordered, so append keeps it sorted
        starts.append(start)
        runs.append((start, start + length, route))

    def _run_of_id(self, client: int, clock: int) -> Optional[tuple]:
        """(start, end, route) of the emitted run containing this id."""
        starts = self._id_starts.get(client)
        if not starts:
            return None
        i = bisect_right(starts, clock) - 1
        if i < 0:
            return None
        run = self._id_runs[client][i]
        if run[0] <= clock < run[1]:
            return run
        return None

    def _route_of_id(self, client: int, clock: int) -> Optional[tuple]:
        run = self._run_of_id(client, clock)
        return run[2] if run is not None else None

    def _id_known(self, ref: Optional[tuple]) -> bool:
        if ref is None:
            return True
        return ref[1] < self.known.get(ref[0], 0)

    def _struct_ready(self, struct: LoweredStruct) -> bool:
        if struct.clock > self.known.get(struct.client, 0):
            return False  # gap from same client
        if struct.parent is not None and struct.parent[0] == "item":
            if not self._id_known((struct.parent[1], struct.parent[2])):
                return False  # parent element not integrated yet
        return self._id_known(struct.origin) and self._id_known(struct.right_origin)

    # -- emission ------------------------------------------------------------

    def _collected_by_gc(self, struct: LoweredStruct) -> bool:
        """True when EITHER origin or the explicit parent id resolves
        into a collected range — the CPU engine integrates such items
        as GC structs (`parent = None` when a resolved left/right is GC
        or the parent item is GC, crdt/structs.py)."""
        for ref in (struct.origin, struct.right_origin):
            if ref is not None and self._route_of_id(ref[0], ref[1]) == ("gc",):
                return True
        if struct.parent is not None and struct.parent[0] == "item":
            if self._route_of_id(struct.parent[1], struct.parent[2]) == ("gc",):
                return True
        return False

    def _resolve_route(self, struct: LoweredStruct) -> Optional[tuple]:
        """("seq", seq_key) | ("map", parent_key, sub) | None=undecidable."""
        if struct.parent_sub is not None:
            if struct.parent is None:
                return None
            parent_key = (
                ("root", struct.parent[1])
                if struct.parent[0] == "root"
                else ("item", struct.parent[1], struct.parent[2])
            )
            return ("map", parent_key, struct.parent_sub)
        if struct.parent is not None:
            key = (
                ("root", struct.parent[1])
                if struct.parent[0] == "root"
                else ("item", struct.parent[1], struct.parent[2])
            )
            return ("seq", key)
        ref = struct.origin if struct.origin is not None else struct.right_origin
        if ref is None:
            return None
        return self._route_of_id(ref[0], ref[1])

    def _emit_struct(self, struct: LoweredStruct, seq_out: dict, map_out: list) -> None:
        client, clock = struct.client, struct.clock
        known = self.known.get(client, 0)
        if clock + struct.length <= known:
            return  # full duplicate
        if struct.kind == STRUCT_GC or self._collected_by_gc(struct):
            # A pure clock range with no content/origins: a GC struct
            # from the wire, OR an item whose origin / explicit parent
            # resolves into a collected range — the CPU engine converts
            # such items to GC structs at integrate time (yjs
            # Item.getMissing semantics, crdt/structs.py), and the
            # lowerer mirrors that so reconnecting offline editors
            # can't retire the doc from the plane. Recorded host-side
            # and re-encoded verbatim at serve time (GC.write).
            offset = max(known - clock, 0)
            map_out.append(
                DenseOp(
                    kind=KIND_INSERT,
                    client=client,
                    clock=clock + offset,
                    run_len=struct.length - offset,
                    gc=True,
                )
            )
            self._record_route(client, clock + offset, struct.length - offset, ("gc",))
            self.known[client] = clock + struct.length
            return
        route = self._resolve_route(struct)
        if route is None:
            # origin belongs to content we never integrated (shouldn't
            # happen for causally-ready structs) — degrade the doc
            self.unsupported = True
            return
        offset = max(known - clock, 0)
        if offset > 0 and struct.kind not in (STRUCT_STRING, STRUCT_DELETED):
            # partial overlap inside a rich-content run: only ANY runs
            # can span, and re-slicing them is not worth the rarity
            if struct.kind == STRUCT_ANY:
                values = struct.payload.get_content()[offset:]
                struct = LoweredStruct(
                    client, clock + offset, STRUCT_ANY, len(values),
                    ContentAny(values), (client, clock + offset - 1), struct.right_origin,
                )
                offset = 0
                clock = struct.clock
            else:
                self.unsupported = True
                return
        if route[0] == "map":
            self._emit_map(struct, route, offset, map_out)
            return
        if route[0] != "seq":  # unexpected route kind: degrade, not crash
            self.unsupported = True
            return
        self._emit_seq(struct, route[1], offset, seq_out)

    def _emit_map(
        self, struct: LoweredStruct, route: tuple, offset: int, map_out: list
    ) -> None:
        client, clock = struct.client, struct.clock
        _, parent_key, sub = route
        content = self._content_for(struct)
        if content is None:
            self.unsupported = True
            return
        left = struct.origin if struct.origin is not None else (NONE_CLIENT, 0)
        right = struct.right_origin if struct.right_origin is not None else (NONE_CLIENT, 0)
        if offset > 0:
            # trim the already-integrated prefix so id-route runs and
            # serve-log items never overlap (same invariant as _emit_seq)
            if struct.kind == STRUCT_STRING:
                units = _utf16_units(struct.payload or "")
                content = ContentString(units_to_text(units[offset:]))
            elif struct.kind == STRUCT_DELETED:
                content = ContentDeleted(struct.length - offset)
            left = (client, clock + offset - 1)
            clock += offset
        run = struct.length - offset
        map_out.append(
            DenseOp(
                kind=KIND_INSERT,
                client=client,
                clock=clock,
                run_len=run,
                left_client=left[0],
                left_clock=left[1],
                right_client=right[0],
                right_clock=right[1],
                content=content,
                deleted_content=struct.kind == STRUCT_DELETED,
                parent=parent_key,
                parent_sub=sub,
            )
        )
        self._record_route(client, clock, run, route)
        self.known[client] = clock + run

    def _content_for(self, struct: LoweredStruct):
        """Content object to re-encode at serve time (maps + rich units)."""
        if struct.kind == STRUCT_STRING:
            return ContentString(struct.payload)
        if struct.kind == STRUCT_DELETED:
            return ContentDeleted(struct.length)
        if struct.kind in (STRUCT_FORMAT, STRUCT_EMBED, STRUCT_TYPE, STRUCT_ANY, STRUCT_BINARY):
            return struct.payload
        return None

    def _emit_seq(self, struct: LoweredStruct, seq_key: tuple, offset: int, seq_out: dict) -> None:
        client, clock = struct.client, struct.clock
        if struct.kind == STRUCT_STRING:
            units = _utf16_units(struct.payload or "")
            chars = tuple(units[offset:])
            content = None
        elif struct.kind == STRUCT_DELETED:
            chars = (0,) * (struct.length - offset)
            content = None
        else:
            # rich unit(s): payload rides the host log; units are markers
            content = struct.payload
            chars = (content,) * struct.length
        left_client, left_clock = (
            struct.origin if struct.origin is not None else (NONE_CLIENT, 0)
        )
        if offset > 0:
            # Yjs routinely re-encodes merged items, so a struct may
            # overlap what we already integrated: emit only the unseen
            # tail, whose left origin is the last known unit (mirrors
            # yjs Item splice-on-offset during readSyncStep2)
            left_client, left_clock = client, clock + offset - 1
        right_client, right_clock = (
            struct.right_origin if struct.right_origin is not None else (NONE_CLIENT, 0)
        )
        run = struct.length - offset
        ops = seq_out.setdefault(seq_key, [])
        ops.append(
            DenseOp(
                kind=KIND_INSERT,
                client=client,
                clock=clock + offset,
                run_len=run,
                left_client=left_client,
                left_clock=left_clock,
                right_client=right_client,
                right_clock=right_clock,
                chars=chars,
                deleted_content=struct.kind == STRUCT_DELETED,
                content=content,
                parent=struct.parent,
            )
        )
        if struct.kind == STRUCT_DELETED:
            # idempotent id-range tombstone over the full struct range
            ops.append(
                DenseOp(kind=KIND_DELETE, client=client, clock=clock, run_len=struct.length)
            )
        self._record_route(client, clock + offset, run, ("seq", seq_key))
        self.known[client] = clock + struct.length

    # -- public --------------------------------------------------------------

    def lower_update(self, update: bytes) -> tuple[dict, list, list]:
        """Decode one update; emit everything causally ready.

        Returns (seq_ops, map_ops, map_tombstones) — see class docstring.
        """
        try:
            structs, deletes = _decode_update(update)
        except Exception:
            self.unsupported = True
            return {}, [], []
        for struct in structs:
            if struct.kind in (STRUCT_SKIP, STRUCT_OTHER):
                # Skips (partial-update placeholders) and subdocs are
                # host-only; GC structs ARE supported — they carry no
                # origins and re-encode verbatim (see _emit_struct).
                self.unsupported = True
            else:
                self.pending.append(struct)
        self.pending_deletes.extend(deletes)
        if self.unsupported:
            return {}, [], []
        return self._drain()

    def _drain(self) -> tuple[dict, list, list]:
        seq_out: dict[tuple, list[DenseOp]] = {}
        map_out: list[DenseOp] = []
        progress = True
        while progress:
            progress = False
            remaining = []
            for struct in self.pending:
                if self._struct_ready(struct):
                    self._emit_struct(struct, seq_out, map_out)
                    progress = True
                else:
                    remaining.append(struct)
            self.pending = remaining
            if self.unsupported:
                return {}, [], []
        # deletes apply to whatever prefix of the range is known NOW —
        # mirroring the CPU path (_read_and_apply_delete_set), which
        # tombstones the known sub-range immediately and keeps only the
        # rest pending. Deferring the whole range would let a sync serve
        # in the gap omit deletions the CPU document already applied.
        map_tombs: list[tuple] = []
        remaining_deletes = []
        for client, clock, length in self.pending_deletes:
            known = self.known.get(client, 0)
            upto = min(known, clock + length)
            if upto > clock:
                self._route_delete(client, clock, upto - clock, seq_out, map_tombs)
            if upto < clock + length:
                remaining_deletes.append(
                    (client, max(clock, upto), clock + length - max(clock, upto))
                )
        self.pending_deletes = remaining_deletes
        return seq_out, map_out, map_tombs

    def _route_delete(
        self, client: int, clock: int, length: int, seq_out: dict, map_tombs: list
    ) -> None:
        """Split an id range across the sequences/maps it covers."""
        end = clock + length
        while clock < end:
            run = self._run_of_id(client, clock)
            if run is None:
                # range covers ids we never integrated (pre-trimmed
                # overlap or decoder mismatch): the device can't prove
                # them; degrade rather than silently dropping a delete
                self.unsupported = True
                return
            _, run_end, route = run
            upto = min(end, run_end)
            if route[0] == "map":
                map_tombs.append((client, clock, upto - clock))
            elif route[0] == "gc":
                pass  # already collected: tombstones are meaningless
            else:
                seq_out.setdefault(route[1], []).append(
                    DenseOp(kind=KIND_DELETE, client=client, clock=clock, run_len=upto - clock)
                )
            clock = upto


def _utf16_units(s: str) -> list[int]:
    data = s.encode("utf-16-le", errors="replace")
    return np.frombuffer(data, np.dtype("<u2")).tolist()


def units_to_text(units) -> str:
    # vectorized: serve-path item encodes call this once per run (up to
    # thousands of units); the per-unit to_bytes/join version was the
    # top cost of a warm catch-up serve. Explicit little-endian dtype:
    # the bytes feed/come from utf-16-le regardless of host endianness.
    return (
        np.asarray(units, np.dtype("<u2")).tobytes().decode("utf-16-le", errors="replace")
    )


def _utf16_len(s: str) -> int:
    n = len(s)
    for ch in s:
        if ord(ch) > 0xFFFF:
            n += 1
    return n
