"""Serve sync replies and broadcasts from merge-plane state, in PyTorch.

The counterpart of the JAX package's `tpu/serving.py`: for supported
documents, SyncStep2 payloads and steady-state update broadcasts are
PRODUCED from device state — arena ids and tombstones read back from the
device, combined with the host-side serve/unit logs — instead of from
the CPU document. Documents on the native text lane (`MergePlane.
enable_lane`) build their windows and stale/cold SyncStep2 structs in
C++ straight from the lane's log; the other documents encode their
string/GC windows through the native `encode_text_window` and anything
richer through the Python Items path. Every route emits the bytes the
pure-Python encoder would.

Safety model:
- The CPU document stays the fallback: every serve checks the plane is
  healthy (supported, no overflow, host/device logs in sync) AND covers
  the CPU document's state vector; otherwise the caller falls back.
- SYNC serves read delete sets for *sequence* content from the DEVICE
  tombstone mask; map-item deletions (host-only content) are merged in
  from the host tombstone log.
- BROADCASTS ship the window's own delete ranges from the serve log; any
  host/device divergence retires the doc via the health check before
  the next broadcast.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..crdt.content import ContentDeleted, ContentString
from ..crdt.delete_set import DeleteSet
from ..crdt.encoding import Encoder
from ..crdt.ids import ID
from ..crdt.structs import GC, Item
from ..crdt.update import _write_structs, decode_state_vector
from ..native import get_codec
from .kernels import KIND_DELETE, KIND_INSERT, NONE_CLIENT, catchup_pack, state_vector_diff
from .kernels_rle import catchup_pack_rle
from .lowering import units_to_text
from .merge_plane import LogRec, MergePlane, PlaneDoc

logger = logging.getLogger(__name__)


class SyncFrameCache:
    """Join-storm sync cache: (doc, state-vector) -> encoded SyncStep2
    payload, scoped to the serve-log/flush epoch.

    Entries key on the doc name + the CUTOFF MAP actually encoded and
    validate against (PlaneDoc identity, serve-log key, plane flush
    epoch): any integrated op, device flush or re-registration misses
    naturally. Bounded per doc (LRU)."""

    PER_DOC_CAP = 32

    def __init__(self) -> None:
        # name -> OrderedDict[sv_key -> (PlaneDoc, epoch_key, payload)]
        self._by_name: "dict[str, OrderedDict]" = {}
        self.evictions = 0

    def get(self, name: str, doc, epoch_key, sv_key) -> Optional[bytes]:
        entries = self._by_name.get(name)
        if entries is None:
            return None
        entry = entries.get(sv_key)
        if entry is None:
            return None
        if entry[0] is not doc or entry[1] != epoch_key:
            del entries[sv_key]  # stale epoch: drop eagerly
            return None
        entries.move_to_end(sv_key)
        return entry[2]

    def put(self, name: str, doc, epoch_key, sv_key, payload: bytes) -> None:
        entries = self._by_name.setdefault(name, OrderedDict())
        entries[sv_key] = (doc, epoch_key, payload)
        entries.move_to_end(sv_key)
        while len(entries) > self.PER_DOC_CAP:
            entries.popitem(last=False)
            self.evictions += 1

    def forget(self, name: str) -> None:
        """Drop a doc's entries outright (unload, degrade)."""
        entries = self._by_name.pop(name, None)
        if entries:
            self.evictions += len(entries)


def _wire_parent(parent: Optional[tuple]):
    """DenseOp parent tuple -> the Item.write representation."""
    if parent is None:
        return None
    if parent[0] == "root":
        return parent[1]
    return ID(parent[1], parent[2])


def _make_item(rec: LogRec, unit_logs: dict):
    op = rec.op
    if op.gc:
        # collected subtree: re-encode the clock range verbatim
        return GC(ID(op.client, op.clock), op.run_len)
    origin = ID(op.left_client, op.left_clock) if op.left_client != NONE_CLIENT else None
    right_origin = (
        ID(op.right_client, op.right_clock) if op.right_client != NONE_CLIENT else None
    )
    if op.content is not None:
        content = op.content
    elif op.deleted_content:
        content = ContentDeleted(op.run_len)
    else:
        log = unit_logs[rec.slot]
        content = ContentString(
            units_to_text(log[rec.unit_off : rec.unit_off + op.run_len])
        )
    return Item(
        ID(op.client, op.clock),
        None,
        origin,
        None,
        right_origin,
        _wire_parent(op.parent),  # consulted by Item.write only when origin-less
        op.parent_sub,
        content,
    )


def _cutoff_map(local_sv: dict, target_sv: dict) -> dict[int, int]:
    """Per-client cutoff of what the requester lacks: its own clock where
    the plane is ahead, 0 for clients it has never seen."""
    sm: dict[int, int] = {}
    for client, clock in target_sv.items():
        if local_sv.get(client, 0) > clock:
            sm[client] = clock
    for client in local_sv:
        if client not in target_sv:
            sm[client] = 0
    return sm


class PlaneServing:
    """Builds yjs update bytes from plane state for sync + broadcast."""

    def __init__(self, plane: MergePlane) -> None:
        self.plane = plane
        # doc name -> serve_log index whose records receivers already have
        self.broadcast_cursor: dict[str, int] = {}
        self._length_cache: Optional[np.ndarray] = None
        self._overflow_cache: Optional[np.ndarray] = None
        self._validated_cache: Optional[np.ndarray] = None
        self._gen_cache: Optional[np.ndarray] = None
        # slot -> ((slot_gen, flush_epoch), sorted merged deleted
        # (client, clock, length) ranges): see _slot_deleted_ranges
        self._tombstone_cache: dict[int, tuple] = {}
        self._sync_cache = SyncFrameCache()
        # catch-up batching: SyncStep1s arriving in the same event-loop
        # window are triaged by ONE state_vector_diff call
        self._catchup_queue: list[tuple] = []  # (name, document, sv_bytes, future)
        self._catchup_scheduled = False
        self._drain_tasks: set = set()
        # supervisor drain seam (tpu/supervisor.py): while paused (breaker
        # open) every sync request is answered by the CPU document, and
        # abort_pending resolves the waiters already in flight
        self.paused = False
        self._inflight: set = set()

    # -- device readback cache ---------------------------------------------

    def refresh(self) -> None:
        """Adopt the plane's last combined health readback; per-slot
        checks then stay host-side. Lengths, overflows and validated
        tallies are snapshotted together under the step lock so they
        describe ONE device state."""
        plane = self.plane
        with plane._step_lock:
            if plane.last_lengths is not None:
                self._length_cache = plane.last_lengths
                self._overflow_cache = plane.last_overflows
            else:
                self._length_cache = plane.state.length.cpu().numpy().astype(np.int64)
                self._overflow_cache = plane.state.overflow.cpu().numpy()
            self._validated_cache = plane.validated_units.copy()
            self._gen_cache = None if plane.last_gen is None else plane.last_gen.copy()

    def _lengths(self) -> np.ndarray:
        if self._length_cache is None:
            self.refresh()
        return self._length_cache

    def forget(self, name: str, doc: Optional[PlaneDoc]) -> None:
        """Drop every per-doc serving cache at unload/degrade time: the
        sync cache holds the PlaneDoc and its whole serve log, so a
        server churning through doc names would otherwise keep each."""
        self.broadcast_cursor.pop(name, None)
        self._sync_cache.forget(name)
        if doc is not None:
            for slot in doc.seqs.values():
                self._tombstone_cache.pop(slot, None)
            if doc.lane_slot is not None:
                # lane slots may predate root discovery (not yet in
                # seqs): a stale entry left here would survive into the
                # slot's next tenant's cache lookups
                self._tombstone_cache.pop(doc.lane_slot, None)

    # -- health -------------------------------------------------------------

    def doc_healthy(self, name: str) -> Optional[PlaneDoc]:
        plane = self.plane
        doc = plane.docs.get(name)
        if doc is None:
            return None
        if doc.lowerer.unsupported:
            return None
        if self._length_cache is None:
            # no completed flush adopted yet: nothing to validate against
            return doc
        if not plane.check_doc_health(
            name,
            doc,
            self._length_cache,
            self._overflow_cache,
            self._validated_cache,
            self._gen_cache,
        ):
            return None
        return doc

    def filter_healthy(self, names: "list[str]") -> "tuple[list[str], list[str]]":
        """(fast_ok, needs_check): one vectorized compare replaces the
        per-doc health loop for the common case (registered, supported,
        single-row doc whose cached device row matches its validated
        tally). A stale-generation row fast-OKs, as check_doc_health
        skips such slots too. needs_check gets the rest (unregistered,
        unsupported, a mismatching current row, multi-row trees, no
        snapshot yet) for doc_healthy, which also retires on failure."""
        plane = self.plane
        if self._length_cache is None or self._gen_cache is None:
            return [], list(names)
        candidates: list[str] = []
        slots: list[int] = []
        needs_check: list[str] = []
        for name in names:
            doc = plane.docs.get(name)
            if doc is None or doc.lowerer.unsupported:
                needs_check.append(name)
                continue
            doc_slots = list(doc.seqs.values())
            if len(doc_slots) > 1:
                needs_check.append(name)  # multi-row trees: full check
                continue
            candidates.append(name)
            slots.append(doc_slots[0] if doc_slots else -1)
        if not candidates:
            return [], needs_check
        arr = np.asarray(slots, np.int64)
        rowless = arr < 0
        safe = np.where(rowless, 0, arr)
        gen_current = self._gen_cache[safe] == plane.slot_gen[safe]
        mismatch = (self._validated_cache[safe] != self._length_cache[safe]) | self._overflow_cache[
            safe
        ]
        ok = rowless | ~gen_current | ~mismatch
        fast_ok = [name for name, good in zip(candidates, ok) if good]
        needs_check.extend(name for name, good in zip(candidates, ok) if not good)
        return fast_ok, needs_check

    def _local_sv(self, doc: PlaneDoc) -> dict:
        """The plane's integrated clocks for this doc (lane docs keep
        them natively; others in the Python lowerer)."""
        plane = self.plane
        if doc.lane_slot is not None:
            return plane._lane_codec.lane_known(plane._lane, doc.lane_slot)
        return dict(doc.lowerer.known)

    def covers(self, name: str, document) -> bool:
        """Plane has integrated everything the CPU document has seen."""
        plane = self.plane
        doc = plane.docs.get(name)
        if doc is None:
            return False
        sv = document.store.get_state_vector()
        if doc.lane_slot is not None:
            return bool(plane._lane_codec.lane_covers(plane._lane, doc.lane_slot, list(sv.items())))
        known = doc.lowerer.known
        for client, clock in sv.items():
            if clock > known.get(client, 0):
                return False
        return True

    # -- encoding -----------------------------------------------------------

    def _group_items(
        self,
        doc: PlaneDoc,
        records: list[LogRec],
        min_clock: Optional[dict[int, int]] = None,
    ) -> dict[int, list[Item]]:
        """Group serve-log records into per-client clock-sorted Items.

        min_clock trims fully-known items per client (the first included
        item may overlap the cutoff — _write_structs emits it with an
        offset); clients absent from min_clock are skipped."""
        by: dict[int, list[Item]] = {}
        unit_logs = self.plane.unit_logs
        for rec in records:
            op = rec.op
            if op.kind != KIND_INSERT:
                continue
            if min_clock is not None:
                cutoff = min_clock.get(op.client)
                if cutoff is None or op.clock + op.run_len <= cutoff:
                    continue
            by.setdefault(op.client, []).append(_make_item(rec, unit_logs))
        for items in by.values():
            items.sort(key=lambda item: item.id.clock)
        return by

    def _slot_deleted_ranges(self, slot: int) -> "list[tuple[int, int, int]]":
        """Sorted, merged (client, clock, length) ranges of the slot's
        device tombstones, cached per (slot generation, flush epoch)."""
        plane = self.plane
        key = (int(plane.slot_gen[slot]), plane.flush_epoch)
        cached = self._tombstone_cache.get(slot)
        if cached is not None and cached[0] == key:
            return cached[1]
        self._fetch_slot_rows([slot], plane.flush_epoch)
        return self._tombstone_cache[slot][1]

    def prefetch_tombstones(self, docs: "list[PlaneDoc]") -> None:
        """Fill the tombstone cache for every slot of `docs` in as few
        fused device reads as the gather widths allow."""
        plane = self.plane
        epoch = plane.flush_epoch
        slots = sorted(
            {
                slot
                for doc in docs
                for slot in doc.seqs.values()
                if (
                    (cached := self._tombstone_cache.get(slot)) is None
                    or cached[0] != (int(plane.slot_gen[slot]), epoch)
                )
            }
        )
        if not slots:
            return
        for chunk in self._gather_chunks(slots):
            self._fetch_slot_rows(chunk, epoch)

    def _gather_widths(self) -> "list[int]":
        """Fixed width ladder, capped at the plane size (pow2)."""
        cap = 1
        while cap < min(self.plane.num_docs, 256):
            cap *= 2
        widths = [w for w in (16, 64) if w < cap]
        widths.append(cap)
        return widths

    def _gather_chunks(self, slots: "list[int]") -> "list[list[int]]":
        biggest = self._gather_widths()[-1]
        return [slots[pos : pos + biggest] for pos in range(0, len(slots), biggest)]

    def _gather_rows(self, slot_indices: "list[int]") -> np.ndarray:
        """One fused device read of the tombstone-relevant rows. Unit
        arena: (3, B, N) [deleted, id_client, id_clock]. RLE arena:
        (4, B, R) [deleted, run_client, run_clock, run_len]: ranges come
        straight from deleted entries. Caller holds the step lock."""
        state = self.plane.state
        idx = torch.as_tensor(slot_indices, dtype=torch.long, device=self.plane.device)
        if self.plane.arena == "rle":
            planes = [
                state.run_deleted[idx].to(torch.int32),
                state.run_client[idx],
                state.run_clock[idx],
                state.run_len[idx],
            ]
        else:
            planes = [state.deleted[idx].to(torch.int32), state.id_client[idx], state.id_clock[idx]]
        return torch.stack(planes).cpu().numpy()

    @staticmethod
    def _merge_ranges(
        raw: "list[tuple[int, int, int]]",
    ) -> "list[tuple[int, int, int]]":
        """Merge sorted id-adjacent (client, clock, length) ranges."""
        ranges: list[tuple[int, int, int]] = []
        for c, k, l in raw:
            if ranges and ranges[-1][0] == c and ranges[-1][1] + ranges[-1][2] == k:
                ranges[-1] = (c, ranges[-1][1], ranges[-1][2] + l)
            else:
                ranges.append((c, k, l))
        return ranges

    def _pack_width(self) -> int:
        """Tombstone-pack width: one static value per plane (the arena's
        row width, capped at 128)."""
        return min(128, int(self.plane.state[0].shape[1]))

    def _fetch_slot_rows(self, chunk: "list[int]", epoch: int) -> None:
        """Fill the tombstone cache for a slot chunk: the packed device
        read first, a full-row read for any slot whose tombstone count
        overflowed the pack width."""
        overflow = self._fetch_slot_rows_device(chunk, epoch)
        if overflow:
            self._fetch_slot_rows_host(overflow, epoch)

    def _fetch_slot_rows_device(self, chunk: "list[int]", epoch: int) -> "list[int]":
        """Packed tombstone fetch through catchup_pack: O(tombstones) on
        the wire instead of O(arena width). Returns the slots whose
        tombstone count exceeded the pack width. Tombstones arrive in
        arena order; the host sorts and merges exactly as the full-row
        path does, so the emitted DeleteSet bytes are identical."""
        plane = self.plane
        width = next(w for w in self._gather_widths() if w >= len(chunk))
        pack_w = self._pack_width()
        padded = chunk + [chunk[0]] * (width - len(chunk))
        rle = plane.arena == "rle"
        pack = catchup_pack_rle if rle else catchup_pack
        with plane._step_lock:
            slots_dev = torch.as_tensor(padded, dtype=torch.int32, device=plane.device)
            fused = pack(plane.state, slots_dev, pack_w).cpu().numpy().view(np.uint32)
            gens = [int(plane.slot_gen[slot]) for slot in chunk]
        counts = fused[:width]
        body = fused[width:].reshape(3 if rle else 2, width, pack_w)
        overflow: list[int] = []
        for i, slot in enumerate(chunk):
            count = int(counts[i])
            if count > pack_w:
                overflow.append(slot)
                continue
            clients = body[0, i, :count]
            clocks = body[1, i, :count].astype(np.int64)
            if rle:
                lens = body[2, i, :count].astype(np.int64)
                raw = sorted(zip(clients.tolist(), clocks.tolist(), lens.tolist()))
            else:
                raw = [
                    (c, k, 1) for c, k in sorted(zip(clients.tolist(), clocks.tolist()))
                ]
            self._tombstone_cache[slot] = ((gens[i], epoch), self._merge_ranges(raw))
        plane.counters["sync_encode_device"] += len(chunk) - len(overflow)
        return overflow

    def _fetch_slot_rows_host(self, chunk: "list[int]", epoch: int) -> None:
        plane = self.plane
        width = next(w for w in self._gather_widths() if w >= len(chunk))
        with plane._step_lock:
            fused = self._gather_rows(chunk + [chunk[0]] * (width - len(chunk)))
            gens = [int(plane.slot_gen[slot]) for slot in chunk]
        rle = plane.arena == "rle"
        for i, slot in enumerate(chunk):
            sel = np.nonzero(fused[0, i])[0]
            clients = fused[1, i][sel].view(np.uint32)
            clocks = fused[2, i][sel]
            if rle:
                lens = fused[3, i][sel]
                raw = sorted(
                    (c, k, l)
                    for c, k, l in zip(clients.tolist(), clocks.tolist(), lens.tolist())
                    if l > 0
                )
            else:
                raw = [(c, k, 1) for c, k in sorted(zip(clients.tolist(), clocks.tolist()))]
            self._tombstone_cache[slot] = ((gens[i], epoch), self._merge_ranges(raw))
        plane.counters["sync_encode_host"] += len(chunk)

    def warmup_gathers(self, width: int) -> None:
        """Launch the tombstone gather and the catch-up pack once at one
        gather width, so the first reconnect storm pays transfers only.
        The extension's listen-time warm task calls it once per width of
        _gather_widths(), taking the flush lock for each."""
        plane = self.plane
        pack = catchup_pack_rle if plane.arena == "rle" else catchup_pack
        with plane._step_lock, plane.device_scope():
            self._gather_rows([0] * width)
            slots = torch.zeros(width, dtype=torch.int32, device=plane.device)
            pack(plane.state, slots, self._pack_width()).cpu()

    def _device_delete_set(self, doc: PlaneDoc) -> DeleteSet:
        """Tombstones as the DEVICE sees them, across every row of the
        doc, plus host-applied map-item tombstones."""
        lengths = self._lengths()
        ds = DeleteSet()
        for slot in doc.seqs.values():
            if int(lengths[slot]) == 0:
                continue
            for client, clock, length in self._slot_deleted_ranges(slot):
                ds.add(client, clock, length)
        for client, clock, length in doc.map_tombstones:
            ds.add(client, clock, length)
        ds.sort_and_merge()
        return ds

    def _encode_window_native(
        self,
        doc: PlaneDoc,
        records: list[LogRec],
        min_clock: Optional[dict[int, int]],
    ) -> Optional[bytes]:
        """Struct-section bytes via the native `encode_text_window`, or
        None = use the Python path.

        The semantic work of `_group_items` + `crdt/update._write_structs`
        — cutoff trimming (the record filter below), group ordering,
        the first-item offset with its origin rewrite and payload slice
        — happens HERE; the C++ side is pure byte emission. Only the
        shapes the plane serves hot qualify (string runs, deleted runs,
        GC ranges, root parents); any rich content (formats, embeds,
        maps, ID parents) returns None and the caller re-encodes via
        Items."""
        unit_logs = self.plane.unit_logs
        by: dict[int, list[LogRec]] = {}
        for rec in records:
            op = rec.op
            if op.kind != KIND_INSERT:
                continue
            if min_clock is not None:
                cutoff = min_clock.get(op.client)
                if cutoff is None or op.clock + op.run_len <= cutoff:
                    continue
            if op.content is not None or op.parent_sub is not None:
                return None
            if op.parent is not None and op.parent[0] != "root":
                return None
            by.setdefault(op.client, []).append(rec)
        groups = []
        for client in sorted(by, reverse=True):
            recs = sorted(by[client], key=lambda r: r.op.clock)
            cutoff = 0 if min_clock is None else min_clock[client]
            # the filter above kept only records overlapping the cutoff,
            # so recs[0] is the group's first emitted struct
            write_clock = max(cutoff, recs[0].op.clock)
            items = []
            for j, rec in enumerate(recs):
                op = rec.op
                offset = max(write_clock - op.clock, 0) if j == 0 else 0
                if op.gc:
                    items.append((1, -1, 0, -1, 0, None, op.run_len - offset))
                    continue
                oc = -1 if op.left_client == NONE_CLIENT else op.left_client
                ok = op.left_clock
                rc = -1 if op.right_client == NONE_CLIENT else op.right_client
                rk = op.right_clock
                if offset > 0:
                    # emitting a tail of the run: its origin is the unit
                    # just before the cut (Item.write offset semantics)
                    oc, ok = client, write_clock - 1
                parent_name = None
                if oc < 0 and rc < 0:
                    if op.parent is None:
                        return None
                    parent_name = op.parent[1]
                if op.deleted_content:
                    items.append((2, oc, ok, rc, rk, parent_name, op.run_len - offset))
                    continue
                log = unit_logs[rec.slot]
                payload = units_to_text(log[rec.unit_off + offset : rec.unit_off + op.run_len])
                items.append((0, oc, ok, rc, rk, parent_name, payload))
            groups.append((client, write_clock, items))
        return get_codec().encode_text_window(groups)

    def _widen_surrogate_cutoffs(self, records: list[LogRec], sm: dict[int, int]) -> None:
        """A stale-sync cutoff landing mid-surrogate-pair would slice a
        text run so its first transmitted unit is a lone low surrogate;
        widen such cutoffs by one unit (the re-sent high surrogate is
        already known to the client and integration skips it). The
        pair's two units may live in different records, so the unit AT
        the cutoff and the unit BEFORE it resolve independently."""
        unit_logs = self.plane.unit_logs
        at_unit: dict[int, int] = {}
        prev_unit: dict[int, int] = {}
        for rec in records:
            op = rec.op
            if op.kind != KIND_INSERT or op.gc or op.deleted_content:
                continue
            if op.content is not None or op.parent_sub is not None or rec.slot is None:
                continue
            cutoff = sm.get(op.client)
            if cutoff is None or cutoff <= 0:
                continue
            log = unit_logs.get(rec.slot)
            if log is None:
                continue
            if op.clock <= cutoff < op.clock + op.run_len:
                pos = rec.unit_off + (cutoff - op.clock)
                if pos < len(log) and isinstance(log[pos], int):
                    at_unit[op.client] = log[pos]
            if op.clock <= cutoff - 1 < op.clock + op.run_len:
                pos = rec.unit_off + (cutoff - 1 - op.clock)
                if pos < len(log) and isinstance(log[pos], int):
                    prev_unit[op.client] = log[pos]
        for client, unit in at_unit.items():
            prev = prev_unit.get(client)
            if 0xDC00 <= unit <= 0xDFFF and prev is not None and 0xD800 <= prev <= 0xDBFF:
                sm[client] = sm[client] - 1

    def _encode_from_sm(self, doc: PlaneDoc, sm: dict[int, int]) -> bytes:
        """SyncStep2 bytes for a doc given the per-client cutoff map,
        through the join-storm sync cache (the payload is a pure function
        of serve log + cutoff map within one flush epoch)."""
        plane = self.plane
        lane = doc.lane_slot is not None
        if lane:
            # native path: cutoff trimming, offset origin-rewrite and
            # surrogate widening all happen in C — no materialization,
            # so a reconnect storm never exports the log
            log_key = plane._lane_codec.lane_log_len(plane._lane, doc.lane_slot)
            epoch_key = (log_key, plane.flush_epoch)
        else:
            if any(clock > 0 for clock in sm.values()):
                self._widen_surrogate_cutoffs(doc.serve_log, sm)
            epoch_key = (len(doc.serve_log), len(doc.map_tombstones), plane.flush_epoch)
        sv_key = tuple(sorted(sm.items()))
        cached = self._sync_cache.get(doc.name, doc, epoch_key, sv_key)
        if cached is not None:
            plane.counters["sync_cache_hits"] += 1
            plane.counters["sync_serves"] += 1
            return cached
        plane.counters["sync_cache_misses"] += 1
        encoder = Encoder()
        if lane:
            encoder.write_bytes(
                plane._lane_codec.lane_window_sm(plane._lane, doc.lane_slot, list(sm.items()))
            )
        else:
            body = self._encode_window_native(doc, doc.serve_log, sm)
            if body is not None:
                encoder.write_bytes(body)
            else:
                items_by_client = self._group_items(doc, doc.serve_log, sm)
                encoder.write_var_uint(len(items_by_client))
                for client in sorted(items_by_client, reverse=True):
                    _write_structs(encoder, items_by_client[client], client, sm[client])
        self._device_delete_set(doc).write(encoder)
        plane.counters["sync_serves"] += 1
        payload = encoder.to_bytes()
        before = self._sync_cache.evictions
        self._sync_cache.put(doc.name, doc, epoch_key, sv_key, payload)
        plane.counters["sync_cache_evictions"] += self._sync_cache.evictions - before
        return payload

    def encode_state_as_update(
        self, name: str, document, sv_bytes: Optional[bytes] = None
    ) -> Optional[bytes]:
        """SyncStep2 payload from device state; None = CPU fallback (the
        doc is unhealthy or behind the CPU document, or the client's
        state vector does not decode). An error of the device step
        itself propagates.

        Holds the plane's step lock across its own flush AND the state
        reads, so a concurrent flush can neither interleave between the
        drain and the encode nor change the rows mid-read."""
        if self.paused:
            return None  # supervisor drain: serve from the CPU document
        plane = self.plane
        with plane._step_lock:  # reentrant: flush() re-acquires
            if plane.pending_ops() > 0:
                plane.flush()
                self.refresh()
            doc = self.doc_healthy(name)
            if doc is None or not self.covers(name, document):
                return None
            try:
                target_sv = decode_state_vector(sv_bytes) if sv_bytes else {}
            except (ValueError, IndexError):
                return None
            return self._encode_from_sm(doc, _cutoff_map(self._local_sv(doc), target_sv))

    # -- batched catch-up (the storm path) -----------------------------------

    async def batched_sync(self, name: str, document, sv_bytes: Optional[bytes]):
        """Enqueue a SyncStep1 for batch serving: every request that lands
        in the same event-loop window shares ONE state_vector_diff call.
        Resolves to SyncStep2 bytes, or None = CPU fallback."""
        import asyncio

        if self.paused:
            return None  # supervisor drain: serve from the CPU document
        future = asyncio.get_event_loop().create_future()
        self._inflight.add(future)
        future.add_done_callback(self._inflight.discard)
        self._catchup_queue.append((name, document, sv_bytes, future))
        if not self._catchup_scheduled:
            self._catchup_scheduled = True
            task = asyncio.ensure_future(self._drain_catchup())
            self._drain_tasks.add(task)
            task.add_done_callback(self._drain_tasks.discard)
        return await future

    def abort_pending(self) -> None:
        """Resolve every outstanding batched-sync waiter to CPU fallback.

        The supervisor's breaker-open drain: a wedge mid-flight leaves
        drain tasks blocked on the flush lock with their waiters' futures
        unresolved, and clients would wait on SyncStep2 forever. The
        drain's own `future.done() or ...` guards make its eventual
        (post-unwedge) resolution a no-op."""
        for future in list(self._inflight):
            if not future.done():
                future.set_result(None)

    async def _drain_catchup(self) -> None:
        plane = self.plane
        # device-lane admission (tpu/scheduler.py): the drain flushes and
        # runs the triage — interactive class, a joiner is blocked on the
        # reply. A parked lane (breaker open) resolves the batch to CPU
        # fallback, as abort_pending does. The batch is taken once the
        # lane admits: a request that lands while the drain waits joins
        # it instead of queuing a drain (and a lane waiter) of its own,
        # which the JAX package does (ROADMAP Queue C)
        ticket = None
        if plane.lane is not None and self._catchup_queue:
            from .scheduler import CLASS_INTERACTIVE, LaneDeferred

            try:
                ticket = await plane.lane.admit(CLASS_INTERACTIVE, site="sync")
            except LaneDeferred:
                self._catchup_scheduled = False
                batch, self._catchup_queue = self._catchup_queue, []
                for *_rest, future in batch:
                    future.done() or future.set_result(None)
                return
        self._catchup_scheduled = False
        batch, self._catchup_queue = self._catchup_queue, []
        if not batch:
            if ticket is not None:
                ticket.release()
            return
        try:
            # the whole drain — flush, refresh, triage, encode — holds the
            # flush lock: every step reads device state
            async with plane.flush_lock:
                try:
                    await self._drain_catchup_locked(batch)
                except Exception as error:
                    # a failed device step or encode reaches every waiting
                    # caller; nothing is served from the CPU in its place
                    for *_rest, future in batch:
                        future.done() or future.set_exception(error)
        finally:
            if ticket is not None:
                ticket.release()

    async def _drain_catchup_locked(self, batch: list) -> None:
        import asyncio

        plane = self.plane
        if plane.pending_ops() > 0:
            # the device step runs off the event loop
            await asyncio.get_event_loop().run_in_executor(None, plane.flush)
            self.refresh()
        rows: list[tuple] = []  # (doc, local_sv, target_sv, columns, future)
        width = 1
        for name, document, sv_bytes, future in batch:
            doc = self.doc_healthy(name)
            if doc is None or not self.covers(name, document):
                future.done() or future.set_result(None)
                continue
            local_sv = self._local_sv(doc)
            try:
                target_sv = decode_state_vector(sv_bytes) if sv_bytes else {}
            except (ValueError, IndexError):
                future.done() or future.set_result(None)
                continue
            columns = sorted(set(local_sv) | set(target_sv))
            width = max(width, len(columns))
            rows.append((doc, local_sv, target_sv, columns, future))
        if not rows:
            return
        batch_docs = [row[0] for row in rows]
        await asyncio.get_event_loop().run_in_executor(
            None, lambda: self.prefetch_tombstones(batch_docs)
        )
        if len(rows) == 1:
            # lone reconnect: the host dict diff costs microseconds
            doc, local_sv, target_sv, _, future = rows[0]
            self._resolve(future, doc, _cutoff_map(local_sv, target_sv))
            return
        # pad to a power-of-two (B, C) so storm-size jitter keeps the
        # triage shapes few
        b = 1
        while b < len(rows):
            b *= 2
        c = 1
        while c < width:
            c *= 2
        server = np.zeros((b, c), np.int32)
        client = np.zeros((b, c), np.int32)
        for i, (_doc, local_sv, target_sv, columns, _) in enumerate(rows):
            for j, cid in enumerate(columns):
                server[i, j] = local_sv.get(cid, 0)
                client[i, j] = target_sv.get(cid, 0)
        missing_from, missing_len = state_vector_diff(
            torch.from_numpy(server).to(plane.device),
            torch.from_numpy(client).to(plane.device),
        )
        plane._note_dispatch("sync")
        missing_from = missing_from.cpu().numpy()
        missing_len = missing_len.cpu().numpy()
        for i, (doc, _local, _target, columns, future) in enumerate(rows):
            sm = {
                cid: int(missing_from[i, j])
                for j, cid in enumerate(columns)
                if missing_len[i, j] > 0
            }
            self._resolve(future, doc, sm)

    def _resolve(self, future, doc: PlaneDoc, sm: dict[int, int]) -> None:
        """Answer one batched request from the device state."""
        if not future.done():
            future.set_result(self._encode_from_sm(doc, sm))

    def build_broadcast(self, name: str) -> Optional[bytes]:
        """Merged update for ops integrated since the last broadcast.

        Items come from the doc's serve log since the cursor, minus
        presync records; the delete set carries exactly the WINDOW's
        delete ranges. The cursor only advances on a successfully encoded
        payload (or a genuinely empty window)."""
        pair = self.build_broadcast_pair(name)
        return None if pair is None else pair[0]

    def _encode_window(self, doc: PlaneDoc, window: list[LogRec]) -> Optional[bytes]:
        """Update bytes for a record window, or None for an empty one."""
        window_ds = DeleteSet()
        has_inserts = False
        for rec in window:
            if rec.op.kind == KIND_DELETE:
                window_ds.add(rec.op.client, rec.op.clock, rec.op.run_len)
            elif rec.op.kind == KIND_INSERT:
                has_inserts = True
        if not has_inserts and not window_ds.clients:
            return None
        encoder = Encoder()
        body = self._encode_window_native(doc, window, None)
        if body is not None:
            encoder.write_bytes(body)
        else:
            by = self._group_items(doc, window)
            encoder.write_var_uint(len(by))
            for client in sorted(by, reverse=True):
                items = by[client]
                _write_structs(encoder, items, client, items[0].id.clock)
        window_ds.sort_and_merge()
        window_ds.write(encoder)
        return encoder.to_bytes()

    def build_broadcast_pairs(
        self, names: "list[str]"
    ) -> "tuple[list[tuple[str, Optional[tuple[bytes, Optional[bytes]]]]], list[str]]":
        """Batched window drain -> (pairs, failed_names).

        Lane docs resolve in ONE native call (a missing slot yields a
        None entry, not an exception); Python-path docs go through
        build_broadcast_pair each, with per-doc isolation: one doc's
        encode failure lands it in failed_names instead of aborting the
        other docs' windows."""
        plane = self.plane
        out: list = []
        failed: list[str] = []
        lane_names: list = []
        lane_args: list = []
        for name in names:
            doc = plane.docs.get(name)
            if doc is not None and doc.lane_slot is not None:
                lane_names.append(name)
                lane_args.append((doc.lane_slot, self.broadcast_cursor.get(name, 0)))
                continue
            try:
                out.append((name, self.build_broadcast_pair(name)))
            except Exception:
                logger.exception("broadcast encode failed for %r", name)
                failed.append(name)
        if lane_args:
            results = plane._lane_codec.lane_windows_batch(plane._lane, lane_args)
            for name, (full, cross, new_idx) in zip(lane_names, results):
                self.broadcast_cursor[name] = new_idx
                if full is None:
                    out.append((name, None))
                else:
                    plane.counters["plane_broadcasts"] += 1
                    out.append((name, (full, cross)))
        return out, failed

    def build_broadcast_pair(self, name: str) -> "Optional[tuple[bytes, Optional[bytes]]]":
        """(full_window_update, cross_instance_update or None).

        The cross-instance frame excludes REMOTE-origin records; it is
        None when the window holds no local ops, and the same bytes as
        the full frame when the window is all-local."""
        plane = self.plane
        doc = plane.docs.get(name)
        if doc is None:
            return None
        if doc.lane_slot is not None:
            # native path: one C call builds both frames' update bytes
            full, cross, new_idx, _ = plane._lane_codec.lane_window(
                plane._lane, doc.lane_slot, self.broadcast_cursor.get(name, 0)
            )
            self.broadcast_cursor[name] = new_idx
            if full is None:
                return None
            plane.counters["plane_broadcasts"] += 1
            return full, cross
        log = doc.serve_log
        cursor = min(self.broadcast_cursor.get(name, 0), len(log))
        window = [rec for rec in log[cursor:] if not rec.op.presync]
        if not window:
            self.broadcast_cursor[name] = len(log)
            return None
        full = self._encode_window(doc, window)
        if full is None:
            self.broadcast_cursor[name] = len(log)
            return None
        local_window = [rec for rec in window if not rec.remote]
        if len(local_window) == len(window):
            local = full
        elif not local_window:
            local = None
        else:
            local = self._encode_window(doc, local_window)
        self.broadcast_cursor[name] = len(log)
        plane.counters["plane_broadcasts"] += 1
        return full, local


class TpuSyncSource:
    """`document.sync_source` adapter: SyncStep2 bytes from the plane.

    None hands the client to the CPU document (the doc is unhealthy or
    behind it, or its state vector does not decode) and counts one
    `cpu_fallbacks`. An error of the serve itself (a failed kernel build
    or launch, a failed encode) goes to `on_fault`, called inside the
    handler: without one it propagates. TpuMergeExtension passes its
    `_device_fault`, which re-raises on the card and, on a CPU plane,
    degrades the served docs; the CPU document then answers (counted).
    When the batched variant finds the plane behind, it awaits
    `settle(name, document, registration)` (the doc's plane registration
    when the request came): True means the doc left the native lane
    meanwhile and its rebuild has landed, so the request is asked of the
    plane once more."""

    def __init__(
        self, serving: PlaneServing, name: str, document, on_fault=None, settle=None
    ) -> None:
        self.serving = serving
        self.name = name
        self.document = document
        self.on_fault = on_fault
        self.settle = settle

    def _counted(self, payload: Optional[bytes]) -> Optional[bytes]:
        if payload is None:
            self.serving.plane.counters["cpu_fallbacks"] += 1
        return payload

    def _fault(self) -> None:
        if self.on_fault is None:
            raise
        self.on_fault()

    def encode_state_as_update(self, sv_bytes: Optional[bytes]) -> Optional[bytes]:
        try:
            payload = self.serving.encode_state_as_update(self.name, self.document, sv_bytes)
        except Exception:
            self._fault()
            payload = None
        return self._counted(payload)

    async def encode_state_as_update_async(self, sv_bytes: Optional[bytes]) -> Optional[bytes]:
        """Batched (storm) variant: concurrent SyncStep1s share one
        state-vector-diff triage — see PlaneServing.batched_sync."""
        try:
            registration = self.serving.plane.docs.get(self.name)
            payload = await self.serving.batched_sync(self.name, self.document, sv_bytes)
            if (
                payload is None
                and self.settle is not None
                and await self.settle(self.name, self.document, registration)
            ):
                payload = await self.serving.batched_sync(self.name, self.document, sv_bytes)
        except Exception:
            self._fault()
            payload = None
        return self._counted(payload)
