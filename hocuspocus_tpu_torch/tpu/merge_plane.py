"""The merge plane on one device: cross-document update queue + batched
integrate, in PyTorch.

The counterpart of the JAX package's `tpu/merge_plane.py` on a single
device, over either arena: the unit arena (one slot per UTF-16 unit,
`kernels.py`) or the run-length arena (one entry per run, `kernels_rle.py`).
Updates from ALL documents are lowered to dense ops, queued per arena
row, and each flush cycle dispatches them in (K slots, B rows) batches:
chained tail appends go to the run-append fast path, concurrent edits to
the integrate step, which on the card is a hand-written Hopper kernel
(`integrate.py`: K1 for the unit arena, K2 for the run-length arena).

Arena rows are *sequences*, not documents: a plain text doc occupies one
row; a tree doc occupies one row per element child-list. Map items are
host-side last-writer-wins records that never ride the device — they go
straight to the doc's serve log.

With `enable_lane`, a plain-text document registered by `register_lane`
keeps its whole host path in the port's C++ text lane
(`hocuspocus_tpu_torch/native/text_lane.cpp`): decode, lowering, serve
log and queue live there, and each flush pops the lane's ops in one
columnar `lane_drain` into the same fast/slow split and device batch as
the Python queues. The first update with rich content demotes the doc
to the Python path (`docs_retired_lane_demote`).

Uploads go from pinned host staging (on the card) with non-blocking
copies on the current stream; the cycle's single completion barrier is
the health readback in _sync_health.

`TpuMergeExtension` puts a server's live documents on the plane: it
captures their updates at `Document._handle_update`, flushes on a
governed cadence through the device lane, answers SyncStep1 from device
state and broadcasts one merged frame per coalescing window.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..aio import spawn_tracked
from ..observability.flight_recorder import get_flight_recorder
from ..observability.tracing import UpdateTraceBook, get_tracer
from ..server.types import Extension, Payload
from .integrate import (
    append_run_slots_rle_sparse_fast,
    append_run_slots_sparse_fast,
    integrate_op_slots_fast,
    integrate_op_slots_rle_fast,
    integrate_op_slots_rle_sparse_fast,
    integrate_op_slots_sparse_fast,
)
from .kernels import (
    KIND_DELETE,
    KIND_INSERT,
    NONE_CLIENT,
    NONE_CLIENT_I32,
    OpBatch,
    extract_live_mask,
    make_empty_state,
    tail_probe,
)
from .kernels_rle import make_empty_rle_state, tail_probe_rle
from .lowering import DenseOp, DocLowerer, units_to_text


@dataclass
class LogRec:
    """One serve-log record: an op the plane integrated (device or host).

    slot is None for host-only map items; unit_off indexes the slot's
    unit log where the op's payload starts (sequence inserts only).
    """

    op: DenseOp
    slot: Optional[int] = None
    unit_off: int = 0
    # op arrived from a peer instance: excluded from the cross-instance
    # window republish (every peer already received it)
    remote: bool = False


@dataclass
class PlaneDoc:
    """Per-document host state: sequence registry + serve log."""

    name: str
    lowerer: DocLowerer = field(default_factory=DocLowerer)
    seqs: dict[tuple, int] = field(default_factory=dict)  # seq_key -> slot
    serve_log: list[LogRec] = field(default_factory=list)
    # delete ranges that target host-side map items (client, clock, len)
    map_tombstones: list[tuple] = field(default_factory=list)
    retired: bool = False
    retire_reason: Optional[str] = None  # first reason wins (see retire_doc)
    # native text lane (see native/text_lane.cpp): when set, the whole
    # host path — lowering, serve log, unit log, dispatch queue — lives
    # in C++; serve_log/unit_logs here are lazy materializations for
    # the cold serving paths, cached under lane_cache_key
    lane_slot: Optional[int] = None
    lane_cache_key: Optional[tuple] = None


class _Staging:
    """One reusable host staging buffer for a batch's op fields plus its
    (B,) routing vector, laid out flat so a (k, b) batch is ONE
    contiguous region and uploads in ONE copy: fields (nfields, k, b)
    int32 followed by b slot entries. Pinned when the plane is on the
    card, so the copy is a true asynchronous DMA. MergePlane keeps two
    per path and alternates per batch (double buffering); the event
    recorded after each upload is waited on before the buffer's next
    reset, so a later batch never overwrites bytes still in flight."""

    __slots__ = ("buffer", "array", "k_max", "defaults")

    def __init__(self, k_max: int, num_docs: int, defaults: tuple, pin: bool) -> None:
        size = len(defaults) * k_max * num_docs + num_docs
        self.buffer = torch.empty(size, dtype=torch.int32, pin_memory=pin)
        self.array = self.buffer.numpy()
        self.k_max = k_max
        self.defaults = defaults

    def views(self, k: int, b: int, reset: tuple) -> tuple:
        """(k, b) numpy views of the fields; fields whose index is in
        `reset` are set to their default value."""
        fields = self.array[: len(self.defaults) * k * b].reshape(len(self.defaults), k, b)
        for i in reset:
            fields[i] = self.defaults[i]
        return tuple(fields)

    def slot_view(self, k: int, b: int) -> np.ndarray:
        start = len(self.defaults) * k * b
        return self.array[start : start + b]

    def upload(self, k: int, b: int, device, with_slots: bool = True) -> tuple:
        """Copy the (k, b) region to `device`: (fields (nfields, k, b),
        slots (b,) or None) as device tensors."""
        count = len(self.defaults) * k * b
        end = count + (b if with_slots else 0)
        region = self.buffer[:end].to(device, non_blocking=True, copy=True)
        fields = region[:count].view(len(self.defaults), k, b)
        return fields, (region[count:] if with_slots else None)

    @staticmethod
    def nbytes(fields: int, k: int, b: int, with_slots: bool) -> int:
        return fields * k * b * 4 + (b * 4 if with_slots else 0)


# per-field reset value of an op batch: left/right client columns
# default to the NONE_CLIENT sentinel, everything else to zero (noop)
_OP_DEFAULTS = (0, 0, 0, 0, NONE_CLIENT_I32, 0, NONE_CLIENT_I32, 0)
# the append fast path ships three run fields (client, clock, run_len);
# only run_len resets per batch (run_len == 0 IS the noop sentinel)
_RUN_DEFAULTS = (0, 0, 0)


class WarmWatch:
    """First launch vs repeat launch per (site, shape) of the plane's
    device steps.

    The counterpart of the JAX package's compile tracker. A step's first
    launch at a shape pays what a warm launch does not: the kernel
    library's build or load, and the C entry's shared-memory setup when
    the size grows. The listen-time warm grid launches every shape a
    flush can take and then calls `mark_warmed`; a first launch after
    that is a shape the grid missed, counted in `unwarmed_launches`."""

    def __init__(self) -> None:
        self._seen: set = set()
        self.warmed = False
        self.first_launches = 0
        self.repeat_launches = 0
        self.unwarmed_launches = 0

    def mark_warmed(self) -> None:
        self.warmed = True

    def mark_covered(self, site: str, shape) -> None:
        """Another plane of this geometry already launched the shape in
        this process (the shared warm registry, tpu/scheduler.py)."""
        self._seen.add((site, tuple(shape)))

    def observe(self, site: str, shape, warmup: bool = False) -> None:
        key = (site, tuple(shape))
        if key in self._seen:
            self.repeat_launches += 1
            return
        self._seen.add(key)
        self.first_launches += 1
        if self.warmed and not warmup:
            self.unwarmed_launches += 1


class MergePlane:
    """Device-resident arenas for up to `num_docs` sequences on one device.

    `arena` is "unit" (one arena slot per UTF-16 unit; capacity = units)
    or "rle" (one entry per run of consecutively-typed units; capacity =
    ENTRIES). The run-length arena's cost grows with ops and
    fragmentation, not with cumulative units, so a churning document
    stays on the plane where the unit arena would retire it.

    `device` defaults to the card: construction raises when CUDA is not
    available, unless the caller asks for the CPU (`device="cpu"`), in
    which case the plain PyTorch versions of every step run instead.
    """

    def __init__(
        self,
        num_docs: int = 256,
        capacity: int = 4096,
        max_slots_per_flush: int = 16,
        device="cuda",
        arena: str = "unit",
    ) -> None:
        if arena not in ("unit", "rle"):
            raise ValueError(f"unknown arena {arena!r}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MergePlane needs a CUDA device; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        if device.type == "cuda" and device.index is None:
            # pinned to an index, so a worker thread can make it current
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.arena = arena
        self.num_docs = num_docs
        self.capacity = capacity
        self.max_slots_per_flush = max_slots_per_flush
        # serializes flush + device readbacks when flushes run off the
        # event loop (direct synchronous use never contends)
        self.flush_lock = asyncio.Lock()
        # thread-level companion: flush() holds this for the duration of
        # the device step; synchronous readers acquire it. Reentrant so a
        # sync serve can hold it across its own flush()+reads sequence.
        self._step_lock = threading.RLock()
        self.state = self._make_empty(num_docs, capacity)
        self.docs: dict[str, PlaneDoc] = {}
        self.free: list[int] = list(range(num_docs - 1, -1, -1))
        self.slot_owner: dict[int, str] = {}  # slot -> doc name
        self.queues: dict[int, list[DenseOp]] = {}
        # slots with (possibly) queued ops: per-batch bookkeeping walks
        # THIS set, O(busy), never the full queue registry. enqueue adds
        # AFTER every extend, so a drain-side discard racing an enqueue
        # is always repaired by the enqueuer's own add. Native-lane
        # queues are not tracked here: the lane keeps its own registry
        # of nonempty queues in C++.
        self._busy_slots: set[int] = set()
        # per-slot insert units handed to the device so far / as of the
        # last completed flush: health checks compare device lengths
        # against the VALIDATED snapshot, never the (ahead) host logs
        self.dispatched_units = np.zeros(num_docs, np.int64)
        self.validated_units = np.zeros(num_docs, np.int64)
        # minimal-work run merge: a drained column takes the append fast
        # path only when every op chains off the column's host-tracked
        # RANK TAIL (client == NONE_CLIENT means "empty row"); unknown
        # tails re-arm through the tail probe at the next health readback
        self.run_merge_enabled = True
        self._tail_client = np.full(num_docs, NONE_CLIENT, np.uint32)
        self._tail_clock = np.zeros(num_docs, np.int64)
        self._tail_known = np.ones(num_docs, bool)
        self._tail_dirty: set[int] = set()
        # slots bound to a live (non-retired) doc
        self.slot_live = np.zeros(num_docs, bool)
        # per-slot binding generation, bumped at every alloc/release/
        # retire: a health snapshot only judges slots whose generation
        # still matches
        self.slot_gen = np.zeros(num_docs, np.int64)
        self.last_gen: Optional[np.ndarray] = None
        # bumped whenever device state may have changed
        self.flush_epoch = 0
        # docs with new serve-log records since the last broadcast pass
        self.dirty: set[str] = set()
        # last combined health readback (see _sync_health)
        self.last_lengths: Optional[np.ndarray] = None
        self.last_overflows: Optional[np.ndarray] = None
        # unit payloads never touch the device: arena slot = arrival
        # index, so payloads land here, indexed by slot (an int UTF-16
        # unit for text, or the decoded Content object for rich units)
        self.unit_logs: dict[int, list] = {}
        self.projected_len: dict[int, int] = {}
        self.counters: dict[str, int] = {
            "docs_retired_overflow": 0,
            "docs_retired_desync": 0,
            "docs_retired_unsupported": 0,
            "docs_retired_capacity": 0,
            "docs_retired_fallback": 0,
            "docs_retired_plane_full": 0,
            "docs_retired_lane_demote": 0,
            "docs_recycled": 0,
            "sync_serves": 0,
            "sync_cache_hits": 0,
            "sync_cache_misses": 0,
            "sync_cache_evictions": 0,
            "sync_encode_device": 0,
            "sync_encode_host": 0,
            "plane_broadcasts": 0,
            "cpu_fallbacks": 0,
            "flush_staging_allocs": 0,
            "flush_staging_reuses": 0,
            "flush_batches_sparse": 0,
            "flush_batches_dense": 0,
            "flush_batches_fast": 0,
            "flush_fast_ops": 0,
            "flush_slow_ops": 0,
        }
        # last completed flush cycle's stage breakdown; overwritten per
        # cycle, never accumulated
        self.flush_stats: dict[str, float] = {
            "build_ms": 0.0,
            "upload_ms": 0.0,
            "dispatch_ms": 0.0,
            "device_sync_ms": 0.0,
            "busy_slots": 0,
            "busy_fraction": 0.0,
            "batch_k": 0,
            "batch_b": 0,
            "batches": 0,
            "upload_bytes": 0,
            "fast_path_ops": 0,
            "slow_path_ops": 0,
            "fast_path_fraction": 0.0,
        }
        # double-buffered staging per path, allocated on first use; the
        # inflight entries hold the event recorded after each buffer's
        # last upload (None on the CPU, where copies are synchronous)
        self._staging: "Optional[list[_Staging]]" = None
        self._staging_inflight: list = [None, None]
        self._append_staging: "Optional[list[_Staging]]" = None
        self._append_inflight: list = [None, None]
        self._append_batches = 0
        # native text lane (enable_lane): the C++ host path for plain-
        # text docs. _lane_banned remembers docs that demoted (rich
        # content) so re-onboarding goes straight to the Python path.
        self._lane = None
        self._lane_codec = None
        self._lane_banned: set[str] = set()
        # update-lifecycle traces: the capture seam stamps sampled
        # updates, the flush carries them through drain, build, upload,
        # device and readback, and the broadcast pass closes them
        self.update_traces = UpdateTraceBook()
        self.compile_watch = WarmWatch()
        # device-lane seam (tpu/scheduler.py), set by the owning
        # extension: the plane never admits itself, its dispatch sites
        # only account each launch as in-lane or bypass
        self.lane = None

    def _note_dispatch(self, site: str, batches: int = 1) -> None:
        if self.lane is not None:
            self.lane.note_dispatch(site, batches)

    def device_scope(self):
        """Make the plane's device current in the calling thread: flushes
        and warm launches run in executor threads, and the C entries
        launch on the current device's current stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- arena dispatch ----------------------------------------------------
    # Each seam reads the module attribute at call time, so a caller may
    # wrap a step (the smoke's recorder, a test's failure injection).

    def _make_empty(self, num_docs: int, capacity: int):
        if self.arena == "rle":
            return make_empty_rle_state(num_docs, capacity, self.device)
        return make_empty_state(num_docs, capacity, self.device)

    def _step_fn(self):
        """The dense integrate step: (state, (K, D) ops) -> (state, count)."""
        if self.arena == "rle":
            return integrate_op_slots_rle_fast
        return integrate_op_slots_fast

    def _sparse_step_fn(self):
        """The sparse (busy-row) twin of _step_fn: takes (state, (K, B)
        ops, (B,) slot routing)."""
        if self.arena == "rle":
            return integrate_op_slots_rle_sparse_fast
        return integrate_op_slots_sparse_fast

    def _append_step_fn(self):
        """The run-append fast path: (state, (K, B) client, clock,
        run_len, (B,) slot routing) -> (state, applied-run count)."""
        if self.arena == "rle":
            return append_run_slots_rle_sparse_fast
        return append_run_slots_sparse_fast

    def _tail_probe_fn(self):
        """The rank-tail id readback: (state, (W,) slots) -> (2W,) int32
        [clients..., clocks...]."""
        if self.arena == "rle":
            return tail_probe_rle
        return tail_probe

    # -- native text lane --------------------------------------------------

    def enable_lane(self) -> None:
        """Switch on the C++ host path for plain-text docs (see
        native/text_lane.cpp). Raises when the codec cannot be built."""
        if self._lane is None:
            from ..native import get_codec

            self._lane_codec = get_codec()
            self._lane = self._lane_codec.lane_new()

    def register_lane(self, name: str) -> Optional[PlaneDoc]:
        """Register `name` on the native text lane (one slot, opened
        eagerly). Returns None when the lane is off / banned for this
        doc / the plane is full — caller falls back to register()."""
        if self._lane is None or name in self._lane_banned:
            return None
        doc = self.docs.get(name)
        if doc is not None:
            return doc if doc.lane_slot is not None else None
        if not self.free:
            return None
        slot = self.free.pop()
        doc = PlaneDoc(name)
        doc.lane_slot = slot
        self.docs[name] = doc
        self.slot_owner[slot] = name
        self.queues[slot] = []  # stays empty: ops queue natively
        self.unit_logs[slot] = []  # lazy materialization target
        self.projected_len[slot] = 0
        self.dispatched_units[slot] = 0
        self.validated_units[slot] = 0
        self.slot_live[slot] = True
        self.slot_gen[slot] += 1
        self._set_tail_empty(slot)
        self._lane_codec.lane_open(self._lane, slot)
        return doc

    def _enqueue_lane(
        self, doc: PlaneDoc, update: bytes, presync: bool, remote: bool
    ) -> int:
        slot = doc.lane_slot
        res = self._lane_codec.lane_apply(self._lane, slot, update, presync, remote)
        if res is None:
            # rich/tree/map content: this doc needs the Python path.
            # The ban makes the re-onboard (load-time retry or recycle)
            # take the plain register() route.
            self._lane_banned.add(doc.name)
            self.retire_doc(doc.name, "lane_demote")
            return 0
        ops_added, queued_units, queued_ops, root = res
        if root is not None and not doc.seqs:
            doc.seqs[("root", root)] = slot
        # RLE cost counts device-bound QUEUE entries, not serve-log
        # records: host-only GC records never consume arena entries
        # (mirrors the Python path routing GC to map_out)
        cost = queued_ops if self.arena == "rle" else queued_units
        projected = self.projected_len[slot] + cost
        if projected > self.capacity:
            self.retire_doc(doc.name, "capacity")
            return 0
        self.projected_len[slot] = projected
        if ops_added:
            self.dirty.add(doc.name)
        return ops_added

    def materialize_lane(self, doc: PlaneDoc) -> None:
        """Fill doc.serve_log / unit_logs / lowerer.known from the
        native lane for the Python serving paths (cold/stale syncs,
        text(), the RLE payload index). Cached on the log lengths, so
        repeated serves of an unchanged doc pay one export."""
        if doc.lane_slot is None:
            return
        slot = doc.lane_slot
        key = self._lane_codec.lane_log_len(self._lane, slot)
        if doc.lane_cache_key == key:
            return
        ops, units_bytes, known, root = self._lane_codec.lane_export(self._lane, slot)
        self.unit_logs[slot] = np.frombuffer(units_bytes, np.dtype("<u2")).tolist()
        parent = ("root", root) if root is not None else None
        recs = []
        for kind, client, clock, run_len, lc, lk, rc, rk, unit_off, flags in ops:
            gc = bool(flags & 2)
            op = DenseOp(
                kind=kind,
                client=client,
                clock=clock,
                run_len=run_len,
                left_client=lc,
                left_clock=lk,
                right_client=rc,
                right_clock=rk,
                deleted_content=bool(flags & 1),
                gc=gc,
                presync=bool(flags & 4),
                # mirrors the Python lowerer: the wire parent only
                # exists on origin-less items (and never on deletes/gc)
                parent=(
                    parent
                    if (
                        kind == KIND_INSERT
                        and not gc
                        and lc == NONE_CLIENT
                        and rc == NONE_CLIENT
                    )
                    else None
                ),
            )
            recs.append(
                LogRec(
                    op=op,
                    # gc records are host-only in the Python path
                    slot=None if gc else slot,
                    unit_off=unit_off,
                    remote=bool(flags & 8),
                )
            )
        doc.serve_log = recs
        doc.lowerer.known = dict(known)
        doc.lane_cache_key = key

    # -- registry ----------------------------------------------------------

    def register(self, name: str) -> PlaneDoc:
        doc = self.docs.get(name)
        if doc is None:
            doc = PlaneDoc(name)
            self.docs[name] = doc
        return doc

    def _alloc_seq(self, doc: PlaneDoc, seq_key: tuple) -> Optional[int]:
        slot = doc.seqs.get(seq_key)
        if slot is not None:
            return slot
        if not self.free:
            return None
        slot = self.free.pop()
        doc.seqs[seq_key] = slot
        self.slot_owner[slot] = doc.name
        self.queues[slot] = []
        self.unit_logs[slot] = []
        self.projected_len[slot] = 0
        self.dispatched_units[slot] = 0
        self.validated_units[slot] = 0  # freed slots keep length 0 too
        self.slot_live[slot] = True
        self.slot_gen[slot] += 1
        self._set_tail_empty(slot)
        return slot

    def note_trace(self, name: str) -> Optional[int]:
        """Capture-seam stamp: give one just-enqueued update a lifecycle
        trace id (sampled)."""
        return self.update_traces.stamp(name)

    def release(self, name: str) -> None:
        doc = self.docs.pop(name, None)
        if doc is None:
            return
        self.dirty.discard(name)
        self.update_traces.drop(name)
        slots = set(doc.seqs.values())
        if doc.lane_slot is not None:
            slots.add(doc.lane_slot)  # may predate root discovery
            self._lane_codec.lane_close(self._lane, doc.lane_slot)
        for slot in slots:
            self.slot_owner.pop(slot, None)
            self.queues.pop(slot, None)
            self._busy_slots.discard(slot)
            self.unit_logs.pop(slot, None)
            self.projected_len.pop(slot, None)
            self.dispatched_units[slot] = 0
            self.validated_units[slot] = 0
            self.slot_live[slot] = False
            self.slot_gen[slot] += 1
            self.free.append(slot)
        self._clear_slots(sorted(slots))

    def retire_doc(self, name: str, reason: str, count: bool = True) -> None:
        """Permanently degrade a doc to the CPU path (rows stay allocated
        until unload so the name keeps resolving to 'unsupported').
        count=False marks it retired without counting a new incident."""
        doc = self.docs.get(name)
        if doc is None:
            return
        if not doc.retired:
            doc.retired = True
            doc.retire_reason = reason
            if count:
                self.counters[f"docs_retired_{reason}"] += 1
            get_flight_recorder().record(name, "retire", reason=reason)
        self.update_traces.drop(name)
        doc.lowerer.unsupported = True
        doc.serve_log = []
        doc.map_tombstones = []
        self.dirty.discard(name)
        # lock-free: ops a concurrent drain captured before this clear
        # still dispatch, but into rows whose generation is bumped below,
        # so every health compare skips them; unit_logs is REBOUND so an
        # in-flight serve keeps a consistent snapshot
        for slot in doc.seqs.values():
            self._tail_known[slot] = False  # rows go inert: never fast-path
            self._tail_dirty.discard(slot)
            self.queues[slot].clear()
            self._busy_slots.discard(slot)
            self.unit_logs[slot] = []
            self.slot_live[slot] = False
            self.slot_gen[slot] += 1
        if doc.lane_slot is not None:
            # lane slots may predate root discovery (not yet in seqs)
            slot = doc.lane_slot
            self._lane_codec.lane_clear_queue(self._lane, slot)
            self.slot_live[slot] = False
            self.slot_gen[slot] += 1
            self._tail_known[slot] = False
            self._tail_dirty.discard(slot)

    def _clear_slots(self, slots: "list[int]") -> None:
        """Reset a batch of arena rows to their empty values in place (one
        indexed write per field, either arena) and bump the flush epoch
        once."""
        if not slots:
            return
        index = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        empty = self._make_empty(1, self.capacity)
        for field, empty_field in zip(self.state, empty):
            field[index] = empty_field[0]
        for slot in slots:
            self._set_tail_empty(slot)
        self.flush_epoch += 1

    def _set_tail_empty(self, slot: int) -> None:
        """Mark a slot's rank tail KNOWN-EMPTY (fresh/cleared row)."""
        self._tail_client[slot] = NONE_CLIENT
        self._tail_clock[slot] = 0
        self._tail_known[slot] = True
        self._tail_dirty.discard(slot)

    def is_supported(self, name: str) -> bool:
        doc = self.docs.get(name)
        if doc is None:
            return False
        return not doc.lowerer.unsupported

    # -- queueing ----------------------------------------------------------

    def enqueue_update(
        self, name: str, update: bytes, presync: bool = False, remote: bool = False
    ) -> int:
        """Lower + queue one update; returns the number of ops accepted."""
        lane_doc = self.docs.get(name)
        if lane_doc is not None and lane_doc.lane_slot is not None:
            if lane_doc.lowerer.unsupported:
                return 0
            return self._enqueue_lane(lane_doc, update, presync, remote)
        doc = self.register(name)
        if doc.lowerer.unsupported:
            return 0
        seq_ops, map_ops, map_tombs = doc.lowerer.lower_update(update)
        if doc.lowerer.unsupported:
            self.retire_doc(name, "unsupported")
            return 0
        count = 0
        for seq_key, ops in seq_ops.items():
            slot = self._alloc_seq(doc, seq_key)
            if slot is None:
                self.retire_doc(name, "plane_full")
                return 0
            # host-side mirror of the device capacity check: inserts
            # succeed until the arena overflows, at which point the doc
            # is CPU-only forever; stop queueing instead of leaking.
            # Unit arena: exact (capacity = units). RLE arena: a neutral
            # 1 per op (a run-aligned delete costs no entry, a mid-run
            # split up to 2), so the device overflow flag is the
            # authority there
            if self.arena == "rle":
                projected = self.projected_len[slot] + len(ops)
            else:
                projected = self.projected_len[slot] + sum(
                    op.run_len for op in ops if op.kind == KIND_INSERT
                )
            if projected > self.capacity:
                self.retire_doc(name, "capacity")
                return 0
            self.projected_len[slot] = projected
            if presync:
                for op in ops:
                    op.presync = True
            self.queues[slot].extend(ops)
            # AFTER the extend, unconditionally (see _busy_slots)
            self._busy_slots.add(slot)
            # log at ENQUEUE time: broadcasts build from the host log
            # without waiting for the device flush; arena slot assignment
            # is deterministic (arrival order), so unit offsets are final
            log = self.unit_logs[slot]
            for op in ops:
                doc.serve_log.append(
                    LogRec(op=op, slot=slot, unit_off=len(log), remote=remote)
                )
                if op.kind == KIND_INSERT:
                    log.extend(op.chars)
            count += len(ops)
        for op in map_ops:
            op.presync = presync
            doc.serve_log.append(LogRec(op=op, slot=None, remote=remote))
            count += 1
        for client, clock, length in map_tombs:
            doc.map_tombstones.append((client, clock, length))
            doc.serve_log.append(
                LogRec(
                    op=DenseOp(
                        kind=KIND_DELETE, client=client, clock=clock, run_len=length,
                        presync=presync,
                    ),
                    slot=None,
                    remote=remote,
                )
            )
            count += 1
        if count:
            self.dirty.add(name)
        return count

    def pending_ops(self) -> int:
        total = 0
        for slot in list(self._busy_slots):
            queue = self.queues.get(slot)
            if queue:
                total += len(queue)
        if self._lane is not None:
            total += self._lane_codec.lane_queue_total(self._lane)
        return total

    # -- device step -------------------------------------------------------

    def flush(self, max_batches: Optional[int] = None) -> int:
        """Integrate queued ops in (K, B) batches. Returns ops integrated.

        max_batches bounds the batches in this cycle (one batch already
        covers up to max_slots_per_flush ops for EVERY queue)."""
        with self._step_lock, self.device_scope():
            return self._flush_locked(max_batches)

    def _k_buckets(self) -> list[int]:
        buckets = []
        k = 1
        while True:
            buckets.append(k)
            if k >= self.max_slots_per_flush:
                return buckets
            k *= 2

    def _b_buckets(self) -> list[int]:
        """The sparse busy-width buckets: powers of four below the
        population (a wider busy set takes the dense (K, D) layout)."""
        buckets = []
        b = 1
        while b < self.num_docs:
            buckets.append(b)
            b *= 4
        return buckets

    def warmup_shapes(self) -> "list[tuple[int, int]]":
        """Every (K, B) integrate shape a flush can launch: sparse batches
        pin K to the top bucket, one shape per B bucket, plus the dense
        (k, num_docs) ladder."""
        k_max = self._k_buckets()[-1]
        return [(k_max, b) for b in self._b_buckets()] + [
            (k, self.num_docs) for k in self._k_buckets()
        ]

    def warmup_aux_shapes(self) -> "list[tuple]":
        """Tagged warm-grid entries beyond the integrate (k, b) pairs: the
        run-append fast path's ("append", K_max, B) ladder and the
        ("tail", W) probe widths _sync_health can launch."""
        k_max = self._k_buckets()[-1]
        shapes: "list[tuple]" = [
            ("append", k_max, b) for b in self._b_buckets() + [self.num_docs]
        ]
        widths = [16] if self.num_docs <= 16 else [16, self._TAIL_PROBE_MAX]
        shapes += [("tail", w) for w in widths]
        return shapes

    def _warm_site(self, entry: tuple) -> "tuple[str, tuple]":
        """(warm-watch site, shape key) for one warm-grid entry."""
        if entry[0] == "append":
            return "append_sparse", (entry[1], entry[2])
        if entry[0] == "tail":
            return "tail_probe", (entry[1],)
        k, b = entry
        if b >= self.num_docs:
            return "integrate_dense", (k, self.num_docs)
        return "integrate_sparse", (k, b)

    def _noop_ops(self, k: int, b: int) -> OpBatch:
        return OpBatch(
            *(
                torch.full((k, b), default, dtype=torch.int32, device=self.device)
                for default in _OP_DEFAULTS
            )
        )

    def _padding_slots(self, b: int) -> torch.Tensor:
        return torch.full((b,), self.num_docs, dtype=torch.int32, device=self.device)

    def warmup_compiles(self, shape=None, shared: bool = False) -> bool:
        """Launch each step once at a flush shape with a batch that
        changes nothing (noop ops; every routed column the padding
        sentinel), so the first live flush at that shape pays neither the
        kernel library's build or load nor the launch setup. `shape` is
        one entry of warmup_shapes() or warmup_aux_shapes() (callers take
        the flush lock per shape), or None for the whole grid.

        shared=True consults the process-wide warm registry
        (tpu/scheduler.py): a shape another plane of the same geometry on
        the same device already launched is skipped. Returns True when
        anything was launched."""
        full_grid = shape is None
        shapes = [shape] if shape is not None else self.warmup_shapes() + self.warmup_aux_shapes()
        if shared:
            from .scheduler import note_warmed, shared_warm_filter

            shapes, covered = shared_warm_filter(
                self.arena, self.num_docs, self.capacity, shapes, device=str(self.device)
            )
            for entry in covered:
                self.compile_watch.mark_covered(*self._warm_site(entry))
        dispatched = False
        with self._step_lock, self.device_scope():
            for entry in shapes:
                site, shape_key = self._warm_site(entry)
                if site == "append_sparse":
                    _, k, b = entry
                    zeros = [
                        torch.zeros((k, b), dtype=torch.int32, device=self.device)
                        for _ in range(3)
                    ]
                    self.state, _count = self._append_step_fn()(
                        self.state, *zeros, self._padding_slots(b)
                    )
                elif site == "tail_probe":
                    (w,) = shape_key
                    probe = torch.zeros(w, dtype=torch.int32, device=self.device)
                    self._tail_probe_fn()(self.state, probe).cpu()
                elif site == "integrate_dense":
                    k, _b = entry
                    self.state, _count = self._step_fn()(self.state, self._noop_ops(k, self.num_docs))
                else:
                    k, b = entry
                    self.state, _count = self._sparse_step_fn()(
                        self.state, self._noop_ops(k, b), self._padding_slots(b)
                    )
                self.compile_watch.observe(site, shape_key, warmup=True)
                self._note_dispatch("warmup")
                dispatched = True
                if shared:
                    note_warmed(
                        self.arena, self.num_docs, self.capacity, entry, device=str(self.device)
                    )
            if dispatched and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if full_grid:
            self.compile_watch.mark_warmed()
        return dispatched

    def _bucket_b(self, busy: int) -> int:
        """Round a busy width up to its sparse bucket (powers of four);
        num_docs (the dense layout) when it exceeds the top bucket."""
        b = 1
        while b < busy:
            b *= 4
        return b if b < self.num_docs else self.num_docs

    def _plan_batch(self, busy: int) -> "tuple[bool, int]":
        """The flush layout decision, in ONE place: (dense, b)."""
        b = self._bucket_b(busy)
        return b >= self.num_docs, b

    def _flush_locked(self, max_batches: Optional[int] = None) -> int:
        tracer = get_tracer()
        book = self.update_traces
        trace_batches: list = []
        k_max = self._k_buckets()[-1]
        total = 0
        batches = 0
        device_batches = 0
        fast_total = slow_total = 0
        build_ms = upload_ms = dispatch_ms = 0.0
        upload_bytes = 0
        k_last = b_last = busy_last = 0
        while max_batches is None or batches < max_batches:
            t0 = time.perf_counter()
            drained = self._drain_ops(k_max)
            if drained is None:
                break
            cycle_traces = None
            if book.active():
                # stamped updates whose slots drained this batch enter
                # the in-flight set; t0 closes their queue-wait stage
                cycle_traces = book.take_drained(
                    (self.slot_owner.get(int(s)) for s in drained[4]), t0
                )
            built = drained[5]
            busy_total = int(drained[4].size)
            # split the drained columns into all-sequential (fast) and
            # concurrent (slow) sets; the two dispatches touch disjoint
            # rows, so their order is immaterial
            fast = None
            slow = drained
            if self.run_merge_enabled:
                fast, slow = self._classify_fast(drained)
            if fast is not None:
                (
                    run_row, run_col, f_client, f_clock, f_run,
                    f_slots, f_ops, f_tail_cl, f_tail_ck,
                ) = fast
                nf = int(f_slots.size)
                bf = self._bucket_b(nf)
                index = self._append_batches % 2
                staging_f = self._append_staging_for(index, k_max)
                cl_v, ck_v, rn_v = staging_f.views(k_max, bf, reset=(2,))
                cl_v.view(np.uint32)[run_row, run_col] = f_client
                ck_v[run_row, run_col] = f_clock
                rn_v[run_row, run_col] = f_run
                slot_view_f = staging_f.slot_view(k_max, bf)
                slot_view_f[:nf] = f_slots
                slot_view_f[nf:] = self.num_docs
                t1 = time.perf_counter()
                fields_f, slots_f = staging_f.upload(k_max, bf, self.device)
                self._append_inflight[index] = self._record_upload()
                self._append_batches += 1
                t2 = time.perf_counter()
                with tracer.device_span("merge_plane.append", slots=k_max, busy=bf):
                    self.state, _count = self._append_step_fn()(
                        self.state, fields_f[0], fields_f[1], fields_f[2], slots_f
                    )
                t_dispatch = time.perf_counter()
                self.compile_watch.observe("append_sparse", (k_max, bf))
                # the dispatched runs land at the rank tail, so the new
                # tail is each column's last coalesced run
                self._tail_client[f_slots] = f_tail_cl
                self._tail_clock[f_slots] = f_tail_ck
                self.counters["flush_batches_fast"] += 1
                self.counters["flush_fast_ops"] += f_ops
                fast_total += f_ops
                device_batches += 1
                if cycle_traces and slow is None:
                    trace_batches.append((cycle_traces, t1, t2, t_dispatch))
                build_ms += (t1 - t0) * 1000.0
                upload_ms += (t2 - t1) * 1000.0
                dispatch_ms += (t_dispatch - t2) * 1000.0
                upload_bytes += _Staging.nbytes(3, k_max, bf, True)
                k_last, b_last = k_max, bf
                t0 = t_dispatch  # the slow build, if any, starts here
            if slow is not None:
                depth = slow[6]
                # sparse batches pin K to the top bucket; dense batches
                # keep the power-of-two K ladder
                dense, b_bucket = self._plan_batch(int(slow[4].size))
                if dense:
                    k = 1
                    while k < depth:
                        k *= 2
                else:
                    k = k_max
                index = batches % 2
                staging = self._staging_for(index, k)
                slot_view, b = self._assemble_batch(k, slow, staging, dense, b_bucket)
                t1 = time.perf_counter()
                fields, slots_dev = staging.upload(
                    k, b, self.device, with_slots=slot_view is not None
                )
                self._staging_inflight[index] = self._record_upload()
                ops = OpBatch(*fields)
                t2 = time.perf_counter()
                # the dispatch is asynchronous on the card: while it
                # integrates batch i, the next iteration builds batch i+1
                # in the OTHER staging buffer; _sync_health below is the
                # cycle's single completion barrier
                with tracer.device_span("merge_plane.integrate", slots=k, busy=b):
                    if slot_view is None:
                        self.state, _count = self._step_fn()(self.state, ops)
                        self.counters["flush_batches_dense"] += 1
                    else:
                        self.state, _count = self._sparse_step_fn()(
                            self.state, ops, slots_dev
                        )
                        self.counters["flush_batches_sparse"] += 1
                t_dispatch = time.perf_counter()
                if slot_view is None:
                    self.compile_watch.observe("integrate_dense", (k, self.num_docs))
                else:
                    self.compile_watch.observe("integrate_sparse", (k, b))
                # full-integrate columns invalidate their tracked rank
                # tails; _sync_health re-arms the live ones below
                slow_cols = slow[4].astype(np.intp)
                self._tail_known[slow_cols] = False
                for col in slow_cols:
                    col = int(col)
                    if self.slot_live[col]:
                        self._tail_dirty.add(col)
                self.counters["flush_slow_ops"] += slow[5]
                slow_total += slow[5]
                device_batches += 1
                if cycle_traces:
                    trace_batches.append((cycle_traces, t1, t2, t_dispatch))
                build_ms += (t1 - t0) * 1000.0
                upload_ms += (t2 - t1) * 1000.0
                dispatch_ms += (t_dispatch - t2) * 1000.0
                upload_bytes += _Staging.nbytes(8, k, b, slot_view is not None)
                k_last, b_last = k, b
            total += built
            busy_last = busy_total
            batches += 1
        if batches:
            self._note_dispatch("flush", device_batches)
            t3 = time.perf_counter()
            self._sync_health()
            t_sync = time.perf_counter()
            if trace_batches:
                # the cycle's single readback barrier closes every
                # in-flight trace's device and readback stages
                book.complete_cycle(trace_batches, t_sync)
            self.flush_stats.update(
                build_ms=round(build_ms, 3),
                upload_ms=round(upload_ms, 3),
                dispatch_ms=round(dispatch_ms, 3),
                device_sync_ms=round((t_sync - t3) * 1000.0, 3),
                busy_slots=busy_last,
                busy_fraction=round(busy_last / max(self.num_docs, 1), 6),
                batch_k=k_last,
                batch_b=b_last,
                batches=batches,
                upload_bytes=upload_bytes,
                fast_path_ops=fast_total,
                slow_path_ops=slow_total,
                fast_path_fraction=round(fast_total / max(total, 1), 6),
            )
        return total

    def _record_upload(self):
        """An event on the current stream after an upload, so the staging
        buffer it read can be waited on before its next reset."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _sync_health(self) -> None:
        """ONE combined device->host readback per flush cycle.

        Reads lengths + overflow as a single tensor — also the completion
        barrier for every batch dispatched before it. The dispatched ->
        validated snapshot is taken at the same point, so health checks
        compare device rows against exactly the ops the device has
        integrated. When full-integrate columns invalidated tracked rank
        tails, the dirty LIVE slots' tail ids ride the same readback via
        tail_probe and re-arm the run-merge classifier. At most
        _TAIL_PROBE_MAX slots re-arm per cycle; the rest stay dirty."""
        probe_slots = None
        probe_width = 0
        if self._tail_dirty and self.run_merge_enabled:
            live = sorted(slot for slot in self._tail_dirty if self.slot_live[slot])
            self._tail_dirty.clear()
            if len(live) > self._TAIL_PROBE_MAX:
                self._tail_dirty.update(live[self._TAIL_PROBE_MAX :])
                live = live[: self._TAIL_PROBE_MAX]
            if live:
                probe_slots = np.asarray(live, np.intp)
                probe_width = 16 if len(live) <= 16 else self._TAIL_PROBE_MAX
        parts = [self.state.length, self.state.overflow.to(torch.int32)]
        if probe_slots is not None:
            padded = np.zeros(probe_width, np.int32)
            padded[: probe_slots.size] = probe_slots  # pad: re-read slot 0
            slots = torch.from_numpy(padded).to(self.device)
            parts.append(self._tail_probe_fn()(self.state, slots))
        combined = torch.cat(parts).cpu().numpy()
        lengths = combined[: self.num_docs].astype(np.int64)
        self.last_lengths = lengths
        self.last_overflows = combined[self.num_docs : 2 * self.num_docs].astype(bool)
        if probe_slots is not None:
            probe = combined[2 * self.num_docs :].view(np.uint32)
            n = probe_slots.size
            clients = probe[:n]
            clocks = probe[probe_width : probe_width + n].astype(np.int64)
            empty = lengths[probe_slots] == 0
            self._tail_client[probe_slots] = np.where(
                empty, np.uint32(NONE_CLIENT), clients
            )
            self._tail_clock[probe_slots] = np.where(empty, 0, clocks)
            self._tail_known[probe_slots] = True
        self.validated_units = self.dispatched_units.copy()
        self.last_gen = self.slot_gen.copy()
        self.flush_epoch += 1

    # per-cycle cap on tail re-arms (bounds the probe's device work)
    _TAIL_PROBE_MAX = 256

    def _drain_ops(self, k: int):
        """Pop up to k ops from every BUSY queue (Python + native lane)
        into flat coordinate / value lists — O(busy). Returns None when
        nothing was drained, else (rows, slots, vals, lane, cols, built,
        depth): Python op coordinates (row-in-batch, arena slot) and 8
        per-field value columns, the lane's columnar drain tuple (or
        None), the sorted unique busy slot ids, the op count and the
        deepest per-queue take (the dense layout's K requirement)."""
        rows: list[int] = []
        slots: list[int] = []
        vals: tuple[list[int], ...] = ([], [], [], [], [], [], [], [])
        built = 0
        depth = 0
        for slot in sorted(self._busy_slots):
            queue = self.queues.get(slot)
            if not queue:
                self._busy_slots.discard(slot)
                if queue:  # an enqueue raced the discard: repair
                    self._busy_slots.add(slot)
                continue
            take = queue[:k]
            # del by len(take), not k: an enqueue may extend this queue
            # between the slice and the del; only the front is taken
            del queue[: len(take)]
            if not queue:
                self._busy_slots.discard(slot)
                if queue:  # an enqueue raced the discard: repair
                    self._busy_slots.add(slot)
            dispatched = 0
            for i, op in enumerate(take):
                rows.append(i)
                slots.append(slot)
                vals[0].append(op.kind)
                vals[1].append(op.client)
                vals[2].append(op.clock)
                vals[3].append(op.run_len)
                vals[4].append(op.left_client)
                vals[5].append(op.left_clock)
                vals[6].append(op.right_client)
                vals[7].append(op.right_clock)
                if op.kind == KIND_INSERT:
                    dispatched += op.run_len
            built += len(take)
            if len(take) > depth:
                depth = len(take)
            self.dispatched_units[slot] += dispatched
        lane = None
        if self._lane is not None:
            # native lane drain: one C call pops up to k ops per lane
            # slot into columnar buffers scattered by _assemble_batch —
            # no per-op Python at all on the hot-doc flush path
            drained = self._lane_codec.lane_drain(self._lane, k)
            if drained[0]:
                lane = drained
                ds = np.frombuffer(drained[11], np.int64)
                self.dispatched_units[ds] += np.frombuffer(drained[12], np.int64)
                built += drained[0]
                lane_rows = np.frombuffer(drained[1], np.int64)
                depth = max(depth, int(lane_rows.max()) + 1)
        if not built:
            return None
        cols = np.unique(np.asarray(slots, np.int64))
        if lane is not None:
            cols = np.union1d(cols, np.frombuffer(lane[2], np.int64))
        return rows, slots, vals, lane, cols, built, depth

    def _classify_fast(self, drained):
        """The run-merge concurrency classifier: split one drained cycle
        into fast COLUMNS (every op a chained tail append — integrable by
        the append program) and slow columns (the full integrate).
        Returns (fast_pack | None, slow | None), `slow` shaped like a
        _drain_ops result (lane ops folded into the flat arrays, lane
        None).

        An op is a pure tail append iff it is an INSERT with no right
        origin whose left origin is the column's current rank tail; for
        such ops the YATA window is empty, so the append program is
        bit-identical to the integrate. Chains verify inductively (op m's
        left must be op m-1's last unit), all in vectorized numpy."""
        rows, slots, vals, lane, cols, built, depth = drained
        if lane is None and not rows:
            return None, drained
        parts_row: list = []
        parts_slot: list = []
        parts_f: "list[list]" = [[] for _ in range(8)]
        if rows:
            parts_row.append(np.asarray(rows, np.int64))
            parts_slot.append(np.asarray(slots, np.int64))
            for i in range(8):
                dtype = np.uint32 if i in (1, 4, 6) else np.int64
                parts_f[i].append(np.asarray(vals[i], dtype))
        if lane is not None:
            # lane columns: client fields uint32, the rest int32
            parts_row.append(np.frombuffer(lane[1], np.int64))
            parts_slot.append(np.frombuffer(lane[2], np.int64))
            for i, buf in enumerate(lane[3:11]):
                if i in (1, 4, 6):
                    parts_f[i].append(np.frombuffer(buf, np.uint32))
                else:
                    parts_f[i].append(np.frombuffer(buf, np.int32).astype(np.int64))
        op_row = np.concatenate(parts_row)
        op_slot = np.concatenate(parts_slot)
        fields = [np.concatenate(p) for p in parts_f]
        n = op_slot.size
        # column-major order: a slot's ops are contiguous, row-ordered (a
        # slot drains from exactly one source, Python queue or lane, so
        # the concatenation never interleaves within a column)
        order = np.lexsort((op_row, op_slot))
        s = op_slot[order]
        row_s = op_row[order]
        kind_s, cl_s, ck_s, rn_s, lc_s, lk_s, rc_s, rk_s = (f[order] for f in fields)
        first = np.ones(n, bool)
        first[1:] = s[1:] != s[:-1]
        sp = s.astype(np.intp)
        head_ok = np.where(
            lc_s == NONE_CLIENT,
            # an origin-less insert appends only to an EMPTY row
            self._tail_client[sp] == np.uint32(NONE_CLIENT),
            (lc_s == self._tail_client[sp]) & (lk_s == self._tail_clock[sp]),
        )
        prev_cl = np.empty(n, np.uint32)
        prev_end = np.empty(n, np.int64)
        prev_cl[0] = 0
        prev_end[0] = 0
        prev_cl[1:] = cl_s[:-1]
        prev_end[1:] = ck_s[:-1] + rn_s[:-1] - 1
        ok = (
            (kind_s == KIND_INSERT)
            & (rc_s == NONE_CLIENT)
            & self._tail_known[sp]
            & np.where(first, head_ok, (lc_s == prev_cl) & (lk_s == prev_end))
        )
        col_starts = np.flatnonzero(first)
        col_ok = np.logical_and.reduceat(ok, col_starts)
        if not col_ok.any():
            return None, drained
        counts = np.diff(np.append(col_starts, n))
        member = np.repeat(col_ok, counts)
        # coalesce the fast subset: consecutive same-client runs with
        # clock continuity merge into ONE device run
        fs = s[member]
        fcl = cl_s[member]
        fck = ck_s[member]
        frn = rn_s[member]
        m = int(fs.size)
        newrun = np.ones(m, bool)
        newrun[1:] = (
            (fs[1:] != fs[:-1])
            | (fcl[1:] != fcl[:-1])
            | (fck[1:] != fck[:-1] + frn[:-1])
        )
        run_starts = np.flatnonzero(newrun)
        run_slot = fs[run_starts]
        run_client = fcl[run_starts]
        run_clock = fck[run_starts]
        run_len = np.add.reduceat(frn, run_starts)
        run_first = np.ones(run_slot.size, bool)
        run_first[1:] = run_slot[1:] != run_slot[:-1]
        col_of_run = np.cumsum(run_first) - 1
        first_run = np.flatnonzero(run_first)
        run_row = np.arange(run_slot.size) - first_run[col_of_run]
        last_run = np.append(first_run[1:] - 1, run_slot.size - 1)
        fast = (
            run_row.astype(np.intp),
            col_of_run.astype(np.intp),
            run_client,
            run_clock.astype(np.int64),
            run_len.astype(np.int64),
            run_slot[run_first].astype(np.int64),
            m,
            run_client[last_run],
            (run_clock[last_run] + run_len[last_run] - 1).astype(np.int64),
        )
        if member.all():
            return fast, None
        keep = ~member
        slow = (
            row_s[keep],
            s[keep],
            (
                kind_s[keep], cl_s[keep], ck_s[keep], rn_s[keep],
                lc_s[keep], lk_s[keep], rc_s[keep], rk_s[keep],
            ),
            None,
            s[col_starts][~col_ok],
            int(n - m),
            int(row_s[keep].max()) + 1,
        )
        return fast, slow

    def _staging_for(self, index: int, k: int) -> _Staging:
        """The op staging buffer for this batch (alternating between two
        preallocated sets), its previous upload waited on first so a
        reset can never race an in-flight copy. Reallocation only happens
        for a K beyond the bucketed grid — counted, so the reuse
        accounting can pin allocs flat."""
        if self._staging is None or self._staging[0].k_max < k:
            k_max = max(self._k_buckets()[-1], k)
            pin = self.device.type == "cuda"
            self._staging = [
                _Staging(k_max, self.num_docs, _OP_DEFAULTS, pin) for _ in range(2)
            ]
            self._staging_inflight = [None, None]
            self.counters["flush_staging_allocs"] += 2
        else:
            self.counters["flush_staging_reuses"] += 1
        return self._retire(self._staging, self._staging_inflight, index)

    def _append_staging_for(self, index: int, k: int) -> _Staging:
        """The append fast path's staging buffer for this batch — same
        double-buffer + retire-before-reuse discipline as _staging_for."""
        if self._append_staging is None or self._append_staging[0].k_max < k:
            k_max = max(self._k_buckets()[-1], k)
            pin = self.device.type == "cuda"
            self._append_staging = [
                _Staging(k_max, self.num_docs, _RUN_DEFAULTS, pin) for _ in range(2)
            ]
            self._append_inflight = [None, None]
            self.counters["flush_staging_allocs"] += 2
        else:
            self.counters["flush_staging_reuses"] += 1
        return self._retire(self._append_staging, self._append_inflight, index)

    @staticmethod
    def _retire(buffers: list, inflight: list, index: int) -> _Staging:
        event = inflight[index]
        if event is not None:
            event.synchronize()
            inflight[index] = None
        return buffers[index]

    def _assemble_batch(self, k: int, drained, staging: _Staging, dense: bool, b: int):
        """Scatter drained ops into staging views. `dense`/`b` come from
        _plan_batch. Sparse layout: a compact (K, B) batch over the busy
        columns plus the (B,) routing (padding columns route to the
        num_docs sentinel); dense (K, D) layout (column = arena slot)
        when every slot is effectively busy. Returns (slot_view | None,
        b)."""
        rows, slots, vals, lane, cols, _built, _depth = drained
        if dense:
            b = self.num_docs
            col_idx = np.asarray(slots, np.intp)
            slot_view = None
        else:
            col_idx = np.searchsorted(cols, np.asarray(slots, np.int64))
            slot_view = staging.slot_view(k, b)
            slot_view[: cols.size] = cols
            slot_view[cols.size :] = self.num_docs
        views = staging.views(k, b, reset=range(8))
        if len(rows):  # list (live drain) or ndarray (classifier remainder)
            ri = np.asarray(rows, np.intp)
            for i, view in enumerate(views):
                if i in (1, 4, 6):
                    view.view(np.uint32)[ri, col_idx] = np.asarray(vals[i], np.uint32)
                else:
                    view[ri, col_idx] = vals[i]
        if lane is not None:
            ri = np.frombuffer(lane[1], np.int64)
            lane_slots = np.frombuffer(lane[2], np.int64)
            ci = lane_slots if dense else np.searchsorted(cols, lane_slots)
            for i, (view, buf) in enumerate(zip(views, lane[3:11])):
                if i in (1, 4, 6):
                    view.view(np.uint32)[ri, ci] = np.frombuffer(buf, np.uint32)
                else:
                    view[ri, ci] = np.frombuffer(buf, np.int32)
        return slot_view, b

    # -- extraction --------------------------------------------------------

    def check_doc_health(
        self,
        name: str,
        doc: PlaneDoc,
        lengths: np.ndarray,
        overflows: np.ndarray,
        validated: Optional[np.ndarray] = None,
        gens: Optional[np.ndarray] = None,
    ) -> bool:
        """Device/host invariants for every row of a doc; retires on fail.

        Callers supply the (D,) length/overflow rows AND the validated-
        unit + generation snapshots taken with them. Device lengths are
        compared against VALIDATED dispatch tallies, never the host unit
        logs (those run ahead of the device by design). A slot whose
        binding generation changed since the snapshot is skipped."""
        if validated is None:
            validated = self.validated_units
        if gens is None:
            gens = self.last_gen
        for slot in doc.seqs.values():
            if gens is None or gens[slot] != self.slot_gen[slot]:
                continue  # snapshot predates this slot's binding
            if bool(overflows[slot]):
                self.retire_doc(name, "overflow")
                return False
            if int(validated[slot]) != int(lengths[slot]):
                self.retire_doc(name, "desync")
                return False
        return True

    def text(self, name: str) -> Optional[str]:
        """Decode a plain-text document's live text from device state.

        Defined for docs whose content is a single root sequence of text
        units (formats are zero-width, as in Yjs); tree docs and value
        sequences return None. A surrogate pair decodes as a real
        character only when its two units are id-consecutive from one
        client AND rank-adjacent, as on the CPU path."""
        from ..crdt.content import ContentFormat

        doc = self.docs.get(name)
        if doc is None:
            return None
        if doc.lowerer.unsupported:
            return None
        self.materialize_lane(doc)
        roots = [key for key in doc.seqs if key[0] == "root"]
        if len(doc.seqs) != len(roots) or len(roots) > 1:
            return None  # tree-shaped: byte-served, not materialized
        if not roots:
            return ""
        with self._step_lock:
            if self.pending_ops() > 0:
                self._flush_locked(None)
            if not self.check_doc_health(
                name,
                doc,
                self.state.length.cpu().numpy(),
                self.state.overflow.cpu().numpy(),
            ):
                return None
            slot = doc.seqs[roots[0]]
            log = self.unit_logs[slot]
            if self.arena == "rle":
                expanded = self._rle_live_units(doc, slot, log)
                if expanded is None:
                    return None
                clients, clocks, ranks, entries = expanded
            else:
                live = extract_live_mask(self.state)[slot].cpu().numpy()
                occupied = np.nonzero(live)[0]
                ranks_all = self.state.rank[slot].cpu().numpy()[occupied]
                order = np.argsort(ranks_all)
                sel = occupied[order]
                ranks = ranks_all[order]
                clients = self.state.id_client[slot].cpu().numpy().view(np.uint32)[sel]
                clocks = self.state.id_clock[slot].cpu().numpy()[sel]
                entries = [log[i] for i in sel]
        out: list[int] = []
        i = 0
        count = len(entries)
        while i < count:
            entry = entries[i]
            if entry is None:
                return None  # RLE: payload not locatable in the unit log
            if not isinstance(entry, int):
                if isinstance(entry, ContentFormat):
                    i += 1  # zero-width formatting boundary
                    continue
                return None  # embeds/values: not a plain text doc
            c = entry
            if 0xD800 <= c <= 0xDBFF:
                nxt = entries[i + 1] if i + 1 < count else None
                if (
                    isinstance(nxt, int)
                    and 0xDC00 <= nxt <= 0xDFFF
                    and clients[i + 1] == clients[i]
                    and clocks[i + 1] == clocks[i] + 1
                    and ranks[i + 1] == ranks[i] + 1
                ):
                    out.append(c)
                    out.append(nxt)
                    i += 2
                    continue
                out.append(0xFFFD)
            elif 0xDC00 <= c <= 0xDFFF:
                out.append(0xFFFD)
            else:
                out.append(c)
            i += 1
        return units_to_text(out)

    def unit_off_index(self, doc: PlaneDoc, slot: int) -> "dict[int, list]":
        """client -> clock-sorted [(clock, unit_off, run_len)] intervals
        of the slot's insert records: maps a (client, clock) id to its
        payload position in the slot's unit log. The RLE arena stores
        runs, not per-unit arrival indices, so payload lookup goes
        through the serve log (written at enqueue time, in dispatch
        order)."""
        self.materialize_lane(doc)
        index: dict[int, list] = {}
        for rec in doc.serve_log:
            op = rec.op
            if rec.slot != slot or op.kind != KIND_INSERT:
                continue
            # every sequence insert logs exactly run_len unit-log
            # entries, so the intervals tile the log densely
            index.setdefault(op.client, []).append((op.clock, rec.unit_off, op.run_len))
        for intervals in index.values():
            intervals.sort()
        return index

    def _rle_live_units(self, doc: PlaneDoc, slot: int, log: list):
        """The slot's live RLE entries, rank-ordered, expanded to
        per-unit lists (clients, clocks, ranks, entries) matching the
        unit-arena extraction, payloads resolved via unit_off_index. An
        entry of None means the unit's payload was not found."""
        from bisect import bisect_right

        num = int(self.state.num_runs[slot])
        rcl = self.state.run_client[slot][:num].cpu().numpy().view(np.uint32)
        rck = self.state.run_clock[slot][:num].cpu().numpy()
        rln = self.state.run_len[slot][:num].cpu().numpy()
        rrk = self.state.run_rank[slot][:num].cpu().numpy()
        rdl = self.state.run_deleted[slot][:num].cpu().numpy()
        keep = (rln > 0) & ~rdl
        kcl, kck, kln, krk = rcl[keep], rck[keep], rln[keep], rrk[keep]
        index = self.unit_off_index(doc, slot)
        clients: list[int] = []
        clocks: list[int] = []
        ranks: list[int] = []
        entries: list = []
        for i in np.argsort(krk):
            client, clk, remaining, rnk = int(kcl[i]), int(kck[i]), int(kln[i]), int(krk[i])
            intervals = index.get(client)
            if not intervals:
                return None
            # one entry's units may span SEVERAL insert records: the
            # append fast path EXTENDS the rank-tail entry with a later
            # op's units, so walk the clock range across the intervals
            while remaining > 0:
                pos = bisect_right(intervals, (clk, 0x7FFFFFFF, 0)) - 1
                if pos < 0:
                    return None
                iv_clock, iv_off, iv_len = intervals[pos]
                if not iv_clock <= clk < iv_clock + iv_len:
                    return None
                take = min(remaining, iv_clock + iv_len - clk)
                start = iv_off + (clk - iv_clock)
                for u in range(take):
                    clients.append(client)
                    clocks.append(clk + u)
                    ranks.append(rnk + u)
                    entries.append(log[start + u] if start + u < len(log) else None)
                clk += take
                rnk += take
                remaining -= take
        return clients, clocks, ranks, entries


class TpuMergeExtension(Extension):
    """Puts live documents on the merge plane via onChange.

    Two modes:
    - shadow (serve=False): the plane mirrors every supported document;
      the CPU document serves.
    - serve (serve=True): for supported docs the plane IS the serving
      path — SyncStep2 replies come from device state
      (`Document.sync_source`), per-update CPU fan-out is suppressed
      (`Document.broadcast_source`) and replaced by one merged broadcast
      per coalescing window. A CRDT-level degradation (unsupported
      content, overflow, desync) falls the doc back to the CPU path,
      shipping the full CPU state once so receivers that only saw plane
      broadcasts are whole; each such fallback is counted in
      `plane.counters["cpu_fallbacks"]`. A failed device step raises on
      the card (see `_device_fault`); only a CPU plane degrades on it.

    The counterpart of the JAX package's extension of the same name on
    one device. The plane runs on the card unless `device="cpu"` is
    given (`device=None` means the card, and raises without CUDA).
    Sharding (`mesh=`) and arena residency (`evict_idle_secs`,
    `compact_threshold`) are not ported yet (ROADMAP.md, Queue A) and
    raise NotImplementedError. `native_lane` (default on, serve mode
    only) runs every plain-text doc's host path in the port's C++ text
    lane (`hocuspocus_tpu_torch/native`); a doc whose updates carry
    rich content demotes to the Python path (`docs_retired_lane_demote`)
    and is rebuilt there in place. `native_lane=False` keeps every doc
    on the Python path. The lane's codec builds at construction and a
    failed build raises.
    """

    priority = 900

    def __init__(
        self,
        num_docs: int = 256,
        capacity: int = 4096,
        flush_interval_ms: float = 5.0,
        plane: Optional[MergePlane] = None,
        serve: bool = False,
        mesh=None,
        device=None,
        broadcast_interval_ms: float = 2.0,
        arena: str = "unit",
        native_lane: bool = True,
        evict_idle_secs: float = 0.0,
        compact_threshold: float = 0.0,
        governor: bool = True,
    ) -> None:
        """governor — arrival-aware batching (tpu/scheduler.py): the
        flush cadence and the kernel calls per cycle follow the
        op-arrival EWMA, queue depth and lane congestion instead of the
        fixed flush_interval_ms (which stays the governor's BASE
        cadence). False restores the fixed timer exactly. The device
        work admits through the process-global device lane.
        """
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (a sharded plane) is not ported yet: ROADMAP.md, Queue A"
            )
        if evict_idle_secs > 0 or compact_threshold > 0:
            raise NotImplementedError(
                "arena residency (evict_idle_secs, compact_threshold) is not "
                "ported yet: ROADMAP.md, Queue A"
            )
        if plane is not None and device is not None:
            raise ValueError(
                "pass device= to the MergePlane you construct, not alongside "
                "plane= (an explicit plane keeps its own device)"
            )
        self.plane = plane or MergePlane(
            num_docs=num_docs,
            capacity=capacity,
            arena=arena,
            device="cuda" if device is None else device,
        )
        from .scheduler import BatchGovernor, get_device_lane

        self.lane = self.plane.lane = get_device_lane()
        self.governor = BatchGovernor(base_interval_ms=flush_interval_ms) if governor else None
        # governor policy inputs ride a short-TTL depth cache:
        # pending_ops() is O(busy slots) and the capture seam calls the
        # governor per update. Policy tolerates 5ms staleness; the
        # post-flush reschedule check stays exact.
        self._depth_cache = 0
        self._depth_cache_at = 0.0
        # native text lane: the C++ host path (lower+log+queue+window)
        # for plain-text docs. Serve-mode only: its broadcast windows
        # ride the lane
        self.native_lane = bool(native_lane and serve)
        if self.native_lane:
            self.plane.enable_lane()
        self.flush_interval_ms = flush_interval_ms
        # broadcasts build from the HOST serve logs and run on their own
        # (shorter) coalescing window, decoupled from the device flush:
        # edits landing within the window share one frame per doc, and
        # the device round trip never sits on the edit->observe path
        self.broadcast_interval_ms = broadcast_interval_ms
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        # single-flight guard for the flush task: one cycle in flight;
        # it reschedules
        self._flush_inflight = False
        self._broadcast_handle: Optional[asyncio.TimerHandle] = None
        self._last_broadcast_at = 0.0
        self.serve = serve
        self.serving = None
        self._docs: dict[str, object] = {}  # name -> server Document being served
        self._instance = None  # hocuspocus instance (hook dispatch)
        # strong refs to in-flight tasks: the event loop only weakly
        # references tasks, and a GC'd flush task silently stops the
        # serve pipeline (or strands the flush lock mid-acquire)
        self._flush_tasks: set = set()
        # the listen-time warm grid (on_listen); awaitable by callers that
        # must not race it
        self.warmup_task: Optional[asyncio.Task] = None
        # docs whose recycle attempt found no headroom for their live
        # state: further attempts are suppressed until unload
        self._recycle_declined: set[str] = set()
        if serve:
            from .serving import PlaneServing

            self.serving = PlaneServing(self.plane)

    def _spawn_tracked(self, coro) -> "asyncio.Task":
        return spawn_tracked(self._flush_tasks, coro)

    # -- hooks ---------------------------------------------------------------

    async def on_listen(self, data: Payload) -> None:
        """Warm the plane off the event loop: build or load the arena's
        kernel library and launch every flush shape once, then the
        serving gathers, so the first live flush pays neither nvcc nor
        the launch setup. The warm grid rides the device lane at the
        LOWEST priority, one admission per shape: early client flushes
        go between shapes instead of waiting out the grid. A launch that
        fails ends the task with its error (await `warmup_task` to see
        it); the flushes that follow meet the same error."""

        async def warm_one(work) -> None:
            from .scheduler import CLASS_WARM

            ticket = await self.lane.admit(CLASS_WARM, site="warmup")
            try:
                async with self.plane.flush_lock:
                    await asyncio.get_event_loop().run_in_executor(None, work)
            except Exception:
                from ..server import logger as _logger_mod

                _logger_mod.logger.error("plane warmup failed", exc_info=True)
                raise
            finally:
                ticket.release()

        async def warm() -> None:
            for shape in self.plane.warmup_shapes() + self.plane.warmup_aux_shapes():
                await warm_one(lambda s=shape: self.plane.warmup_compiles(s, shared=True))
            # from here every flush shape has launched once
            self.plane.compile_watch.mark_warmed()
            if self.serving is not None:
                for width in self.serving._gather_widths():
                    await warm_one(lambda w=width: self.serving.warmup_gathers(w))

        self.warmup_task = self._spawn_tracked(warm())

    def _attach_serving(self, name: str, document) -> None:
        """Hook a document into the plane's serving seams (shared by
        load-time onboarding and capacity recycling — the mirror of
        _detach_serving)."""
        from .serving import TpuSyncSource

        document.sync_source = TpuSyncSource(
            self.serving, name, document, on_fault=self._device_fault
        )
        document.broadcast_source = self
        self._docs[name] = document

    async def after_load_document(self, data: Payload) -> None:
        from ..crdt import encode_state_as_update

        self._instance = data.instance
        name = data.document_name
        lane_doc = self.plane.register_lane(name) if self.native_lane else None
        if lane_doc is None:
            self.plane.register(name)
        snapshot = encode_state_as_update(data.document)
        # receivers get pre-load state via sync, not broadcast
        self.plane.enqueue_update(name, snapshot, presync=True)
        if lane_doc is not None and not self.plane.is_supported(name):
            # load-time lane demote (the snapshot holds rich content):
            # nothing is served yet, so retry on the Python path in
            # place instead of the full fallback+recycle dance.
            # flush_lock: release() rewrites device rows and must not
            # race an executor-side flush
            plane_doc = self.plane.docs.get(name)
            if plane_doc is not None and plane_doc.retire_reason == "lane_demote":
                async with self.plane.flush_lock:
                    self._onboard_python(name, snapshot)
        if self.serve and self.plane.is_supported(name):
            self._attach_serving(name, data.document)
        self._schedule_flush()

    async def on_change(self, data: Payload) -> None:
        if self.serve and data.document_name in self._docs:
            return  # already captured synchronously in try_capture
        if self.serve:
            # fresh traffic on a doc that degraded off the plane (e.g. a
            # device OVERFLOW retire from the health sweep, a seam
            # try_capture never sees): busy docs are worth re-onboarding
            # from their live snapshot
            plane_doc = self.plane.docs.get(data.document_name)
            if plane_doc is not None and plane_doc.retired:
                self._maybe_recycle(data.document, plane_doc.retire_reason)
                return
        accepted = self.plane.enqueue_update(data.document_name, data.update)
        if accepted and self.governor is not None:
            self.governor.note_arrival(accepted)
        self._schedule_flush()

    async def after_unload_document(self, data: Payload) -> None:
        name = data.document_name
        instance = data.instance
        # release mutates the queue/log registries a concurrent
        # executor-side flush iterates — serialize with it. ALL of the
        # teardown sits inside the lock and behind a liveness re-check:
        # a rejoin can re-load the document while unload hooks await,
        # and plane.register() then reuses this registration, so a late
        # release here would silently detach the NEW incarnation.
        while True:
            async with self.plane.flush_lock:
                loading = None if instance is None else instance.loading_documents.get(name)
                if loading is None:
                    if instance is not None and name in instance.documents:
                        return  # re-loaded while we waited: registration lives on
                    self._detach_serving(name, self._docs.pop(name, None))
                    self.plane.release(name)
                    # a future incarnation starts with a fresh recycle
                    # budget. The plane's lane ban is deliberately NOT
                    # cleared: a doc that demoted carries rich content in
                    # its stored state, and re-trying the lane on every
                    # reload would re-pay the demote each time
                    self._recycle_declined.discard(name)
                    return
            # A re-load is in flight. Wait for it OUTSIDE the lock: on
            # success its own eventual unload fires this hook again; on
            # FAILURE no further after_unload will ever fire for this
            # name, so loop back and do the teardown here.
            try:
                await asyncio.shield(loading)
                return
            except Exception:
                # an already-failed future raises without suspending;
                # yield so create_document's finally runs before we
                # re-check
                await asyncio.sleep(0)

    async def on_destroy(self, data: Payload) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
        if self._broadcast_handle is not None:
            self._broadcast_handle.cancel()
        # flush the broadcast tail (local only), then fully drain the
        # device queues: no timer fires after teardown to pick up
        # either. final=True: the drain is pause-exempt
        self._broadcast_served(cross_instance=False)
        await self._flush_now(max_batches=None, final=True)

    # -- serving: update capture (called by Document._handle_update) ---------

    def try_capture(self, document, update: bytes, origin) -> bool:
        """Claim an update for plane-batched broadcast. False = CPU fan-out."""
        from ..server.types import REDIS_ORIGIN, REPLICA_ORIGIN

        name = document.name
        if not self.serve or name not in self._docs:
            return False
        plane = self.plane
        if not plane.is_supported(name):
            plane_doc = plane.docs.get(name)
            reason = plane_doc.retire_reason if plane_doc is not None else None
            if reason == "lane_demote":
                # keep serving attached; this update rides the CPU
                # fan-out until the Python-plane registration lands.
                # Re-spawn per update: an earlier attempt may have
                # bailed, and the rebuild's guards make redundant
                # spawns no-ops
                self._spawn_tracked(self._rebuild_lane_doc(document))
                return False
            # already degraded (e.g. a device OVERFLOW retire from the
            # post-flush health sweep, where no recycle seam runs) —
            # this fresh traffic is the signal the doc is still busy
            self._fallback_to_cpu(document)
            self._maybe_recycle(document, reason)
            return False
        # stamp the (sampled) update with a trace id BEFORE queueing: an
        # executor-side flush can drain the queue the moment the op lands
        book = plane.update_traces
        trace_id = plane.note_trace(name) if book.enabled else None
        # remote-origin applies (another instance, a replica stream) are
        # kept out of the window's cross-instance frame
        accepted = plane.enqueue_update(
            name, update, remote=origin in (REDIS_ORIGIN, REPLICA_ORIGIN)
        )
        if trace_id is not None and not accepted:
            book.unstamp(name, trace_id)
        if not plane.is_supported(name):
            # this very update degraded the doc; it broadcasts via CPU
            plane_doc = plane.docs.get(name)
            reason = plane_doc.retire_reason if plane_doc is not None else None
            if reason == "lane_demote":
                # the doc outgrew the native text lane (first map/rich
                # op): rebuild it on the Python plane IN PLACE — serving
                # stays attached, this and subsequent updates ride the
                # per-update CPU fan-out until the rebuild lands
                self._spawn_tracked(self._rebuild_lane_doc(document))
                return False
            self._fallback_to_cpu(document)
            self._maybe_recycle(document, reason)
            return False
        if accepted and self.governor is not None:
            # feed the arrival-rate EWMA BEFORE scheduling: the cadence
            # decision below reads it
            self.governor.note_arrival(accepted)
        self._schedule_flush()
        self._schedule_broadcast()
        return True

    async def _rebuild_lane_doc(self, document) -> None:
        """In-place re-onboard of a lane-demoted doc onto the Python
        plane path.

        Unlike capacity recycling there is no CPU-fallback broadcast:
        receivers stay current through (1) the pending lane window,
        shipped here before the log is dropped, and (2) per-update CPU
        fan-out for every update between the demote and this rebuild
        (try_capture returns False for a retired doc). The plane's ban
        set routes register_lane() callers to the Python path."""
        from ..crdt import encode_state_as_update

        name = document.name
        plane = self.plane
        async with plane.flush_lock:
            if document.get_connections_count() <= 0:
                return  # unloading anyway
            doc = plane.docs.get(name)
            if (
                doc is None
                or not doc.retired
                or doc.retire_reason != "lane_demote"
                or name not in self._docs
            ):
                return  # state moved on; leave it be
            try:
                pair = self.serving.build_broadcast_pair(name)
                if pair is not None:
                    update, cross = pair
                    document.broadcast_update_frame(update)
                    if cross is not None and self._instance is not None:
                        self._spawn_tracked(
                            self._instance.hooks(
                                "on_plane_broadcast",
                                Payload(
                                    instance=self._instance,
                                    document_name=name,
                                    document=document,
                                    update=cross,
                                ),
                            )
                        )
                new_doc = self._onboard_python(name, encode_state_as_update(document))
            except Exception:
                # not a content verdict (a failed window encode, or
                # release() writing the arena rows): on the card it
                # raises; a CPU plane degrades this doc alone, as the
                # JAX package's extension does
                from ..server import logger as _logger_mod

                if plane.device.type == "cuda":
                    self._device_fault()
                _logger_mod.logger.error(
                    "lane-demote rebuild failed for %r; degrading to CPU", name, exc_info=True
                )
                self._fallback_to_cpu(document)
                return
            if new_doc is None or new_doc.lowerer.unsupported:
                # genuinely unsupported content: the doc leaves the
                # plane for the plain CPU path
                self._fallback_to_cpu(document)
                return
            # the cursor still points into the LANE's op log; left stale
            # it would swallow (or mis-slice) every window of the fresh
            # Python-path registration
            self.serving.broadcast_cursor[name] = len(new_doc.serve_log)
        self._schedule_flush()

    def _onboard_python(self, name: str, snapshot: bytes) -> "Optional[PlaneDoc]":
        """Release `name` and register it again on the Python host path,
        lowering `snapshot` as presync (a lane demote's retry: the ban
        set keeps register_lane() off it). The caller holds flush_lock:
        release() rewrites arena rows."""
        plane = self.plane
        plane.release(name)
        plane.register(name)
        plane.enqueue_update(name, snapshot, presync=True)
        return plane.docs.get(name)

    def _maybe_recycle(self, document, reason: "Optional[str]") -> None:
        """Schedule a recycle for row-exhaustion retires ("capacity",
        "plane_full", "overflow") and lane demotes: re-onboard with
        fresh rows lowered from the live CPU snapshot. Content retires
        ("unsupported") and desyncs never recycle."""
        if reason not in ("capacity", "plane_full", "overflow", "lane_demote"):
            return
        if document.name in self._recycle_declined:
            return
        self._spawn_tracked(self._recycle_capacity_doc(document))

    async def _recycle_capacity_doc(self, document) -> None:
        """Give a row-exhaustion-retired doc fresh arena rows: release
        the exhausted rows, re-register, lower the live snapshot as
        presync. If the live state itself nearly fills a row or the
        plane has no spare rows, the doc stays on the CPU path rather
        than thrash through recycles."""
        from .scheduler import CLASS_CATCHUP

        # catch-up class: recovery work for a live busy doc
        ticket = await self.lane.admit(CLASS_CATCHUP, site="recycle")
        try:
            await self._recycle_capacity_doc_admitted(document)
        finally:
            ticket.release()

    async def _recycle_capacity_doc_admitted(self, document) -> None:
        from ..crdt import encode_state_as_update

        name = document.name
        plane = self.plane
        async with plane.flush_lock:
            if document.get_connections_count() <= 0:
                return  # unloading anyway
            if name in self._docs:
                return  # already re-onboarded
            if name in self._recycle_declined:
                return  # a queued attempt ran after the verdict landed
            existing = plane.docs.get(name)
            if existing is None or not existing.retired:
                return  # registration changed under us; leave it be
            try:
                plane.release(name)
                # a hot plain-text doc keeps its native lane across the
                # recycle (unless it demoted: the ban set routes it to
                # the Python path inside register_lane)
                if not (self.native_lane and plane.register_lane(name)):
                    plane.register(name)
                snapshot = encode_state_as_update(document)
                plane.enqueue_update(name, snapshot, presync=True)
                doc = plane.docs.get(name)
                if doc is not None and doc.retired and doc.retire_reason == "lane_demote":
                    # the doc had never tried the lane before (not
                    # banned) and its snapshot is rich: retry in place on
                    # the Python path instead of stranding it
                    doc = self._onboard_python(name, snapshot)
                if doc is None or doc.lowerer.unsupported:
                    self._recycle_declined.add(name)
                    return  # live content unsupported/too big: stays on CPU
                # guard retires use count=False: this incident was
                # already counted when the original registration retired
                for slot in doc.seqs.values():
                    if plane.projected_len[slot] > plane.capacity * 3 // 4:
                        plane.retire_doc(name, "capacity", count=False)
                        self._recycle_declined.add(name)
                        return  # no row headroom: recycling would thrash
                if len(plane.free) < 2:
                    # no spare rows: the next new sequence would
                    # plane_full again immediately
                    plane.retire_doc(name, "plane_full", count=False)
                    self._recycle_declined.add(name)
                    return
                plane.counters["docs_recycled"] += 1
                get_flight_recorder().record(name, "recycle")
                self._attach_serving(name, document)
            except Exception:
                # a half-recycled registration would silently swallow
                # ops: mark it retired so the doc lives on the CPU path.
                # On the card a failed step raises instead
                from ..server import logger as _logger_mod

                if plane.device.type == "cuda":
                    self._device_fault()
                _logger_mod.log_error(f"recycle failed for {name!r}; staying on CPU")
                plane.retire_doc(name, "fallback", count=False)
                return
        self._schedule_flush()

    def _detach_serving(self, name: str, document) -> None:
        """Unhook a document from the plane's serving seams and drop its
        serving caches (shared by CPU fallback and unload teardown)."""
        if document is not None:
            document.sync_source = None
            document.broadcast_source = None
        if self.serving is not None:
            self.serving.forget(name, self.plane.docs.get(name))

    def _fallback_to_cpu(self, document) -> None:
        from ..crdt import encode_state_as_update

        name = document.name
        if self._docs.pop(name, None) is None:
            return  # already degraded
        self._detach_serving(name, document)
        if name in self.plane.docs:
            self.plane.retire_doc(name, "fallback")
        self.plane.update_traces.drop(name)
        get_flight_recorder().record(name, "degrade")
        self.plane.counters["cpu_fallbacks"] += 1
        # receivers may hold plane broadcasts only up to the last flush;
        # ship the full CPU state once (dedup makes it a cheap no-op for
        # anyone already current)
        document.broadcast_update_frame(encode_state_as_update(document))

    # -- flush ---------------------------------------------------------------

    def _device_fault(self) -> None:
        """Called inside the handler of a failed device step (a flush, a
        sync serve's flush and encode, a lane-demote rebuild or a
        recycle). On the card the error
        propagates: a kernel that does not build or launch fails the
        flush, the sync serve and the server loudly, and the CPU never
        serves in the plane's place. On a CPU plane every served doc
        degrades to the CPU document, as the JAX package's extension
        does: the dead flush already consumed the captured ops, and only
        the full-state fallback broadcast carries them."""
        from ..server import logger as _logger_mod

        if self.plane.device.type == "cuda":
            _logger_mod.logger.error("plane device step failed on the card", exc_info=True)
            raise
        _logger_mod.logger.error("plane device step failed; degrading served docs to CPU", exc_info=True)
        for document in list(self._docs.values()):
            try:
                self._fallback_to_cpu(document)
            except Exception:
                _logger_mod.log_error(f"CPU fallback failed for {document.name!r}")

    def _broadcast_served(self, cross_instance: bool = True) -> None:
        """One broadcast pass: every doc with new serve-log records gets
        one merged frame. Pure host work (serve logs + cached health
        rows) — never waits on the device flush; a desync the validator
        finds a cycle later degrades that doc via full-state CPU
        fallback, which supersedes any optimistic frames."""
        if not self.serve:
            return
        plane = self.plane
        dirty = list(plane.dirty)
        plane.dirty.clear()
        docs_by_name: dict = {}
        served_dirty: list = []
        for name in dirty:
            document = self._docs.get(name)
            if document is not None:
                docs_by_name[name] = document
                served_dirty.append(name)
        # one vectorized health compare covers the common case; only
        # suspects pay the per-doc check (which retires on failure)
        try:
            healthy, suspects = self.serving.filter_healthy(served_dirty)
        except Exception:
            from ..server import logger as _logger_mod

            _logger_mod.log_error("vectorized health filter failed; falling back to per-doc checks")
            healthy, suspects = [], served_dirty
        for name in suspects:
            document = docs_by_name[name]
            # per-doc guard: any serving error degrades that doc only
            try:
                if self.serving.doc_healthy(name) is None:
                    self._fallback_to_cpu(document)
                    continue
            except Exception:
                self._degrade_one(name, document)
                continue
            healthy.append(name)
        if not healthy:
            return
        try:
            # per-doc encode failures come back in `failed`
            pairs, failed = self.serving.build_broadcast_pairs(healthy)
        except Exception:
            # only the batch call itself can land here: a plane-level
            # fault, so degrading the set is the honest outcome
            for name in healthy:
                self._degrade_one(name, docs_by_name[name])
            return
        for name in failed:
            self._degrade_one(name, docs_by_name[name])
        book = plane.update_traces
        for name, pair in pairs:
            document = docs_by_name[name]
            try:
                if pair is None:
                    # empty window (e.g. presync-only records): close any
                    # flushed traces anyway — fan-out was a no-op
                    book.finish(name)
                    continue
                update, cross_update = pair
                # window frames ride the document's broadcast tick
                # (server/fanout.py); the lifecycle trace closes at
                # LAST-SOCKET-ENQUEUE via the tick's completion callback
                document.queue_broadcast(
                    update,
                    on_complete=(lambda t_last, _name=name: book.finish(_name, t_last)),
                )
                if cross_instance and cross_update is not None and self._instance is not None:
                    # cross-instance fan-out rides the merged window
                    # frame minus remote-origin ops
                    self._spawn_tracked(
                        self._instance.hooks(
                            "on_plane_broadcast",
                            Payload(
                                instance=self._instance,
                                document_name=name,
                                document=document,
                                update=cross_update,
                            ),
                        )
                    )
            except Exception:
                self._degrade_one(name, document)

    def _degrade_one(self, name: str, document) -> None:
        from ..server import logger as _logger_mod

        _logger_mod.log_error(f"plane broadcast failed for {name!r}; degrading to CPU path")
        try:
            self._fallback_to_cpu(document)
        except Exception:
            _logger_mod.log_error(f"CPU fallback failed for {name!r}")

    async def _flush_now(self, max_batches: Optional[int] = 1, final: bool = False) -> None:
        """Flush+serve with the DEVICE step off the event loop.

        `plane.flush()` synchronizes with the card at its health readback;
        it runs in the default executor (which makes the plane's device
        current in its worker thread) so websockets keep pumping while
        the card integrates. Reads on the event-loop thread stay ordered
        after it: both use the device's default stream, under flush_lock.

        Broadcasts do NOT run here: they build from the host serve logs
        on their own timer (_schedule_broadcast), so the device cycle
        only gates validation and sync serves, never the edit->observe
        path. The cycle admits through the device lane as INTERACTIVE
        before touching the flush lock. on_destroy passes final=True
        with max_batches=None for a full drain, which waits for the lane
        at most 5 s. A failed device step goes to `_device_fault`: it
        raises on the card.
        """
        from .scheduler import CLASS_INTERACTIVE, CLASS_NAMES, LaneDeferred

        if self._flush_inflight and not final:
            return  # the in-flight cycle reschedules; don't stack waiters
        self._flush_inflight = True
        try:
            try:
                ticket = await self.lane.admit(
                    CLASS_INTERACTIVE, site="flush", deadline_s=5.0 if final else None
                )
            except LaneDeferred as deferred:
                # only the final drain has a deadline: teardown proceeds
                # unarbitrated
                get_flight_recorder().record(
                    "__plane__",
                    "flush_deferred",
                    lane_class=CLASS_NAMES[deferred.lane_class],
                    wait_ms=round(deferred.waited_s * 1000.0, 3),
                )
                ticket = None
            try:
                if self.governor is not None and max_batches == 1:
                    congested = self.lane.contended()
                    max_batches = self.governor.max_batches(self._policy_depth(), congested)
                async with self.plane.flush_lock:
                    try:
                        await asyncio.get_event_loop().run_in_executor(
                            None, lambda: self.plane.flush(max_batches)
                        )
                        if self.serve:
                            self.serving.refresh()
                    except Exception:
                        self._device_fault()
                        return
                    if self.serve:
                        self._validate_served()
                if self.governor is not None:
                    self.governor.note_cycle(self.plane.flush_stats)
            finally:
                if ticket is not None:
                    ticket.release()
            if self.plane.pending_ops() > 0:
                self._schedule_flush()
            elif self.governor is not None:
                self.governor.note_park()
        finally:
            self._flush_inflight = False

    def _validate_served(self) -> None:
        """Post-flush desync sweep, vectorized over every slot: one numpy
        compare of the flush's combined readback against the validated
        dispatch tallies catches a device-side op rejection even when no
        further edit or sync would touch the doc. Affected served docs
        degrade to the CPU path via the full-state fallback broadcast."""
        plane = self.plane
        if plane.last_lengths is None or plane.last_gen is None:
            return
        bad = (
            plane.slot_live
            & (plane.last_gen == plane.slot_gen)
            & ((plane.validated_units != plane.last_lengths) | plane.last_overflows)
        )
        if not bad.any():
            return
        for slot in np.nonzero(bad)[0]:
            name = plane.slot_owner.get(int(slot))
            if name is None:
                continue
            if self.serving.doc_healthy(name) is None:
                document = self._docs.get(name)
                if document is not None:
                    self._fallback_to_cpu(document)

    def _schedule_flush(self) -> None:
        if self._flush_handle is not None:
            return

        def run() -> None:
            self._flush_handle = None
            self._spawn_tracked(self._flush_now())

        if self.governor is not None:
            # arrival-aware cadence: immediate full drain past the
            # queue-depth watermark, base cadence under steady load or
            # lane congestion, stretched ticks when arrivals are sparse
            delay = self.governor.flush_delay_s(self._policy_depth(), self.lane.contended())
        else:
            delay = self.flush_interval_ms / 1000
        self._flush_handle = asyncio.get_event_loop().call_later(delay, run)

    def _policy_depth(self) -> int:
        """Queued-op depth for GOVERNOR decisions only (5ms-stale)."""
        now = time.monotonic()
        if now - self._depth_cache_at > 0.005:
            self._depth_cache = self.plane.pending_ops()
            self._depth_cache_at = now
        return self._depth_cache

    def _schedule_broadcast(self) -> None:
        if not self.serve or self._broadcast_handle is not None:
            return
        loop = asyncio.get_event_loop()

        def run() -> None:
            self._broadcast_handle = None
            self._last_broadcast_at = loop.time()
            self._broadcast_served()

        # coalescing window only under sustained traffic: a lone edit
        # after an idle gap broadcasts on the next loop tick, while
        # back-to-back edits within the window share one frame per doc
        window = self.broadcast_interval_ms / 1000
        idle = loop.time() - self._last_broadcast_at
        delay = 0.0 if idle >= window else window
        self._broadcast_handle = loop.call_later(delay, run)
