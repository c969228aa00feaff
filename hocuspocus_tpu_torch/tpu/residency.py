"""Arena residency manager: eviction, batched hydration, compaction.

The port of the JAX package's `tpu/residency.py` for one plane on one
device. Without it an arena row is a permanent lease: a slot stays bound
from registration to unload, and a doc whose row fills is retired to the
CPU document for good, so a long-lived server bleeds device capacity.
This module makes residency a managed cache with three mechanisms:

1. **Eviction.** Idle docs (no edit for `evict_idle_secs`, by the
   activity clock the extension feeds) are snapshotted on the host,
   through `PlaneServing.encode_state_as_update` (the plane's own serving
   path, so the snapshot is exactly what a cold joiner would receive) or
   else the authoritative CPU document, and their rows released. The doc
   keeps serving from the CPU document; the snapshot is its ticket back.

2. **Batched hydration.** Evicted or cold docs re-enter through an
   admission-controlled queue: at most `hydrate_batch` docs are onboarded
   per round (register, enqueue the snapshot and the live document's
   state, then ONE flush for the whole batch), with the event loop
   yielded between rounds. A catch-up storm of cold docs thus costs
   bounded in-flight work and reuses the flush engine's bucketed batch
   shapes. Snapshot plus live-document replay (the lowerer's known-clock
   dedup skips what the snapshot covered) makes the round trip lossless.

3. **On-device compaction.** Rows nearing capacity are rewritten by the
   compaction programs (`kernels.compact_doc_rows`, tombstone GC of the
   unit arena, and `kernels_rle.compact_doc_rows_rle`, the run-length
   defragmenter). The unit arena packs live units and drops tombstone
   ids; the host keeps an origin remap so later ops that name removed ids
   re-anchor to the nearest live neighbour (the information loss yjs
   accepts once tombstones are garbage collected). The run-length arena
   defragments losslessly. A capacity- or overflow-retired doc whose live
   state fits is un-retired in place and serves from the plane again.
   Here the port departs from the JAX package on purpose: the unit
   rebuild chains each live run to its rank predecessor, and where that
   names an origin a decoder could only integrate after the run itself
   (random-position typing puts a client's later clock before its
   earlier one), the served bytes would be unreadable. The port declines
   such a compaction (`_rebuild_decodable`) and the doc takes the
   snapshot recycle instead; the JAX package compacts it (ROADMAP.md,
   Queue C).

All device work runs under the plane's flush lock and step lock, like
every other device client, and everything pauses while the supervisor
has serving paused (breaker open). On the card a failed device step
raises, as the flush and serve paths do: nothing falls back to the CPU
document in the card's place.
"""

from __future__ import annotations

import asyncio
import time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..aio import spawn_tracked
from ..observability.flight_recorder import get_flight_recorder
from .kernels import KIND_INSERT, NONE_CLIENT
from .lowering import DenseOp
from .merge_plane import LogRec, MergePlane, PlaneDoc


@dataclass
class EvictedDoc:
    """Host-side residue of an evicted doc: the encoded snapshot that
    re-enters the plane at hydration time."""

    snapshot: bytes
    evicted_at: float


class ResidencyManager:
    """Owns arena residency policy for one merge plane.

    Normally constructed by `TpuMergeExtension` (pass
    `evict_idle_secs` / `hydrate_batch` / `compact_threshold` there);
    standalone construction with (plane, serving) lets benches and tests
    drive the policy directly. The hot-doc replica seams
    (`adopt_snapshot`, `replica_snapshot`, `replica_catchup`) serve the
    edge tier's follower cells; the JAX package's cross-cell migration
    seams (`evict_for_migration`, `quiesce`) come with its per-card cells
    (ROADMAP.md, Queue A item 7).
    """

    def __init__(
        self,
        extension=None,
        *,
        plane: Optional[MergePlane] = None,
        serving=None,
        evict_idle_secs: float = 0.0,
        hydrate_batch: int = 64,
        compact_threshold: float = 0.0,
        evict_batch: int = 16,
        evicted_cap: int = 1_000_000,
        evicted_max_bytes: int = 256 * 1024 * 1024,
    ) -> None:
        self.extension = extension
        self.plane = plane if plane is not None else extension.plane
        self.serving = serving if serving is not None else getattr(
            extension, "serving", None
        )
        self.evict_idle_secs = float(evict_idle_secs)
        self.hydrate_batch = max(int(hydrate_batch), 1)
        self.compact_threshold = float(compact_threshold)
        self.evict_batch = max(int(evict_batch), 1)
        self.evicted_cap = int(evicted_cap)
        self.evicted_max_bytes = int(evicted_max_bytes)
        self._evicted_bytes = 0
        # doc name -> monotonic time of the last edit (fed by the
        # extension's capture seams). touch() moves the key to the END,
        # so iteration order is least-recently-active first and the
        # eviction scan stops at the first still-fresh entry instead of
        # walking every loaded doc each tick
        self.last_active: dict[str, float] = {}
        # doc name -> EvictedDoc; survives unloads so a cold LOAD storm
        # hydrates from stored snapshots too. Capped FIFO by BOTH entry
        # count and total snapshot bytes (_evicted_add) so a server
        # churning through transient names — or a few huge docs — can't
        # grow host memory unboundedly. Losing a record is safe: the
        # CPU document stays authoritative, a load just goes the
        # ordinary (cold) register path instead of the warm one.
        self.evicted: dict[str, EvictedDoc] = {}
        self._queue: deque = deque()  # (name, document, requested_at)
        self._queued: set[str] = set()
        self._drain_running = False
        self.inflight = 0
        self._hydration_latencies: deque = deque(maxlen=4096)
        # docs whose compaction attempt could not apply (log desync,
        # rich payloads, no headroom): suppressed until the doc
        # re-registers. Only retired-path declines land here — they
        # drop the preserved logs, so a retry could never succeed.
        self._compact_declined: set[str] = set()
        # live-doc sweep backoff: projected occupancy at the last
        # nothing-to-reclaim decline — the sweep retries only once the
        # row has grown past it (more content, possibly more garbage)
        self._compact_backoff: dict[str, int] = {}
        # docs whose rows an executor-side compaction is rewriting
        # RIGHT NOW: try_capture declines them (updates ride the CPU
        # fan-out; the post-compaction tail replay re-syncs the plane)
        self._compacting: set[str] = set()
        # retired docs whose host logs retire_doc preserved for a
        # compaction attempt (fed by note_preserved): the sweep visits
        # these proactively so an idle retired doc doesn't hold its
        # largest-possible logs until its next edit
        self._preserved: set[str] = set()
        # rotating cursor for the pressure sweep: a bounded slice of
        # the doc registry per tick instead of an O(all-docs) scan
        self._sweep_ring: list[str] = []
        self._tasks: set = set()
        self.plane.residency = self  # retire-time log preservation seam
        # a card plane's failed device step raises (_fault); tests of the
        # card's rails set it on a CPU plane
        self.on_card = self.plane.device.type == "cuda"
        # replica seams' SyncStep2s the plane served (a None for a held
        # doc counts in the plane's cpu_fallbacks instead)
        self.replica_serves = {"snapshot": 0, "catchup": 0}
        # a card fault propagates (see _fault); only a CPU plane declines
        # device-lane arbiter (tpu/scheduler.py): hydration batches ride
        # the catch-up class, compaction sweeps the background class —
        # both yield to interactive flushes between microbatches. A
        # standalone manager (tests, benches) runs unarbitrated.
        self.lane = getattr(extension, "lane", None)

    # -- policy inputs -------------------------------------------------------

    @property
    def paused(self) -> bool:
        """Residency work pauses whenever the supervisor paused serving
        (breaker open): no new device traffic on a wedged runtime."""
        return self.serving is not None and self.serving.paused

    @property
    def maintenance_interval(self) -> float:
        if self.evict_idle_secs > 0:
            return max(self.evict_idle_secs / 4.0, 0.25)
        return 2.0

    def touch(self, name: str) -> None:
        # move-to-end keeps last_active ordered oldest-first (see
        # __init__): O(1) here buys an early-exit eviction scan
        self.last_active.pop(name, None)
        self.last_active[name] = time.monotonic()

    def is_evicted(self, name: str) -> bool:
        return name in self.evicted

    def _evicted_add(self, name: str, snapshot: bytes) -> None:
        old = self.evicted.pop(name, None)
        if old is not None:
            self._evicted_bytes -= len(old.snapshot)
        self.evicted[name] = EvictedDoc(snapshot, time.monotonic())
        self._evicted_bytes += len(snapshot)
        while self.evicted and (
            len(self.evicted) > self.evicted_cap
            or self._evicted_bytes > self.evicted_max_bytes
        ):
            oldest = next(iter(self.evicted))
            self._evicted_bytes -= len(self.evicted.pop(oldest).snapshot)

    def _evicted_pop(self, name: str) -> Optional[EvictedDoc]:
        record = self.evicted.pop(name, None)
        if record is not None:
            self._evicted_bytes -= len(record.snapshot)
        return record

    def is_compacting(self, name: str) -> bool:
        """True while an executor-side compaction is rewriting this
        doc's rows: the capture seam must route updates to the CPU
        fan-out (broadcast stays correct; the tail replay afterwards
        brings the plane current)."""
        return name in self._compacting

    def forget_doc(self, name: str) -> None:
        """Per-doc policy teardown at unload/re-onboard (the eviction
        snapshot deliberately survives: it warms a future cold load)."""
        self.last_active.pop(name, None)
        self._compact_declined.discard(name)
        self._compact_backoff.pop(name, None)
        self._preserved.discard(name)

    def note_preserved(self, name: str) -> None:
        """Called by `MergePlane.retire_doc` right after a log-preserving
        retire: the compaction sweep visits these docs proactively."""
        self._preserved.add(name)

    def _has_unshipped(self, doc: PlaneDoc) -> bool:
        """Plane-claimed records not yet broadcast: the capture seam
        already told the server NOT to CPU-fan-out these updates, so
        evicting the doc (dropping its queues/serving) or rewriting its
        serve log now would silently drop them from fan-out. Transient
        — the broadcast tick ships and clears within one window.

        Only meaningful under an extension: the capture seam that
        claims updates away from the CPU fan-out lives there. A
        standalone manager (tests, benches) broadcasts nothing, so
        nothing can be unshipped."""
        if self.extension is None:
            return False
        plane = self.plane
        if doc.name in plane.dirty:
            return True
        if self.serving is None:
            return False
        cursor = self.serving.broadcast_cursor.get(doc.name, 0)
        if doc.lane_slot is not None:
            if plane._lane is None:
                return False
            ops_len, _ = plane._lane_codec.lane_log_len(
                plane._lane, doc.lane_slot
            )
            return cursor < ops_len
        return any(not rec.op.presync for rec in doc.serve_log[cursor:])

    def wants_logs(self, doc: PlaneDoc, reason: str) -> bool:
        """Asked by `MergePlane.retire_doc`: keep the doc's host logs
        through a row-exhaustion retire so a compaction attempt can
        rebuild from them (a declined attempt drops them)."""
        return (
            reason in ("capacity", "overflow")
            and doc.lane_slot is None
            and doc.name not in self._compact_declined
        )

    def stats_snapshot(self) -> dict:
        lat = np.asarray(self._hydration_latencies, np.float64)
        return {
            "evicted_docs": len(self.evicted),
            "evicted_bytes": self._evicted_bytes,
            "hydration_queue_depth": len(self._queue),
            "hydrations_inflight": self.inflight,
            "hydration_p50_ms": (
                round(float(np.percentile(lat, 50)) * 1000.0, 3) if lat.size else 0.0
            ),
            "hydration_p99_ms": (
                round(float(np.percentile(lat, 99)) * 1000.0, 3) if lat.size else 0.0
            ),
        }

    def _publish_stats(self, **extra) -> None:
        stats = self.plane.residency_stats
        stats.update(self.stats_snapshot())
        stats["hydration_queue_peak"] = max(
            stats.get("hydration_queue_peak", 0), stats["hydration_queue_depth"]
        )
        stats.update(extra)

    def _fault(self) -> None:
        """Called inside the handler of a failed device step: on the card
        the error propagates, as the flush and serve paths raise there;
        on a CPU plane the caller declines the step and goes on."""
        if self.on_card:
            raise

    def _spawn(self, coro) -> None:
        if self.extension is not None:
            self.extension._spawn_tracked(coro)
        else:
            spawn_tracked(self._tasks, coro)

    # -- maintenance (timer-driven) ------------------------------------------

    async def run_maintenance(self) -> None:
        """One policy tick: evict idle docs, compact pressured rows.
        Bounded work per tick; each step takes the flush lock on its
        own so client traffic interleaves."""
        if self.paused:
            return
        # overload ladder (server/overload.py): BROWNOUT-1 parks the
        # maintenance sweeps, the deferrable background device work the
        # ladder sheds first; the next GREEN tick resumes
        from ..server.overload import get_overload_controller

        if not get_overload_controller().maintenance_allowed():
            return
        if self.evict_idle_secs > 0 and self.extension is not None:
            now = time.monotonic()
            candidates = []
            # last_active is ordered oldest-first (touch() moves to the
            # end), so the scan is O(evictable + stale), not O(loaded):
            # it stops at the first still-fresh entry
            for name, seen in list(self.last_active.items()):
                if now - seen < self.evict_idle_secs:
                    break  # everything after this is fresher
                doc = self.plane.docs.get(name)
                if (
                    doc is None
                    or doc.retired
                    or name not in self.extension._docs
                ):
                    # stale policy entry (evicted / unloaded / degraded):
                    # drop it so the oldest-first prefix stays evictable
                    self.last_active.pop(name, None)
                    continue
                if name in self.plane.dirty:
                    continue  # un-broadcast records: let the window ship
                candidates.append(name)
                if len(candidates) >= self.evict_batch:
                    break
            for name in candidates:
                if self.paused:
                    return
                document = self.extension._docs.get(name)
                if document is not None:
                    # background-class admission: the eviction snapshot
                    # may drain pending ops through the serving path —
                    # a device dispatch like any other
                    ticket = await self._admit_background("evict")
                    if ticket is False:
                        return  # lane parked: retry next maintenance tick
                    try:
                        await self.evict(name, document)
                    finally:
                        if ticket is not None:
                            ticket.release()
        if self.compact_threshold > 0:
            await self._compact_sweep()
        # runs regardless of the threshold: retire-time log preservation
        # is gated only on the manager existing, so the reclaim pass
        # must be too (else a threshold-0 config leaks preserved logs)
        await self._visit_preserved()

    # -- eviction ------------------------------------------------------------

    async def evict(self, name: str, document) -> bool:
        """Snapshot an idle doc and free its arena rows. The doc keeps
        serving from the CPU path; hydration re-onboards it on its
        next edit (or load)."""
        plane = self.plane
        async with plane.flush_lock:
            if self.extension is not None and name not in self.extension._docs:
                return False
            doc = plane.docs.get(name)
            if doc is None or doc.retired:
                return False
            if self._has_unshipped(doc):
                return False  # let the broadcast window ship first
            t0 = time.perf_counter()
            loop = asyncio.get_event_loop()
            snapshot = await loop.run_in_executor(
                None, lambda: self._snapshot(name, document)
            )
            if snapshot is None:
                return False
            # the executor await yielded the event loop: a capture may
            # have claimed an update for plane broadcast in the window
            # (try_capture takes no lock). release() would discard its
            # queue entry and dirty mark — the op would never reach
            # peers. Re-validate in THIS synchronous block (no further
            # awaits before release), declining if anything landed.
            doc = plane.docs.get(name)
            if doc is None or doc.retired:
                return False
            if self.extension is not None and name not in self.extension._docs:
                return False
            if self._has_unshipped(doc):
                return False  # captured mid-snapshot: decline this round
            if self.extension is not None:
                self.extension._detach_serving(
                    name, self.extension._docs.pop(name, None)
                )
            elif self.serving is not None:
                self.serving.forget(name, doc)
            plane.release(name)
            self.last_active.pop(name, None)  # not resident: drop from the scan
            self._evicted_add(name, snapshot)
            # durability seam (storage/extension.py): the eviction
            # snapshot is a full-state update — folding it into the WAL
            # as a checkpoint record lets the log drop every earlier
            # segment (the snapshot subsumes them) without waiting for
            # the next debounced store. Idle docs are exactly the ones
            # whose WAL would otherwise pin its whole history.
            checkpoint = getattr(document, "wal_checkpoint", None)
            if checkpoint is not None:
                try:
                    checkpoint(snapshot)
                except Exception:
                    pass  # eviction must never fail on log upkeep
            plane.counters["docs_evicted"] += 1
            eviction_ms = round((time.perf_counter() - t0) * 1000.0, 3)
            get_flight_recorder().record(
                name, "evict", ms=eviction_ms, bytes=len(snapshot)
            )
            self._publish_stats(last_eviction_ms=eviction_ms)
        return True

    # -- hot-doc replica seams (edge/replica.py) ------------------------------

    def adopt_snapshot(self, name: str, snapshot: bytes) -> None:
        """Follower side: seed the evicted-record cache with the owner's
        snapshot, so the hydration drain warm-loads it exactly like a
        local eviction's re-entry (the live document's tail replayed on
        top keeps the round trip lossless)."""
        self._evicted_add(name, snapshot)

    def replica_snapshot(self, name: str, document) -> Optional[bytes]:
        """Owner side, cold follower: the eviction's full-state encode
        through the plane's serving path, WITHOUT evicting (the owner
        keeps its rows, write path and WAL). The CPU document answers
        where the plane does not hold the doc, and, counted in
        `cpu_fallbacks` as a joiner's would be, where the plane holds it
        but cannot serve it (behind, unhealthy, paused). On the card a
        failed serve raises (`_fault`)."""
        self.touch(name)
        payload = self._replica_serve("snapshot", name, document, None)
        if payload is not None:
            return payload
        try:
            from ..crdt import encode_state_as_update

            return encode_state_as_update(document)
        except Exception:
            return None

    def replica_catchup(
        self, name: str, document, sv_bytes: Optional[bytes]
    ) -> Optional[bytes]:
        """Owner side, warm follower resyncing after a gap: the SV-diff
        served from the plane, as a stale reconnect's SyncStep2. None
        where the plane does not serve it (the caller then diffs the CPU
        document); for a doc the plane holds, that None is counted in
        `cpu_fallbacks`. A failed serve goes to `_fault`: on the card it
        raises, on a CPU plane it declines with None."""
        self.touch(name)
        return self._replica_serve("catchup", name, document, sv_bytes)

    def _replica_serve(
        self, seam: str, name: str, document, sv_bytes: Optional[bytes]
    ) -> Optional[bytes]:
        """The plane's SyncStep2 for a replica seam, or None. Counts each
        plane serve in `replica_serves[seam]`, and each None for a doc
        the plane holds (attached to its serving seams) in the plane's
        `cpu_fallbacks`."""
        if self.serving is None:
            return None
        try:
            payload = self.serving.encode_state_as_update(name, document, sv_bytes)
        except Exception:
            self._fault()
            payload = None
        if payload is not None:
            self.replica_serves[seam] += 1
        elif self._holds(name):
            self.plane.counters["cpu_fallbacks"] += 1
        return payload

    def _holds(self, name: str) -> bool:
        """Whether the plane holds the doc: attached to the extension's
        serving seams (a sync source answers its joiners), or, without
        an extension, registered on the plane."""
        if self.extension is not None:
            return name in self.extension._docs
        return name in self.plane.docs

    def _snapshot(self, name: str, document) -> Optional[bytes]:
        """Encoded full state for the eviction record. The plane's own
        serving path first (healthy + covers the CPU doc, so the bytes
        are exactly a cold joiner's SyncStep2); the CPU document —
        always authoritative — when the plane can't serve."""
        if self.serving is not None:
            try:
                payload = self.serving.encode_state_as_update(name, document)
                if payload is not None:
                    return payload
            except Exception:
                self._fault()
        try:
            from ..crdt import encode_state_as_update

            return encode_state_as_update(document)
        except Exception:
            return None

    # -- hydration -----------------------------------------------------------

    def request_hydration(self, name: str, document=None) -> None:
        """Queue a doc for admission back onto the plane. Idempotent
        per name; the drain task starts lazily and exits when the
        queue empties."""
        if name in self._queued:
            return
        self._queued.add(name)
        self._queue.append((name, document, time.perf_counter()))
        # depth/peak only: the full stats snapshot computes latency
        # percentiles over a 4096-entry window, far too heavy for the
        # per-request path of a 1M-doc storm (the drain publishes the
        # full snapshot once per round)
        stats = self.plane.residency_stats
        depth = len(self._queue)
        stats["hydration_queue_depth"] = depth
        stats["hydration_queue_peak"] = max(
            stats.get("hydration_queue_peak", 0), depth
        )
        if not self._drain_running:
            self._drain_running = True
            self._spawn(self._drain_hydrations())

    async def _drain_hydrations(self) -> None:
        from .scheduler import CLASS_CATCHUP, LaneDeferred

        plane = self.plane
        try:
            while self._queue:
                if self.paused:
                    await asyncio.sleep(0.05)
                    continue
                ticket = None
                if self.lane is not None:
                    try:
                        # catch-up class: admitted per ROUND, so the
                        # lane re-arbitrates between rounds and an
                        # interactive flush never waits out the whole
                        # storm. Parked lane (breaker open): hold the
                        # queue and retry — admission control, lossless.
                        ticket = await self.lane.admit(
                            CLASS_CATCHUP, site="hydrate"
                        )
                    except LaneDeferred:
                        await asyncio.sleep(0.05)
                        continue
                batch = []
                while self._queue and len(batch) < self.hydrate_batch:
                    batch.append(self._queue.popleft())
                self.inflight = len(batch)
                self._publish_stats(last_hydration_batch=len(batch))
                admitted = 0
                try:
                    async with plane.flush_lock:
                        for i, (name, document, t_req) in enumerate(batch):
                            self._queued.discard(name)
                            try:
                                if self._hydrate_one_locked(name, document):
                                    admitted += 1
                            except Exception:
                                self._fault()
                                plane.counters["hydrations_declined"] += 1
                            self._hydration_latencies.append(
                                time.perf_counter() - t_req
                            )
                            if i % 8 == 7:
                                await asyncio.sleep(0)  # keep websockets pumping
                        if admitted:
                            # ONE device drain integrates the whole batch's
                            # snapshots (the flush's warm bucketed shapes)
                            loop = asyncio.get_event_loop()
                            await loop.run_in_executor(
                                None, lambda: plane.flush(None)
                            )
                            if self.serving is not None:
                                self.serving.refresh()
                finally:
                    if ticket is not None:
                        ticket.release()
                if admitted and self.extension is not None:
                    # the presync registration enqueues marked the docs
                    # dirty, and broadcast ticks are capture-driven: with
                    # no tick the mark would stick forever and (being an
                    # unshipped-window signal) pin the doc resident. The
                    # tick finds empty windows, advances the cursors and
                    # clears the marks.
                    self.extension._schedule_broadcast()
                self.inflight = 0
                self._publish_stats()
                # yield between rounds: broadcast/flush timers and new
                # captures run before the next admission wave
                await asyncio.sleep(0)
        finally:
            self._drain_running = False
            self.inflight = 0
            self._publish_stats()
            if self._queue:  # enqueued while we were exiting: resume
                self._drain_running = True
                self._spawn(self._drain_hydrations())

    def _hydrate_one_locked(self, name: str, document) -> bool:
        """Register + enqueue one doc (flush lock held; host work only
        — the batch flush integrates). Returns True when the doc was
        admitted onto the plane."""
        plane = self.plane
        extension = self.extension
        if extension is not None and name in extension._docs:
            self._evicted_pop(name)
            return False  # already served (raced a direct onboard)
        if name in plane.docs and not plane.docs[name].retired:
            self._evicted_pop(name)
            return False  # already registered
        if document is not None and hasattr(document, "get_connections_count"):
            if document.get_connections_count() <= 0 and extension is not None:
                return False  # unloading anyway; keep the snapshot
        if not plane.free:
            plane.counters["hydrations_declined"] += 1
            get_flight_recorder().record(name, "hydrate_declined", reason="plane_full")
            return False  # no rows: the doc stays on the CPU path
        record = self._evicted_pop(name)
        if name in plane.docs:
            plane.release(name)  # stale retired registration
        lane_doc = None
        if extension is not None and extension.native_lane:
            lane_doc = plane.register_lane(name)
        if lane_doc is None:
            plane.register(name)
        snapshot = record.snapshot if record is not None else None
        if snapshot is not None:
            plane.enqueue_update(name, snapshot, presync=True)
        if document is not None:
            # state-vector-diff replay: the lowerer's known-clock dedup
            # skips everything the stored snapshot already covered, so
            # only the post-eviction tail costs integration
            from ..crdt import encode_state_as_update

            plane.enqueue_update(
                name, encode_state_as_update(document), presync=True
            )
        doc = plane.docs.get(name)
        if doc is not None and doc.retired and doc.retire_reason == "lane_demote":
            # the snapshot holds rich content: retry on the Python path
            # in place (the ban set routes register_lane away next time)
            plane.release(name)
            plane.register(name)
            if snapshot is not None:
                plane.enqueue_update(name, snapshot, presync=True)
            if document is not None:
                from ..crdt import encode_state_as_update

                plane.enqueue_update(
                    name, encode_state_as_update(document), presync=True
                )
        if not plane.is_supported(name):
            return False  # retired during enqueue (counted there)
        plane.counters["docs_hydrated"] += 1
        get_flight_recorder().record(name, "hydrate")
        # re-enter the activity clock at admission: the pre-eviction
        # entry was dropped as stale, and without one the doc would be
        # invisible to the eviction scan until its next edit
        self.touch(name)
        if (
            extension is not None
            and extension.serve
            and document is not None
        ):
            extension._attach_serving(name, document)
        return True

    # -- compaction ----------------------------------------------------------

    _SWEEP_SLICE = 1024

    async def _compact_sweep(self) -> None:
        """Proactive pass: compact rows whose projected occupancy
        crossed the threshold before they overflow and retire. The scan
        walks a rotating slice of the doc registry per tick — bounded
        event-loop work at the 100k-doc design point, with the overflow
        retire + recycle rail as the backstop for rows that fill faster
        than the rotation comes around."""
        plane = self.plane
        threshold = self.compact_threshold * plane.capacity
        if not self._sweep_ring:
            self._sweep_ring = list(plane.docs.keys())
        names = []
        budget = min(len(self._sweep_ring), self._SWEEP_SLICE)
        while self._sweep_ring and budget > 0:
            budget -= 1
            name = self._sweep_ring.pop()
            doc = plane.docs.get(name)
            if doc is None or doc.retired or doc.lane_slot is not None:
                continue
            if name in self._compact_declined:
                continue
            occupancy = max(
                (plane.projected_len.get(s, 0) for s in doc.seqs.values()),
                default=0,
            )
            if occupancy < threshold:
                continue
            if occupancy <= self._compact_backoff.get(name, -1):
                continue  # declined at this size already: wait for growth
            names.append(name)
            if len(names) >= self.evict_batch:
                break
        for name in names:
            if self.paused:
                return
            ticket = await self._admit_background("compact_sweep")
            if ticket is False:
                return  # lane parked: retry next maintenance tick
            try:
                async with plane.flush_lock:
                    await self.compact_doc_locked(
                        name, min_reclaim=max(plane.capacity // 8, 1)
                    )
            finally:
                if ticket is not None:
                    ticket.release()

    async def _admit_background(self, site: str):
        """One background-class lane admission (compaction/GC sweeps):
        None when unarbitrated, False when the lane is parked — the
        sweep stops and the next maintenance tick retries."""
        if self.lane is None:
            return None
        from .scheduler import CLASS_BACKGROUND, LaneDeferred

        try:
            return await self.lane.admit(CLASS_BACKGROUND, site=site)
        except LaneDeferred:
            return False

    async def _visit_preserved(self) -> None:
        """Proactive pass over log-preserving retires (note_preserved):
        the post-flush health sweep retires with no recycle seam, so
        without this an idle overflow-retired doc holds its largest-
        possible serve/unit logs and retained queues until its next
        edit. Compact each back onto the plane or drop the logs when
        the attempt declines."""
        plane = self.plane
        extension = self.extension
        if extension is None:
            return  # standalone harnesses drive compact_doc_locked directly
        instance = getattr(extension, "_instance", None)
        for name in list(self._preserved):
            if self.paused:
                return
            # the retire's CPU fallback already dropped the doc from
            # extension._docs — the LOADED registry is the instance's
            # (a preserved doc is by definition not plane-served)
            document = (
                instance.documents.get(name) if instance is not None else None
            )
            ticket = await self._admit_background("compact_preserved")
            if ticket is False:
                return  # lane parked: retry next maintenance tick
            try:
                async with plane.flush_lock:
                    doc = plane.docs.get(name)
                    if doc is None or not doc.retired:
                        self._preserved.discard(name)
                        continue
                    if document is None:
                        # not loaded (mid-unload): just free the host memory
                        plane.drop_doc_logs(name)
                        self._preserved.discard(name)
                        continue
                    await self.compact_and_replay_locked(name, document)
            finally:
                if ticket is not None:
                    ticket.release()

    async def compact_and_replay_locked(self, name: str, document) -> bool:
        """The recycle rail, shared by the retire-seam recycle
        (`TpuMergeExtension._maybe_recycle`) and the preserved-doc
        sweep: compact `name` in place, replay the live document tail
        the plane missed while retired (known-clock dedup keeps it to
        the gap), re-attach serving. Caller holds the flush lock.
        Returns True when the doc ended up plane-served; on False the
        caller may fall back to the snapshot recycle."""
        plane = self.plane
        extension = self.extension
        try:
            ok = await self.compact_doc_locked(name)
        except Exception:
            self._fault()
            ok = False
        if not ok:
            if name in self._preserved:
                # declined before the sticky bookkeeping (e.g. empty
                # seqs): the preserved logs still need dropping
                plane.drop_doc_logs(name)
                self._preserved.discard(name)
            return False
        if document is not None:
            from ..crdt import encode_state_as_update

            plane.enqueue_update(
                name, encode_state_as_update(document), presync=True
            )
        if plane.is_supported(name):
            if (
                extension is not None
                and extension.serve
                and document is not None
            ):
                extension._attach_serving(name, document)
                extension._schedule_flush()
                # the replay's presync enqueue marked the doc dirty, and
                # broadcast ticks are capture-driven: a compaction after
                # the doc's last edit would otherwise keep the mark, and
                # with it the doc resident, for good (as in hydration)
                extension._schedule_broadcast()
            return True
        # the tail re-exhausted the row: stop the preserve/compact
        # ping-pong until a full (re-registering) recycle
        self._compact_declined.add(name)
        self._preserved.discard(name)
        plane.drop_doc_logs(name)
        return False

    async def compact_doc_locked(self, name: str, min_reclaim: int = 1) -> bool:
        """Rewrite a doc's rows via the on-device compact kernel.

        Caller holds the flush lock. Returns True when the rows were
        compacted (and, for a capacity/overflow-retired doc, the doc
        was un-retired so it serves from the plane again). Declines —
        nothing reclaimable, live state too big, shapes the rebuild
        can't express — leave the doc exactly as it was.
        """
        plane = self.plane
        doc = plane.docs.get(name)
        if doc is None or doc.lane_slot is not None or not doc.seqs:
            return False
        if name in self._compact_declined:
            return False
        if doc.retired and doc.retire_reason not in ("capacity", "overflow"):
            return False
        if not doc.retired:
            # live-doc (proactive) compaction must not race the capture
            # seam. Decline transiently — no sticky _compact_declined —
            # while there are un-broadcast records (the rebuild replaces
            # the serve log and jumps the cursor, which would drop them
            # from fan-out) or queued device ops (lowered before the
            # rewrite, so their origins would miss the remap).
            if self._has_unshipped(doc):
                return False
            if any(plane.queues.get(s) for s in doc.seqs.values()):
                return False
        t0 = time.perf_counter()
        was_live = not doc.retired
        fn = (
            self._compact_rle_locked
            if plane.arena == "rle"
            else self._compact_unit_locked
        )
        # the device work runs off the event loop (the step lock and the
        # readbacks must never freeze the server).
        # Retired docs can't be mutated under us: every plane entry
        # point for them either no-ops or needs the flush lock we hold.
        # Live docs CAN be captured mid-window — try_capture (lock-free
        # by design) consults is_compacting and routes those updates to
        # the CPU fan-out instead; the tail replay below re-syncs the
        # plane (known-clock dedup keeps it to exactly the window).
        loop = asyncio.get_event_loop()
        if was_live:
            self._compacting.add(name)
        try:
            ok = await loop.run_in_executor(None, lambda: fn(doc, min_reclaim))
        finally:
            self._compacting.discard(name)
        if not ok:
            plane.counters["compactions_declined"] += 1
            if doc.retired:
                # the preserved logs are dropped, so no retry can ever
                # succeed: sticky until the doc re-registers
                self._compact_declined.add(name)
                self._preserved.discard(name)
                plane.drop_doc_logs(name)  # finish the deferred retire
            else:
                # nothing (or not enough) to reclaim YET: back off until
                # the row grows past this occupancy instead of poisoning
                # the retire-time preservation/recycle path
                self._compact_backoff[name] = max(
                    (plane.projected_len.get(s, 0) for s in doc.seqs.values()),
                    default=0,
                )
            return False
        self._preserved.discard(name)
        self._compact_backoff.pop(name, None)
        if doc.retired:
            doc.retired = False
            doc.retire_reason = None
            doc.lowerer.unsupported = False
        if self.serving is not None:
            self.serving.forget(name, doc)
            self.serving.broadcast_cursor[name] = len(doc.serve_log)
        plane.counters["docs_compacted"] += 1
        get_flight_recorder().record(name, "compact", live=was_live)
        if was_live and self.extension is not None:
            document = self.extension._docs.get(name)
            if document is not None:
                # updates captured-to-CPU during the executor window
                # (is_compacting routed them off the plane); known-clock
                # dedup keeps this to exactly the window. AFTER the
                # cursor jump above: these are presync records, and a
                # tail that re-overflows the row must retire it for
                # real, not be un-retired by the block above.
                from ..crdt import encode_state_as_update

                plane.enqueue_update(
                    name, encode_state_as_update(document), presync=True
                )
                self.extension._schedule_flush()
                # the replay marked the doc dirty: a tick clears the mark
                # (see compact_and_replay_locked)
                self.extension._schedule_broadcast()
        self._publish_stats(
            last_compaction_ms=round((time.perf_counter() - t0) * 1000.0, 3)
        )
        return True

    def _compact_step(self, slots: "list[int]"):
        """Run the arena's compaction program over `slots`, padded to a
        power-of-two routing width with the num_docs sentinel (the gather
        clips it, the scatter drops it), so the launch shapes stay few.
        Returns the packed per-slot sizes. Caller holds the step lock
        with the plane's device current."""
        plane = self.plane
        width = 1
        while width < len(slots):
            width *= 2
        routed = list(slots) + [plane.num_docs] * (width - len(slots))
        plane.state, sizes = plane._compact_step_fn()(
            plane.state, torch.tensor(routed, dtype=torch.int32, device=plane.device)
        )
        plane._note_dispatch("compact")
        # tombstone GC remapped ranks: the host-tracked rank tails of these
        # rows are stale, and the run-merge classifier must not fast-path
        # against them until the next flush readback re-arms them
        plane.invalidate_tails(slots)
        return sizes.cpu().numpy()[: len(slots)]

    def _own_health_caches(self) -> None:
        """Compaction patches the plane's last readback in place so the
        next health compare sees the rewritten rows: give the plane copies
        of its own first, so the caches serving adopted from that readback
        stay as they were (serving re-adopts at its next refresh)."""
        plane = self.plane
        if plane.last_lengths is not None:
            plane.last_lengths = plane.last_lengths.copy()
        if plane.last_overflows is not None:
            plane.last_overflows = plane.last_overflows.copy()

    def _rebind_slot(self, slot: int) -> None:
        """Post-compaction bookkeeping: new binding generation with the
        health caches kept consistent so the very next compare sees
        the rewritten row, not the previous layout."""
        plane = self.plane
        plane.slot_gen[slot] += 1
        plane.slot_live[slot] = True
        if plane.last_gen is not None:
            plane.last_gen[slot] = plane.slot_gen[slot]
        plane.flush_epoch += 1

    def _compact_unit_locked(self, doc: PlaneDoc, min_reclaim: int) -> bool:
        """Unit-arena tombstone GC for every row of `doc` (executor
        thread; takes the step lock). Plan first — any row that can't
        compact declines the whole doc with the device untouched."""
        plane = self.plane
        slots = sorted(set(doc.seqs.values()))
        with plane._step_lock, plane.device_scope():
            if any(plane.queues.get(s) for s in slots):
                # retained queues (see retire_doc's preserve mode) must
                # reach the rows first: the rebuild below treats the
                # ARENA as the proven content, and anything logged but
                # undelivered would otherwise vanish from the doc
                plane.flush()
            state = plane.state
            idx = torch.as_tensor(slots, dtype=torch.long, device=plane.device)
            # one readback of the rows and their lengths
            fused = torch.stack(
                [
                    state.id_client[idx],
                    state.id_clock[idx],
                    state.rank[idx],
                    state.deleted[idx].to(torch.int32),
                ]
            ).cpu().numpy()
            lengths = state.length[idx].cpu().numpy()
            plans = []
            reclaimed = 0
            limit = plane.capacity * 3 // 4
            for i, slot in enumerate(slots):
                n = int(lengths[i])
                clients = fused[0, i][:n].view(np.uint32)
                clocks = fused[1, i][:n]
                ranks = fused[2, i][:n]
                deleted = fused[3, i][:n].astype(bool)
                log = plane.unit_logs.get(slot)
                if log is None or len(log) != n:
                    return False  # log/arena desync: not rebuildable
                live = int(n - deleted.sum())
                if live > limit:
                    return False  # live state has no headroom: no point
                # plain-text rows only: rich payloads (Content objects)
                # and live NUL markers can't be re-run-length-encoded
                # from the log alone — such docs take the snapshot
                # recycle path instead
                for j in range(n):
                    if not deleted[j] and (
                        not isinstance(log[j], int) or log[j] == 0
                    ):
                        return False
                order = np.argsort(ranks, kind="stable")
                reclaimed += n - live
                plans.append((slot, order, clients, clocks, deleted, log))
            if reclaimed < min_reclaim:
                return False
            if not self._rebuild_decodable(doc, plans):
                return False
            expected = [
                len(p[5]) - int(p[4].sum()) for p in plans
            ]  # per-slot live counts
            sizes = self._compact_step(slots)
            if [int(s) for s in sizes] != expected:
                raise RuntimeError(
                    f"compact kernel size mismatch for {doc.name!r}: "
                    f"{sizes.tolist()} != {expected}"
                )
            self._rebuild_unit_doc(doc, plans)
            self._own_health_caches()
            for (slot, *_rest), live in zip(plans, expected):
                plane.dispatched_units[slot] = live
                plane.validated_units[slot] = live
                plane.projected_len[slot] = live
                if plane.last_lengths is not None:
                    plane.last_lengths[slot] = live
                    plane.last_overflows[slot] = False
                self._rebind_slot(slot)
        return True

    @staticmethod
    def _rebuild_decodable(doc: PlaneDoc, plans: list) -> bool:
        """Whether the serve log `_rebuild_unit_doc` would write for
        `plans` decodes. A decoder integrates each client's structs in
        clock order, and a struct only after its origins; the rebuild
        names each live run's rank predecessor as its left origin, which
        can close a cycle (a run whose predecessor is a later clock of
        its own client, or a chain of such through other clients). This
        walks the decoder's order over the new structs: the live runs,
        and the retained host records with their own origins and parents.
        Removed ranges and GC records depend on nothing, and an id that
        no struct holds counts as there."""
        structs: dict[int, list] = {}
        for _slot, order, clients, clocks, deleted, _log in plans:
            packed = [j for j in order if not deleted[j]]
            prev = None
            pos = 0
            while pos < len(packed):
                c0, k0 = int(clients[packed[pos]]), int(clocks[packed[pos]])
                run = 1
                while (
                    pos + run < len(packed)
                    and int(clients[packed[pos + run]]) == c0
                    and int(clocks[packed[pos + run]]) == k0 + run
                ):
                    run += 1
                structs.setdefault(c0, []).append(
                    (k0, [] if prev is None else [prev])
                )
                prev = (c0, k0 + run - 1)
                pos += run
        for rec in doc.serve_log:
            op = rec.op
            if rec.slot is not None or op.gc:
                continue
            deps = []
            if op.left_client != NONE_CLIENT:
                deps.append((op.left_client, op.left_clock))
            if op.right_client != NONE_CLIENT:
                deps.append((op.right_client, op.right_clock))
            if op.parent is not None and op.parent[0] == "item":
                deps.append((op.parent[1], op.parent[2]))
            structs.setdefault(op.client, []).append((op.clock, deps))
        for entries in structs.values():
            entries.sort(key=lambda entry: entry[0])
        done = dict.fromkeys(structs, 0)  # each client's next struct

        def there(dep) -> bool:
            entries = structs.get(dep[0])
            if entries is None:
                return True
            i = done[dep[0]]
            return i >= len(entries) or dep[1] < entries[i][0]

        moved = True
        while moved:
            moved = False
            for client, entries in structs.items():
                while done[client] < len(entries) and all(
                    there(dep) for dep in entries[done[client]][1]
                ):
                    done[client] += 1
                    moved = True
        return all(done[c] == len(entries) for c, entries in structs.items())

    def _rebuild_unit_doc(self, doc: PlaneDoc, plans: list) -> None:
        """Rebuild the doc's host mirrors around the packed rows:
        permuted unit logs, a fresh presync serve log (live runs with
        predecessor-chained origins + GC records for removed ranges),
        host-side delete ranges covering the removed ids (stale
        clients still holding them live must learn the deletions), and
        the origin remap future ops resolve removed origins through."""
        plane = self.plane
        # host-only records survive: map items, map tombstone deletes,
        # previously-collected GC ranges
        retained = [rec for rec in doc.serve_log if rec.slot is None]
        new_log = list(retained)
        removed_ranges: list[tuple[int, int, int]] = []
        seq_ranges: list[tuple] = []  # (client, start, len, seq_key)
        for slot, order, clients, clocks, deleted, log in plans:
            seq_key = next(k for k, s in doc.seqs.items() if s == slot)
            packed: list[int] = []  # old arena indices of live units, in order
            prev_live: Optional[tuple[int, int]] = None
            pending: Optional[list] = None  # [client, clock0, len, left_id]
            # removed groups whose RIGHT live neighbor hasn't appeared
            # yet (several groups can sit between two live units)
            waiting: list[list] = []
            remap_rows: list[tuple] = []
            for j in order:
                cid, ck = int(clients[j]), int(clocks[j])
                if deleted[j]:
                    if (
                        pending is not None
                        and pending[0] == cid
                        and pending[1] + pending[2] == ck
                    ):
                        pending[2] += 1
                    else:
                        if pending is not None:
                            waiting.append(pending)
                        pending = [cid, ck, 1, prev_live]
                    continue
                if pending is not None:
                    waiting.append(pending)
                    pending = None
                for group in waiting:
                    remap_rows.append(
                        (group[0], group[1], group[2], group[3], (cid, ck))
                    )
                    removed_ranges.append((group[0], group[1], group[2]))
                    seq_ranges.append((group[0], group[1], group[2], seq_key))
                waiting.clear()
                prev_live = (cid, ck)
                packed.append(j)
            if pending is not None:
                waiting.append(pending)
            for group in waiting:
                remap_rows.append((group[0], group[1], group[2], group[3], None))
                removed_ranges.append((group[0], group[1], group[2]))
                seq_ranges.append((group[0], group[1], group[2], seq_key))
            # permuted payload log: new arena slot j holds the unit the
            # packed order placed there (append-only resumes after it)
            plane.unit_logs[slot] = [log[j] for j in packed]
            # serve-log insert records: maximal id-consecutive runs in
            # packed order, predecessor-chained — exactly the layout the
            # device kernel produced
            pos = 0
            while pos < len(packed):
                c0 = int(clients[packed[pos]])
                k0 = int(clocks[packed[pos]])
                run = 1
                while (
                    pos + run < len(packed)
                    and int(clients[packed[pos + run]]) == c0
                    and int(clocks[packed[pos + run]]) == k0 + run
                ):
                    run += 1
                seq_ranges.append((c0, k0, run, seq_key))
                if pos == 0:
                    left = (NONE_CLIENT, 0)
                    parent = seq_key
                else:
                    left = (
                        int(clients[packed[pos - 1]]),
                        int(clocks[packed[pos - 1]]),
                    )
                    parent = None
                new_log.append(
                    LogRec(
                        op=DenseOp(
                            kind=KIND_INSERT,
                            client=c0,
                            clock=k0,
                            run_len=run,
                            left_client=left[0],
                            left_clock=left[1],
                            parent=parent,
                            presync=True,
                        ),
                        slot=slot,
                        unit_off=pos,
                    )
                )
                pos += run
            # future ops referencing removed ids re-anchor here
            remap = doc.origin_remap
            for client, clock0, length, left_id, right_id in remap_rows:
                starts, rows = remap.setdefault(client, ([], []))
                at = bisect_right(starts, clock0)
                starts.insert(at, clock0)
                rows.insert(at, (clock0, clock0 + length, left_id, right_id))
        # removed ids, clock-merged per client: GC records tell cold
        # joiners the ranges existed; host tombstones keep them in every
        # served delete set so stale clients tombstone their live copies
        removed_ranges.sort()
        merged: list[list[int]] = []
        for c, k, l in removed_ranges:
            if merged and merged[-1][0] == c and merged[-1][1] + merged[-1][2] == k:
                merged[-1][2] += l
            else:
                merged.append([c, k, l])
        for c, k, l in merged:
            new_log.append(
                LogRec(
                    op=DenseOp(
                        kind=KIND_INSERT, client=c, clock=k, run_len=l,
                        gc=True, presync=True,
                    ),
                    slot=None,
                )
            )
            doc.map_tombstones.append((c, k, l))
        doc.serve_log = new_log
        if doc.retired:
            # a capacity retire can leave the lowerer AHEAD of the
            # device (the triggering update bumped its known clocks but
            # its ops were discarded); rebuild it from the proven
            # content so the live-tail replay re-lowers the gap instead
            # of dedup-ing real ops into holes
            self._rebuild_lowerer(doc, seq_ranges, retained)

    def _rebuild_lowerer(self, doc: PlaneDoc, seq_ranges: list, retained: list) -> None:
        """Fresh DocLowerer whose known clocks and id routes reflect
        exactly the doc's PROVEN content: the arena's id ranges (live
        AND tombstoned/removed — `seq_ranges` as (client, start, len,
        seq_key)) plus the retained host-only records (map items, GC
        ranges). Removed ranges keep their *sequence* routes, not GC
        routes: future origins referencing them must still resolve to
        the right row (the enqueue-time remap then re-anchors the
        device-level origin). Pending structs/deletes carry over —
        they re-check readiness against the rebuilt clocks."""
        from .lowering import DocLowerer

        lowerer = DocLowerer()
        routes: list[tuple] = [
            (client, start, length, ("seq", seq_key))
            for client, start, length, seq_key in seq_ranges
        ]
        for rec in retained:
            op = rec.op
            if op.kind != KIND_INSERT:
                continue  # map tombstone deletes carry no new ids
            if op.gc:
                routes.append((op.client, op.clock, op.run_len, ("gc",)))
            elif op.parent_sub is not None:
                routes.append(
                    (op.client, op.clock, op.run_len,
                     ("map", op.parent, op.parent_sub))
                )
        routes.sort(key=lambda r: (r[0], r[1]))
        for client, start, length, route in routes:
            lowerer._record_route(client, start, length, route)
            end = start + length
            if end > lowerer.known.get(client, 0):
                lowerer.known[client] = end
        lowerer.pending = list(doc.lowerer.pending)
        lowerer.pending_deletes = list(doc.lowerer.pending_deletes)
        doc.lowerer = lowerer

    def _compact_rle_locked(self, doc: PlaneDoc, min_reclaim: int) -> bool:
        """RLE defragmentation for every row of `doc` (executor thread;
        takes the step lock). Id-preserving: no host log rewrite, no
        origin remap — only entry-count accounting changes."""
        plane = self.plane
        slots = sorted(set(doc.seqs.values()))
        with plane._step_lock, plane.device_scope():
            if any(plane.queues.get(s) for s in slots):
                plane.flush()  # deliver retained queues first (see unit path)
            state = plane.state
            idx = torch.as_tensor(slots, dtype=torch.long, device=plane.device)
            fused = torch.stack(
                [
                    state.run_client[idx],
                    state.run_clock[idx],
                    state.run_len[idx],
                    state.run_rank[idx],
                    state.run_deleted[idx].to(torch.int32),
                ]
            ).cpu().numpy()
            num_runs = state.num_runs[idx].cpu().numpy()
            expected = []
            seq_ranges: list[tuple] = []  # (client, start, len, seq_key)
            reclaimed = 0
            limit = plane.capacity * 3 // 4
            for i, slot in enumerate(slots):
                seq_key = next(k for k, s in doc.seqs.items() if s == slot)
                n = int(num_runs[i])
                cl = fused[0, i][:n].view(np.uint32)
                ck = fused[1, i][:n]
                ln = fused[2, i][:n]
                rk = fused[3, i][:n]
                dl = fused[4, i][:n].astype(bool)
                keep = ln > 0
                order = np.argsort(np.where(keep, rk, np.iinfo(np.int32).max))
                kept = keep[order]
                cl, ck, ln, rk, dl = (
                    cl[order], ck[order], ln[order], rk[order], dl[order],
                )
                heads = 0
                for j in range(n):
                    if not kept[j]:
                        continue
                    seq_ranges.append(
                        (int(cl[j]), int(ck[j]), int(ln[j]), seq_key)
                    )
                    if (
                        j > 0
                        and kept[j - 1]
                        and cl[j] == cl[j - 1]
                        and int(ck[j]) == int(ck[j - 1]) + int(ln[j - 1])
                        and int(rk[j]) == int(rk[j - 1]) + int(ln[j - 1])
                        and bool(dl[j]) == bool(dl[j - 1])
                    ):
                        continue  # merges into the previous entry
                    heads += 1
                if heads > limit:
                    return False  # defragmented state has no headroom
                expected.append(heads)
                reclaimed += n - heads
            if reclaimed < min_reclaim:
                return False
            sizes = self._compact_step(slots)
            if [int(s) for s in sizes] != expected:
                raise RuntimeError(
                    f"RLE compact size mismatch for {doc.name!r}: "
                    f"{sizes.tolist()} != {expected}"
                )
            if doc.retired:
                # see _rebuild_unit_doc: a capacity retire leaves the
                # lowerer ahead of the device — rebuild it from the
                # arena's (id-preserving) run ranges + host records
                retained = [rec for rec in doc.serve_log if rec.slot is None]
                self._rebuild_lowerer(doc, seq_ranges, retained)
            self._own_health_caches()
            for slot, heads in zip(slots, expected):
                plane.projected_len[slot] = heads
                if plane.last_overflows is not None:
                    plane.last_overflows[slot] = False
                self._rebind_slot(slot)
        return True
