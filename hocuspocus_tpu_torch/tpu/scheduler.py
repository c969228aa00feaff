"""Adaptive merge scheduling: the device-lane arbiter + batching governor.

Batch size and dispatch order follow measured arrival rate and latency
budget, not wall-clock timers (serving-systems practice: continuous
batching under an SLO; Eg-walker's minimal-work-per-merge,
arXiv:2409.14252). This module is that scheduling layer, in three parts:

1. **`DeviceLane`** — the admission arbiter every device client of a
   plane passes through before dispatching: flush cycles and batched
   sync serves (interactive), hydration rounds and capacity recycles
   (catch-up), eviction snapshots and compaction sweeps (background),
   the supervisor's canary probes and the listen-time warm grid
   (canary, the lowest). One holder at a time (one card); waiters are
   granted strictly by priority class, FIFO within a class (a canary
   passes queued warm shapes by its lower weight). The warm grid admits
   once per shape, so an early client flush waits for one shape at
   most, never for the grid. A starvation guard promotes a waiter that
   has queued past `promote_after_s` (250 ms) to the interactive class,
   so background work and the supervisor's canary progress under a
   sustained interactive load. The supervisor parks the lane when its
   breaker opens (`pause()`: queued and new admissions defer, only
   pause-exempt canary probes pass) and resumes it at re-attach.

2. **`BatchGovernor`** — arrival-aware batching: an EWMA of op-arrival
   rate plus the measured per-cycle device time pick the flush cadence
   and per-cycle batch count dynamically. Past the queue-depth watermark
   the tick collapses to an immediate full drain; when arrivals are
   sparse the tick stretches (up to `max_stretch`x — cheap, because
   broadcasts build from the HOST serve logs and never wait on the
   device flush); when the lane is congested batch growth is capped at
   one kernel call per admission so higher-priority work goes between
   batches. An idle plane parks its timer entirely (the flush timer is
   enqueue-driven and stops rescheduling at empty queues; the governor
   counts the parks).

3. **Cross-plane warm sharing** — the kernel libraries load once per
   process and the C entries cache their launch setup per device, so N
   planes of one geometry on one device warming the same (k, b) grid
   would pay N identical no-op launch sweeps for one real warm-up.
   `shared_warm_filter` is the module-level registry of already-warmed
   (backend, device, arena, num_docs, capacity, (k, b)) keys: the first
   plane's warm pass launches, every other plane skips the covered
   shapes (seeding its warm watch).

A port of the JAX package's `tpu/scheduler.py`: the lane keeps its
four priority classes (numbered as there), FIFO grants, the starvation
guard, park and resume, queue-wait deadline and accounting, and there
is one lane per device index (`get_device_lane(i)`, one per merge cell
of tpu/cells.py). What only several planes sharing one lane use is not
ported (ROADMAP.md, Queue A item 7b): holder preemption and a promotion
threshold set per extension. The warm registry's backend name is read
from torch instead of jax.
"""

from __future__ import annotations

import asyncio
import math
import time
from typing import Optional

from ..observability.flight_recorder import get_flight_recorder
from ..observability.metrics import Counter, Gauge, Histogram

# -- priority classes --------------------------------------------------------
# Lower value = higher priority. Interactive flushes and sync serves go
# first; catch-up (hydration, recycles) outranks background (eviction,
# compaction); canary probes and warm launches ride last: a probe's job
# is to measure the device the real traffic sees, not to displace it.

CLASS_INTERACTIVE = 0
CLASS_CATCHUP = 1
CLASS_BACKGROUND = 2
CLASS_CANARY = 3

CLASS_NAMES = ("interactive", "catchup", "background", "canary")

# lane-wait buckets: sub-millisecond grants are the common case; parked
# background work can wait whole seconds behind an interactive burst
_WAIT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


class LaneDeferred(Exception):
    """Admission declined: the lane is parked (supervisor pause) or the
    waiter's queue-wait deadline passed. Carries the class, the wait and
    the reason ("parked" or "deadline") so the caller can record a
    `flush_deferred` flight event and reschedule."""

    def __init__(self, lane_class: int, waited_s: float, reason: str = "deadline") -> None:
        super().__init__(f"{CLASS_NAMES[lane_class]} deferred ({reason})")
        self.lane_class = lane_class
        self.waited_s = waited_s
        self.reason = reason


class LaneTicket:
    """One granted (or queued) admission. Always release() in finally."""

    __slots__ = (
        "lane", "lane_class", "effective_class", "promoted", "site", "ignore_pause",
        "weight", "enqueued_at", "granted_at", "seq", "future",
    )

    def __init__(
        self, lane: "DeviceLane", lane_class: int, site: str, seq: int,
        ignore_pause: bool = False, weight: int = 0,
    ) -> None:
        self.lane = lane
        self.lane_class = lane_class
        # the class the grant order uses: the starvation guard raises it
        self.effective_class = lane_class
        self.promoted = False
        self.site = site
        self.ignore_pause = ignore_pause
        # tie-break within a class (lower first): canary probes pass
        # queued warm shapes so the watchdog's latency stays timely
        self.weight = weight
        self.enqueued_at = time.monotonic()
        self.granted_at: Optional[float] = None
        self.seq = seq
        self.future: Optional[asyncio.Future] = None

    def release(self) -> None:
        self.lane._release(self)


class DeviceLane:
    """Priority-class admission arbiter for one device (capacity 1).

    Process-global by default (`get_device_lane()`): every device client
    in the process contends for the same card, so they share one
    arbiter. Construct instances directly for tests that need isolation.
    """

    def __init__(self, promote_after_s: float = 0.25) -> None:
        # a waiter queued longer than this is promoted to the interactive
        # class (the starvation guard)
        self.promote_after_s = float(promote_after_s)
        self.paused = False
        self._holder: Optional[LaneTicket] = None
        self._waiters: list[LaneTicket] = []
        self._seq = 0
        self._created_at = time.monotonic()
        self._busy_s = 0.0
        # accounting (snapshot() + the metric objects below)
        self.counters: dict[str, int] = {
            "admissions": 0,
            "deferrals": 0,
            "starved_promotions": 0,
            "dispatches_in_lane": 0,
            "dispatches_bypass": 0,
        }
        self.class_admissions = [0] * len(CLASS_NAMES)
        self.class_wait_s = [0.0] * len(CLASS_NAMES)
        self.class_wait_max_s = [0.0] * len(CLASS_NAMES)
        # exposition objects (adopted by the Metrics registry via
        # metrics(), like the wire-telemetry collector)
        self.wait_seconds = Histogram(
            "hocuspocus_tpu_lane_wait_seconds",
            "Device-lane queue wait before admission, by priority class",
            buckets=_WAIT_BUCKETS,
        )
        self.admissions_total = Counter(
            "hocuspocus_tpu_lane_admissions_total",
            "Device-lane admissions granted, by priority class",
        )
        self.deferrals_total = Counter(
            "hocuspocus_tpu_lane_deferrals_total",
            "Admissions deferred (lane parked or deadline passed), by class",
        )
        self.queue_depth = Gauge(
            "hocuspocus_tpu_lane_queue_depth",
            "Waiters queued for the device lane, by priority class",
        )
        self.occupancy = Gauge(
            "hocuspocus_tpu_lane_occupancy",
            "Fraction of wall time the device lane was held since start",
            fn=self._occupancy_fraction,
        )
        # overload control plane (server/overload.py): queued lane
        # waiters feed the ladder's lane_depth signal (weakly held —
        # test lanes fall out on their own). Lazy import: the scheduler
        # must stay importable without the server stack resident.
        try:
            from ..server.overload import get_overload_controller

            get_overload_controller().register_lane(self)
        except Exception:
            pass

    # -- admission -----------------------------------------------------------

    def metrics(self) -> tuple:
        return (
            self.wait_seconds, self.admissions_total, self.deferrals_total,
            self.queue_depth, self.occupancy,
        )

    def contended(self) -> bool:
        return bool(self._waiters)

    def holder_info(self) -> "Optional[tuple[str, int, float]]":
        """(site, class, held seconds) of the active holder, None when
        idle: lets the supervisor's watchdog tell a lane busy with the
        accounted warm grid from one held by a wedged flush."""
        holder = self._holder
        if holder is None:
            return None
        held = 0.0 if holder.granted_at is None else time.monotonic() - holder.granted_at
        return (holder.site, holder.lane_class, held)

    def queue_depths(self) -> "list[int]":
        depths = [0] * len(CLASS_NAMES)
        for waiter in self._waiters:
            depths[waiter.lane_class] += 1
        return depths

    async def admit(
        self,
        lane_class: int,
        site: str = "",
        ignore_pause: bool = False,
        deadline_s: Optional[float] = None,
        weight: int = 0,
    ) -> LaneTicket:
        """Wait for the device lane; returns the held ticket.

        Raises `LaneDeferred` at once when the lane is parked and the
        admission is not pause-exempt (`ignore_pause`), or after
        `deadline_s` of queue wait: the caller records the deferral and
        reschedules (or, for the teardown drain, goes on without the
        lane) rather than pile blocked tasks onto a wedged device.
        """
        if self.paused and not ignore_pause:
            self._defer(lane_class)
            raise LaneDeferred(lane_class, 0.0, "parked")
        self._seq += 1
        ticket = LaneTicket(self, lane_class, site, self._seq, ignore_pause, weight)
        if self._holder is None and not self._waiters:
            self._grant(ticket)
            return ticket
        ticket.future = asyncio.get_event_loop().create_future()
        self._waiters.append(ticket)
        self._refresh_depth_gauge()
        # the holder may have released between our check and the append
        # (same-task reentrancy cannot happen, but release() from a
        # completed executor callback can): re-run the grant scan
        self._grant_next()
        try:
            if deadline_s is None:
                await ticket.future
            else:
                await asyncio.wait_for(asyncio.shield(ticket.future), deadline_s)
        except asyncio.TimeoutError:
            waited = time.monotonic() - ticket.enqueued_at
            if ticket.granted_at is not None:
                # granted in the same tick the deadline fired: keep it
                return ticket
            self._discard(ticket)
            self._defer(lane_class)
            raise LaneDeferred(lane_class, waited, "deadline") from None
        except LaneDeferred:
            raise  # parked while queued (pause() removed the waiter)
        except asyncio.CancelledError:
            if ticket.granted_at is not None:
                # granted and cancelled in the same tick: hand the lane on
                self._release(ticket)
            else:
                self._discard(ticket)
            raise
        return ticket

    def _grant(self, ticket: LaneTicket) -> None:
        now = time.monotonic()
        waited = now - ticket.enqueued_at
        ticket.granted_at = now
        self._holder = ticket
        self.counters["admissions"] += 1
        self.class_admissions[ticket.lane_class] += 1
        self.class_wait_s[ticket.lane_class] += waited
        if waited > self.class_wait_max_s[ticket.lane_class]:
            self.class_wait_max_s[ticket.lane_class] = waited
        cls = CLASS_NAMES[ticket.lane_class]
        self.wait_seconds.observe(waited, **{"class": cls})
        self.admissions_total.inc(**{"class": cls})

    def _release(self, ticket: LaneTicket) -> None:
        if self._holder is not ticket:
            return  # already released (idempotent: finally-blocks double up)
        if ticket.granted_at is not None:
            self._busy_s += time.monotonic() - ticket.granted_at
        self._holder = None
        self._grant_next()

    def _grant_next(self) -> None:
        if self._holder is not None or not self._waiters:
            return
        now = time.monotonic()
        # starvation guard: promote aged waiters before picking
        for waiter in self._waiters:
            if (
                not waiter.promoted
                and waiter.effective_class > CLASS_INTERACTIVE
                and now - waiter.enqueued_at > self.promote_after_s
            ):
                waiter.promoted = True
                waiter.effective_class = CLASS_INTERACTIVE
                self.counters["starved_promotions"] += 1
                get_flight_recorder().record(
                    "__plane__",
                    "lane_starved_promoted",
                    lane_class=CLASS_NAMES[waiter.lane_class],
                    wait_ms=round((now - waiter.enqueued_at) * 1000.0, 3),
                )
        eligible = [w for w in self._waiters if not self.paused or w.ignore_pause]
        if not eligible:
            return
        best = min(eligible, key=lambda w: (w.effective_class, w.weight, w.seq))
        self._waiters.remove(best)
        self._refresh_depth_gauge()
        self._grant(best)
        if best.future is not None and not best.future.done():
            best.future.set_result(None)

    def _discard(self, ticket: LaneTicket) -> None:
        try:
            self._waiters.remove(ticket)
        except ValueError:
            pass
        self._refresh_depth_gauge()

    def _defer(self, lane_class: int) -> None:
        self.counters["deferrals"] += 1
        self.deferrals_total.inc(**{"class": CLASS_NAMES[lane_class]})

    # -- park / resume (the supervisor's seam) -------------------------------

    def pause(self) -> None:
        """Park the lane (breaker open): queued waiters that are not
        pause-exempt defer at once, so their tasks reschedule instead of
        stacking onto a wedged device, and new admissions defer at the
        door. The active holder is untouched (its launch is already
        queued; it releases on its own)."""
        if self.paused:
            return
        self.paused = True
        for waiter in list(self._waiters):
            if waiter.ignore_pause:
                continue
            self._waiters.remove(waiter)
            waited = time.monotonic() - waiter.enqueued_at
            self._defer(waiter.lane_class)
            if waiter.future is not None and not waiter.future.done():
                waiter.future.set_exception(LaneDeferred(waiter.lane_class, waited, "parked"))
        self._refresh_depth_gauge()

    def resume(self) -> None:
        if not self.paused:
            return
        self.paused = False
        self._grant_next()

    def _refresh_depth_gauge(self) -> None:
        depths = self.queue_depths()
        for i, name in enumerate(CLASS_NAMES):
            self.queue_depth.set(depths[i], **{"class": name})

    # -- dispatch accounting -------------------------------------------------

    def note_dispatch(self, site: str, batches: int = 1) -> None:
        """Called by the plane at every device dispatch site (flush
        cycle, warm launch, canary, compaction, sync triage). A dispatch
        while no ticket is
        held bypassed the arbiter — counted, and pinned to zero by the
        warm-grid test for the extension's scheduled paths."""
        if self._holder is not None:
            self.counters["dispatches_in_lane"] += batches
        else:
            self.counters["dispatches_bypass"] += batches

    def _occupancy_fraction(self) -> float:
        wall = time.monotonic() - self._created_at
        busy = self._busy_s
        if self._holder is not None and self._holder.granted_at is not None:
            busy += time.monotonic() - self._holder.granted_at
        return round(busy / wall, 6) if wall > 0 else 0.0

    def snapshot(self) -> dict:
        """JSON-able state for /debug/scheduler."""
        depths = self.queue_depths()
        per_class = {}
        for i, name in enumerate(CLASS_NAMES):
            admits = self.class_admissions[i]
            per_class[name] = {
                "queued": depths[i],
                "admissions": admits,
                "wait_ms_mean": (
                    round(self.class_wait_s[i] / admits * 1000.0, 3)
                    if admits
                    else 0.0
                ),
                "wait_ms_max": round(self.class_wait_max_s[i] * 1000.0, 3),
            }
        return {
            "held": self._holder is not None,
            "paused": self.paused,
            "promote_after_ms": round(self.promote_after_s * 1000.0, 3),
            "holder_class": (
                None
                if self._holder is None
                else CLASS_NAMES[self._holder.lane_class]
            ),
            "occupancy": self._occupancy_fraction(),
            "classes": per_class,
            "counters": dict(self.counters),
        }


_default_lanes: "dict[int, DeviceLane]" = {}


def get_device_lane(device_index: int = 0) -> DeviceLane:
    """The process-global arbiter for one device cell.

    One `DeviceLane` per device index, not per process: a single-plane
    deployment calls this with no argument (index 0), while the
    multi-device cell plane (tpu/cells.py) passes each cell's index, so
    N cells are N independent dispatch queues. Clients of the same cell
    (its plane, residency and canaries) share that cell's lane."""
    lane = _default_lanes.get(device_index)
    if lane is None:
        lane = _default_lanes[device_index] = DeviceLane()
    return lane


def reset_device_lane() -> None:
    """Drop the global lanes (tests): the next get builds fresh ones."""
    _default_lanes.clear()


# -- arrival-aware batching governor -----------------------------------------


class BatchGovernor:
    """Per-plane flush cadence + batch-count policy from measured load.

    Replaces the fixed `flush_interval_ms` timer with three regimes,
    decided at schedule time from the op-arrival EWMA, the queue depth
    and the lane's congestion signal:

    - **drain**: queue depth at/past `drain_watermark` — flush NOW
      (zero delay) and let the cycle run unbounded batches (unless the
      lane is congested, where one batch per admission lets waiting
      interactive work in between).
    - **steady**: arrivals fast enough that a base tick collects at
      least ~one op — keep the configured base cadence.
    - **sparse**: arrivals slower than one per tick — stretch the tick
      (up to `max_stretch`x base) so dispatches amortize; free for the
      edit->observe path because broadcasts build from host serve logs
      and never wait on the device flush (docs/guides/tpu-merge-
      pipeline.md).

    The governor never changes WHAT is flushed — only when and in how
    many kernel calls — so governor-on/off doc state is byte-identical
    (pinned by the differential fuzz in tests/tpu/test_scheduler.py).
    """

    def __init__(
        self,
        base_interval_ms: float = 5.0,
        max_stretch: float = 4.0,
        drain_watermark: int = 256,
        target_batch_ops: int = 32,
        halflife_s: float = 0.5,
    ) -> None:
        self.base_s = max(base_interval_ms, 0.01) / 1000.0
        self.max_stretch = max(float(max_stretch), 1.0)
        self.drain_watermark = max(int(drain_watermark), 1)
        self.target_batch_ops = max(int(target_batch_ops), 1)
        self.halflife_s = max(float(halflife_s), 0.01)
        self._rate = 0.0  # ops/s EWMA
        self._last_arrival: Optional[float] = None
        self.device_ms_ewma = 0.0  # per-batch device time
        self.counters: dict[str, int] = {
            "drains": 0,
            "stretches": 0,
            "steady_ticks": 0,
            "congested_ticks": 0,
            "congestion_caps": 0,
            "parks": 0,
        }
        self.last_delay_s = self.base_s

    # -- inputs --------------------------------------------------------------

    def note_arrival(self, ops: int, now: Optional[float] = None) -> None:
        if ops <= 0:
            return
        now = time.monotonic() if now is None else now
        if self._last_arrival is None:
            self._rate = float(ops) / self.halflife_s
        else:
            dt = max(now - self._last_arrival, 1e-6)
            inst = float(ops) / dt
            alpha = 1.0 - math.exp(-dt / self.halflife_s)
            self._rate += alpha * (inst - self._rate)
        self._last_arrival = now

    def arrival_rate(self, now: Optional[float] = None) -> float:
        """Decayed ops/s: silence since the last arrival discounts the
        EWMA, so a burst that stopped doesn't keep the tick short."""
        if self._last_arrival is None:
            return 0.0
        now = time.monotonic() if now is None else now
        idle = max(now - self._last_arrival, 0.0)
        return self._rate * math.exp(-idle / self.halflife_s)

    def note_cycle(self, flush_stats: dict) -> None:
        """Fold one completed flush cycle's measured device time into
        the per-batch EWMA (feeds max_batches' burst cap). Empty cycles
        are skipped — flush_stats only updates when batches ran, so
        folding it again would just re-count the last real cycle."""
        batches = int(flush_stats.get("batches", 0))
        if batches <= 0:
            return
        device_ms = (
            float(flush_stats.get("dispatch_ms", 0.0))
            + float(flush_stats.get("device_sync_ms", 0.0))
        ) / batches
        self.device_ms_ewma += 0.25 * (device_ms - self.device_ms_ewma)

    def note_park(self) -> None:
        """The plane went idle (empty queues, timer not rescheduled)."""
        self.counters["parks"] += 1

    # -- policy --------------------------------------------------------------

    def flush_delay_s(self, pending_ops: int, congested: bool = False) -> float:
        if congested:
            # congestion outranks the watermark: queued lane clients
            # (hydration rounds, compaction) are about to drain their
            # own backlog — an eager interactive tick would only do
            # their work at interactive priority and deepen the queue
            # it then waits in
            self.counters["congested_ticks"] += 1
            self.last_delay_s = self.base_s
            return self.base_s
        if pending_ops >= self.drain_watermark:
            self.counters["drains"] += 1
            self.last_delay_s = 0.0
            return 0.0
        rate = self.arrival_rate()
        expected = rate * self.base_s  # ops a base tick would collect
        if expected >= 1.0:
            self.counters["steady_ticks"] += 1
            self.last_delay_s = self.base_s
            return self.base_s
        if expected <= 0.0:
            # first op after idle: full stretch — nothing else is
            # coming, and the broadcast path doesn't wait on this tick
            delay = self.base_s * self.max_stretch
        else:
            # stretch toward one-op-per-tick, capped at max_stretch
            delay = min(self.base_s / expected, self.base_s * self.max_stretch)
        if delay > self.base_s:
            self.counters["stretches"] += 1
        else:
            self.counters["steady_ticks"] += 1
        self.last_delay_s = delay
        return delay

    def max_batches(
        self, pending_ops: int, congested: bool = False
    ) -> Optional[int]:
        """Kernel calls the cycle may run under one lane admission.

        Always BOUNDED: past the watermark the cycle takes a burst of
        batches and reschedules at zero delay — an unbounded inline
        drain would run the whole background backlog at interactive
        priority inside one lane hold (the exact head-of-line blocking
        the arbiter exists to prevent)."""
        if congested:
            # one batch per admission: the lane re-arbitrates between
            # microbatches, so waiting interactive work preempts here
            self.counters["congestion_caps"] += 1
            return 1
        if pending_ops >= self.drain_watermark:
            return self._burst_cap(8)
        if pending_ops > self.target_batch_ops * 4:
            return self._burst_cap(4)
        return 1

    def _burst_cap(self, ceiling: int) -> int:
        """Burst size bounded by MEASURED device time: the batches of
        one admission should fit roughly one base interval of device
        work, so a slow backend stays preemptible between admissions
        while a fast one drains in fewer lane round-trips."""
        if self.device_ms_ewma <= 0.0:
            return ceiling
        budget_ms = self.base_s * 1000.0
        return max(1, min(ceiling, int(budget_ms / self.device_ms_ewma)))

    def snapshot(self) -> dict:
        return {
            "base_interval_ms": round(self.base_s * 1000.0, 3),
            "max_stretch": self.max_stretch,
            "drain_watermark": self.drain_watermark,
            "arrival_rate_ops_s": round(self.arrival_rate(), 3),
            "device_ms_ewma": round(self.device_ms_ewma, 3),
            "last_delay_ms": round(self.last_delay_s * 1000.0, 3),
            "counters": dict(self.counters),
        }


# -- cross-plane warm sharing -------------------------------------------------
# Kernel libraries are process-wide and the C entries keep their launch
# setup per device, so identical (device, arena geometry, batch shape)
# keys warm exactly once per process. This registry records which keys a
# warm pass has already covered so planes 2..N skip the redundant no-op
# launch sweeps at boot.

_warmed_keys: "set[tuple]" = set()


def _backend_name() -> str:
    """The torch backend this process launches on: the card's name when
    CUDA is available, else "cpu"."""
    try:
        import torch

        if torch.cuda.is_available():
            return f"cuda:{torch.cuda.get_device_name(0)}"
        return "cpu"
    except Exception:
        return "unknown"


def warm_key(
    arena: str, num_docs: int, capacity: int, shape, device: str = ""
) -> tuple:
    """`device` is the plane's device: the launch setup is cached per
    device, so a shape warmed on one card is not warm on another."""
    return (_backend_name(), device, arena, num_docs, capacity, tuple(shape))


def shared_warm_filter(
    arena: str,
    num_docs: int,
    capacity: int,
    shapes: "list[tuple]",
    device: str = "",
) -> "tuple[list[tuple], list[tuple]]":
    """Split `shapes` into (to_launch, covered) against the registry.
    The caller launches the first list and marks its warm watch covered
    for the second."""
    to_compile: "list[tuple]" = []
    covered: "list[tuple]" = []
    for shape in shapes:
        key = warm_key(arena, num_docs, capacity, shape, device)
        if key in _warmed_keys:
            covered.append(shape)
        else:
            to_compile.append(shape)
    return to_compile, covered


def note_warmed(
    arena: str, num_docs: int, capacity: int, shape, device: str = ""
) -> None:
    _warmed_keys.add(warm_key(arena, num_docs, capacity, shape, device))


def reset_warm_registry() -> None:
    """Tests: make every plane warm from scratch again."""
    _warmed_keys.clear()
