"""Plane supervisor: the merge plane's device lifecycle, supervised.

The port of the JAX package's `tpu/supervisor.py`, for one plane and for
the multi-device cell plane (tpu/cells.py). The supervisor owns the
runtime's lifecycle, and the plane is an accelerator the server may
acquire, never a boot dependency: the server boots and serves from the
CPU documents whatever the card does, and the plane attaches when it is
ready.

Three mechanisms:

1. **Deadline-bounded init.** The runtime factory (the CUDA context, the
   plane's arena, the g++ build of the native codec, the nvcc build of
   the arena's kernel) runs in a daemon worker thread. If it has not
   returned within `init_timeout`, the server serves from the CPU
   documents (DEGRADED); should the factory complete later, the plane
   **hot-attaches** and live documents are re-onboarded from their CPU
   state as a load does. A factory that raises leaves a CPU plane BROKEN
   (terminal; the server keeps serving from the CPU documents).

2. **Watchdog and circuit breaker.** While READY, a canary merge (one
   no-op integrate through K1/K2 and a data-dependent readback,
   `MergePlane.canary_probe`) runs every `watchdog_interval` seconds
   with a deadline. Consecutive failures or overruns trip the breaker
   (closed -> open): serving pauses, pending batched syncs resolve to the
   CPU documents (`PlaneServing.abort_pending`), the device lane parks,
   and served documents degrade to the CPU documents with a full-state
   broadcast each (logged at error, counted in `cpu_fallbacks`). The
   breaker half-opens on the same interval; a passing canary closes it
   and the plane hot re-attaches. On the card only overruns count: a
   canary that raises stops the server (see below). A runtime with
   `cells` gets one breaker per cell instead: each cell's canary admits
   through that cell's own lane, a late cell trips its own breaker and
   only its docs go to the CPU documents (`degrade_cell`), and a passing
   half-open probe restores it (`restore_cell`); the supervisor stays
   READY while any cell serves.

3. **State surface.** `state` (INITIALIZING / READY / DEGRADED /
   BROKEN), transition counters, breaker state and canary latency, in
   `snapshot()`, which `Hocuspocus.get_health()` and the `/healthz`
   route served by `SupervisedTpuMergeExtension.on_request` report:
   `degraded: True` whenever the plane is not serving.

The breaker degrades to the CPU documents, never to the plain PyTorch
kernels, and the supervisor never builds a CPU plane in place of the
card's: `SupervisedTpuMergeExtension` without `device` raises at
construction when CUDA is absent. On the card the CPU documents stand
in only for a plane that is late (init past its deadline, canaries past
theirs). An error raised by the card runtime's init, attach,
re-onboarding or canary (a kernel that does not build or launch) stops
serving instead (`_fail_stop`): the supervisor goes BROKEN with the error
in `fault`, every connection is closed and new ones are refused with it,
and the task that met it ends with it. Only a CPU plane degrades to the
CPU documents on such an error, as the JAX package's supervisor does.
The same holds per cell: on the card an error raised by a cell's canary
or by its restore's re-onboarding stops the whole server, since cells
wrapped onto one card share its CUDA context and a sticky CUDA error
poisons every cell on it; only a late cell degrades alone. A CPU cell
degrades alone on a raised error too. The sharded runtime is not ported
yet (ROADMAP.md, Queue A item 7b).

This module imports no kernel module at import time: everything that
touches the device happens inside the factory, in the worker thread,
under the init deadline.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, Callable, Optional

from ..aio import spawn_tracked
from ..observability.flight_recorder import get_flight_recorder
from ..observability.tracing import get_tracer
from ..server import logger as _logger_mod
from ..server.types import Extension, Payload

# -- supervisor states -------------------------------------------------------

STATE_INITIALIZING = "initializing"  # runtime factory still running, in budget
STATE_READY = "ready"  # plane attached and serving
STATE_DEGRADED = "degraded"  # CPU-merge fallback (init overdue / breaker open)
STATE_BROKEN = "broken"  # init failed, or a card fault stopped serving

# numeric codes for the Prometheus gauge (stable, documented in the guide)
STATE_CODES = {
    STATE_INITIALIZING: 0,
    STATE_READY: 1,
    STATE_DEGRADED: 2,
    STATE_BROKEN: 3,
}

# -- circuit breaker ---------------------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

BREAKER_CODES = {BREAKER_CLOSED: 0, BREAKER_OPEN: 1, BREAKER_HALF_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker over the watchdog's canary verdicts.

    closed --[threshold consecutive failures]--> open
    open   --[next probe window]--------------> half_open
    half_open --[probe passes]----------------> closed
    half_open --[probe fails]-----------------> open
    """

    def __init__(self, threshold: int = 3) -> None:
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = threshold
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.transitions: dict[str, int] = {}
        # observers appended by the Metrics extension (labels: from/to)
        self.on_transition: list[Callable[[str, str], Any]] = []

    def _move(self, to: str) -> None:
        if self.state == to:
            return
        frm, self.state = self.state, to
        key = f"{frm}->{to}"
        self.transitions[key] = self.transitions.get(key, 0) + 1
        for fn in list(self.on_transition):
            try:
                fn(frm, to)
            except Exception:
                pass

    def record_success(self) -> bool:
        """A canary passed. Returns True when this CLOSED an open/half-
        open breaker (i.e. the plane just recovered)."""
        self.consecutive_failures = 0
        if self.state in (BREAKER_OPEN, BREAKER_HALF_OPEN):
            self._move(BREAKER_CLOSED)
            return True
        return False

    def record_failure(self) -> bool:
        """A canary failed/overran. Returns True when this failure
        TRIPPED the breaker closed→open (the caller must degrade)."""
        self.consecutive_failures += 1
        if self.state == BREAKER_HALF_OPEN:
            self._move(BREAKER_OPEN)  # recovery probe failed: stay degraded
            return False
        if self.state == BREAKER_CLOSED and self.consecutive_failures >= self.threshold:
            self._move(BREAKER_OPEN)
            return True
        return False

    def try_half_open(self) -> bool:
        if self.state == BREAKER_OPEN:
            self._move(BREAKER_HALF_OPEN)
            return True
        return self.state == BREAKER_HALF_OPEN


def _runtime_lanes(runtime) -> list:
    """Every device lane a runtime admits through: the multi-device cell
    plane exposes `lanes()` (one arbiter per cell), a single plane
    `lane`."""
    if runtime is None:
        return []
    lanes_fn = getattr(runtime, "lanes", None)
    if callable(lanes_fn):
        try:
            return [lane for lane in lanes_fn() if lane is not None]
        except Exception:
            return []
    lane = getattr(runtime, "lane", None)
    return [lane] if lane is not None else []


# -- the supervisor ----------------------------------------------------------


class PlaneSupervisor:
    """Owns the plane's device lifecycle for one server instance.

    `factory` is a zero-arg callable building the runtime extension
    (`TpuMergeExtension`); it runs in a worker thread and may block or
    raise freely: the supervisor turns a block into states that keep the
    server serving instead of a hung boot. `on_card` says the factory
    builds a card plane, so that an init error stops serving
    (`_fail_stop`); after attach the runtime's planes say it themselves.

    The runtime must expose `planes()`, `servings()`, `reonboard(document,
    instance)`, `degrade_all()`, `cancel_timers()`, `is_served(name)` and
    the ordinary lifecycle hooks.
    """

    def __init__(
        self,
        factory: Callable[[], Any],
        *,
        init_timeout: float = 30.0,
        watchdog_interval: float = 5.0,
        breaker_threshold: int = 3,
        canary_deadline: Optional[float] = None,
        on_card: bool = False,
    ) -> None:
        self.factory = factory
        self.on_card = on_card
        # the card runtime's error that stopped serving (_fail_stop)
        self.fault: Optional[BaseException] = None
        self.init_timeout = float(init_timeout)
        self.watchdog_interval = float(watchdog_interval)
        # a canary slower than the probe cadence IS a wedge signal
        self.canary_deadline = float(
            canary_deadline if canary_deadline is not None else max(watchdog_interval, 0.05)
        )
        self.breaker = CircuitBreaker(breaker_threshold)
        self.state = STATE_INITIALIZING
        self.runtime: Optional[Any] = None
        self.counters: dict[str, int] = {
            "init_timeouts": 0,
            "init_failures": 0,
            "canary_probes": 0,
            "canary_failures": 0,
            "canary_errors": 0,
            "canary_busy_skips": 0,
            "degrades": 0,
            "attaches": 0,
            "card_faults": 0,
        }
        self.transitions: dict[str, int] = {}
        self.last_canary_latency: Optional[float] = None
        self.init_started_at: Optional[float] = None
        self.init_elapsed: Optional[float] = None
        # observers appended by the Metrics extension: each state
        # transition (from, to), each passing canary's latency (seconds)
        # and each runtime the supervisor adopts
        self.on_transition: list[Callable[[str, str], Any]] = []
        self.on_canary: list[Callable[[float], Any]] = []
        self.on_attach: list[Callable[[Any], Any]] = []
        self._instance = None
        self._started = False
        self._stopped = False
        self._tasks: set = set()
        self._init_thread: Optional[threading.Thread] = None
        self._init_result: Optional[tuple] = None  # (runtime, error)
        self._init_done: Optional[asyncio.Event] = None
        self._canary_future = None
        # admission state of the outstanding probe: {"granted": bool}.
        # A probe still QUEUED behind the device lane's warm-grid
        # holder is a busy lane, not a sick device — see _canary.
        self._canary_admission: Optional[dict] = None
        # per-cell breaker scope (tpu/cells.py): when the runtime exposes
        # `cells`, the watchdog probes each cell through its own lane and
        # keeps one breaker per cell. Sized at the first probe.
        self.cell_breakers: "list[CircuitBreaker]" = []
        self.cell_states: "list[str]" = []
        self._cell_probes: "dict[int, tuple]" = {}  # index -> (future, admission)

    # -- lifecycle -----------------------------------------------------------

    def start(self, instance) -> None:
        """Begin supervision (idempotent). Called at listen time: the
        init thread starts NOW and the server keeps booting."""
        if self._started:
            return
        self._started = True
        self._instance = instance
        self.init_started_at = time.perf_counter()
        loop = asyncio.get_event_loop()
        self._init_done = asyncio.Event()

        def init_worker() -> None:
            try:
                result = (self.factory(), None)
            except BaseException as error:  # noqa: BLE001 — surfaced as BROKEN
                result = (None, error)
            self._init_result = result
            try:
                loop.call_soon_threadsafe(self._init_done.set)
            except RuntimeError:
                pass  # loop already closed (shutdown during init)

        self._init_thread = threading.Thread(
            target=init_worker, name="tpu-plane-init", daemon=True
        )
        self._init_thread.start()
        self._spawn(self._await_init())
        self._spawn(self._watchdog())

    def _spawn(self, coro) -> None:
        spawn_tracked(self._tasks, coro)

    async def stop(self) -> None:
        """Stop supervision; tear down the runtime when it is safe.

        A wedged device holds the flush/step locks forever — forwarding
        the runtime's full-drain on_destroy there would hang shutdown,
        so a non-READY teardown only cancels timers."""
        if self._stopped:
            return
        self._stopped = True
        for task in list(self._tasks):
            task.cancel()
        thread = self._init_thread
        if thread is not None and thread.is_alive():
            # the init worker is a daemon thread inside torch's C++: a
            # process that exits under it aborts ("terminate called
            # without an active exception"), so teardown waits for it, at
            # most the init deadline (a wedged device still cannot hang it)
            deadline = time.monotonic() + self.init_timeout
            while thread.is_alive() and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
        runtime = self.runtime
        if runtime is None:
            return
        # never leave a (possibly process-global) lane parked behind:
        # the next deployment in this process must admit freely
        for lane in _runtime_lanes(runtime):
            lane.resume()
        if self.state == STATE_READY:
            try:
                await runtime.on_destroy(Payload(instance=self._instance))
            except Exception:
                _logger_mod.log_error("plane runtime teardown failed (continuing)")
        else:
            try:
                runtime.cancel_timers()
            except Exception:
                pass

    # -- init ----------------------------------------------------------------

    async def _await_init(self) -> None:
        assert self._init_done is not None
        try:
            await asyncio.wait_for(
                asyncio.shield(self._init_done.wait()), self.init_timeout
            )
        except asyncio.TimeoutError:
            self.counters["init_timeouts"] += 1
            self._set_state(STATE_DEGRADED)
            _logger_mod.log_error(
                f"plane init exceeded {self.init_timeout:.1f}s; serving from the "
                "CPU documents (the plane hot-attaches if init completes)"
            )
            # keep waiting: a late init still hot-attaches
            await self._init_done.wait()
        if self._stopped:
            return
        assert self._init_result is not None
        runtime, error = self._init_result
        self.init_elapsed = (
            None
            if self.init_started_at is None
            else time.perf_counter() - self.init_started_at
        )
        if error is not None:
            self.counters["init_failures"] += 1
            if self.on_card:
                self._fail_stop("init", error)
                raise error
            self._set_state(STATE_BROKEN)
            _logger_mod.log_error(
                f"plane init failed ({error!r}); serving from the CPU documents "
                "for good"
            )
            return
        try:
            await self._attach(runtime)
        except asyncio.CancelledError:
            raise
        except Exception as attach_error:
            self.counters["init_failures"] += 1
            if self._card():
                if self.fault is None:  # a re-onboard may have stopped it
                    self._fail_stop("attach", attach_error)
                raise
            # a CPU runtime exists but adoption died: treat like a
            # breaker-open degrade — the watchdog's half-open probes
            # retry from here
            self._set_state(STATE_DEGRADED)
            self.breaker._move(BREAKER_OPEN)
            _logger_mod.log_error(
                f"plane attach failed ({attach_error!r}); serving from the CPU "
                "documents (the watchdog probes for recovery)"
            )

    async def _attach(self, runtime) -> None:
        """Adopt a freshly built runtime and onboard live documents."""
        if self._stopped:
            return
        self.runtime = runtime
        for fn in list(self.on_attach):
            try:
                fn(runtime)
            except Exception:
                pass
        try:
            # the runtime's own listen-time warm grid
            await runtime.on_listen(Payload(instance=self._instance))
        except Exception:
            _logger_mod.log_error("plane warmup kickoff failed (continuing)")
        await self._reattach()

    async def _reattach(self) -> None:
        """READY transition + re-onboarding of every live document.

        READY is set FIRST so documents finishing their load during the
        sweep take the normal forwarded after_load path; the sweep then
        covers everything loaded before, skipping docs already served.
        """
        runtime, instance = self.runtime, self._instance
        if runtime is None:
            return
        for lane in _runtime_lanes(runtime):
            # un-park the device lane(s) BEFORE serving resumes: the
            # first re-onboard flushes need admissions to flow again
            lane.resume()
        for serving in runtime.servings():
            serving.paused = False
        self.counters["attaches"] += 1
        self._set_state(STATE_READY)
        if instance is None:
            return
        # drop registrations whose document is gone (degrade-window
        # leftovers): a stale entry would alias a future load
        for plane in runtime.planes():
            stale = [name for name in plane.docs if name not in instance.documents]
            if stale:
                async with plane.flush_lock:
                    for name in stale:
                        plane.release(name)
        for name, document in list(instance.documents.items()):
            if self._stopped or self.state != STATE_READY:
                return
            if runtime.is_served(name):
                continue  # raced a concurrent load: already onboarded
            try:
                await runtime.reonboard(document, instance)
            except Exception as error:
                if self._card():
                    self._fail_stop("re-onboard", error)
                    raise
                _logger_mod.log_error(
                    f"plane re-onboard failed for {name!r}; doc stays on the CPU path"
                )

    # -- watchdog ------------------------------------------------------------

    async def _watchdog(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.watchdog_interval)
            if self._stopped:
                return
            runtime = self.runtime
            if runtime is not None and getattr(runtime, "cells", None):
                # the cell plane: per-cell probes and breakers while any
                # cell is attached (READY: some cells serve; DEGRADED:
                # every cell is open, and half-open probes still flow)
                if self.state in (STATE_READY, STATE_DEGRADED):
                    await self._watchdog_cells(runtime)
                continue
            if self.state == STATE_READY:
                ok, _latency = await self._canary()
                if ok:
                    self.breaker.record_success()
                elif ok is False and self.breaker.record_failure():
                    self._trip()
                # ok is None: lane busy with accounted warm work — no
                # verdict either way, probe again next tick
            elif (
                self.state == STATE_DEGRADED
                and self.runtime is not None
                and self.breaker.state in (BREAKER_OPEN, BREAKER_HALF_OPEN)
            ):
                # half-open recovery probe
                self.breaker.try_half_open()
                ok, _latency = await self._canary()
                if ok:
                    self.breaker.record_success()
                    _logger_mod.logger.info(
                        "plane recovered; hot re-attaching served documents"
                    )
                    await self._reattach()
                elif ok is False:
                    self.breaker.record_failure()

    async def _canary(self) -> "tuple[Optional[bool], Optional[float]]":
        """One deadline-bounded canary merge across every plane.

        At most ONE probe thread is outstanding: a wedged probe blocks
        on the device (or the step lock a wedged flush holds), and
        every tick it stays unfinished counts as a deadline overrun
        instead of stacking another blocked thread.

        Verdicts: True = pass, False = failure/overrun, None = no
        verdict — the probe is still QUEUED behind the device lane's
        warm-grid holder (tpu/scheduler.py). A lane busy with the warm
        grid (the first launch of each shape may build the kernel) is bounded, accounted work, not a sick device;
        counting those ticks as failures would false-trip the breaker
        at every boot whose warm pass outlasts two probe windows. A
        wedged FLUSH holding the lane still fails the tick — only the
        "warmup" holder site earns the skip.
        """
        runtime = self.runtime
        if runtime is None:
            return False, None
        self.counters["canary_probes"] += 1
        if self._canary_future is not None and not self._canary_future.done():
            if self._lane_busy_with_warmup():
                self.counters["canary_busy_skips"] += 1
                return None, None
            self.counters["canary_failures"] += 1
            return False, None

        loop = asyncio.get_event_loop()

        async def probe_all() -> float:
            # flush_lock per plane: a canary must not interleave with a
            # slot release rebuilding device state (release() relies on
            # the flush lock for that), and a wedged flush HOLDING the
            # lock forever is precisely a deadline overrun. The device
            # step itself runs off the loop like every other step.
            # The sweep admits through the device lane at the lowest
            # class — a probe measures the device the real traffic
            # sees, it never displaces that traffic — but pause-exempt:
            # half-open recovery probes must reach a parked lane.
            ticket = None
            lane = getattr(runtime, "lane", None)
            if lane is not None:
                from .scheduler import CLASS_CANARY

                ticket = await lane.admit(
                    CLASS_CANARY, site="canary", ignore_pause=True
                )
            admission["granted"] = True
            # the latency clock starts at GRANT: the deadline bounds the
            # DEVICE's responsiveness, not the queue wait the busy-skip
            # above already accounts for
            started = time.perf_counter()
            try:
                for plane in runtime.planes():
                    async with plane.flush_lock:
                        await loop.run_in_executor(None, plane.canary_probe)
            finally:
                if ticket is not None:
                    ticket.release()
            return time.perf_counter() - started

        admission = {"granted": getattr(runtime, "lane", None) is None}
        self._canary_admission = admission
        future = asyncio.ensure_future(probe_all())
        # consume a late error so an abandoned probe never warns
        future.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None
        )
        self._canary_future = future
        tracer = get_tracer()
        try:
            latency = await asyncio.wait_for(
                asyncio.shield(future), self.canary_deadline
            )
        except asyncio.TimeoutError:
            if self._lane_busy_with_warmup():
                self.counters["canary_busy_skips"] += 1
                tracer.event(
                    "supervisor.canary_busy", deadline_s=self.canary_deadline
                )
                return None, None
            self.counters["canary_failures"] += 1
            tracer.event(
                "supervisor.canary_overrun", deadline_s=self.canary_deadline
            )
            return False, None
        except Exception as error:
            self.counters["canary_errors"] += 1
            tracer.event("supervisor.canary_error", error=repr(error))
            if self._card():
                self._fail_stop("canary", error)
                raise
            self.counters["canary_failures"] += 1
            return False, None
        self.last_canary_latency = latency
        for fn in list(self.on_canary):
            try:
                fn(latency)
            except Exception:
                pass
        return True, latency

    # -- per-cell watchdog (the multi-device cell plane, tpu/cells.py) --------

    def _ensure_cell_scope(self, runtime) -> None:
        cells = runtime.cells
        while len(self.cell_breakers) < len(cells):
            self.cell_breakers.append(CircuitBreaker(self.breaker.threshold))
            self.cell_states.append(STATE_READY)

    async def _watchdog_cells(self, runtime) -> None:
        """One watchdog tick over every cell: a ready cell runs a canary
        feeding its own breaker (a trip degrades that cell: its docs go
        to the CPU documents, its lane parks, placement routes around
        it); a degraded cell runs half-open recovery probes and is
        restored on a pass. The supervisor's state reflects the cells:
        READY while any cell serves, DEGRADED when every cell is out."""
        self._ensure_cell_scope(runtime)
        for index, cell in enumerate(runtime.cells):
            if self._stopped:
                return
            breaker = self.cell_breakers[index]
            if self.cell_states[index] == STATE_READY:
                ok, _latency = await self._canary_cell(index, cell)
                if ok:
                    breaker.record_success()
                elif ok is False and breaker.record_failure():
                    self._trip_cell(runtime, index)
            elif breaker.state in (BREAKER_OPEN, BREAKER_HALF_OPEN):
                breaker.try_half_open()
                ok, _latency = await self._canary_cell(index, cell)
                if ok:
                    breaker.record_success()
                    await self._restore_cell(runtime, index)
                elif ok is False:
                    breaker.record_failure()
        ready = [state == STATE_READY for state in self.cell_states]
        if any(ready) and self.state != STATE_READY:
            self._set_state(STATE_READY)
        elif not any(ready) and self.state == STATE_READY:
            self._set_state(STATE_DEGRADED)

    async def _canary_cell(self, index: int, cell) -> "tuple[Optional[bool], Optional[float]]":
        """One deadline-bounded canary for one cell's plane, admitted
        through that cell's own lane, with the global canary's single
        outstanding probe tracked per cell: a wedged cell holds one
        blocked probe, and every tick it stays unfinished is an overrun
        for that cell alone. On the card a probe that raises stops the
        server (`_fail_stop`); on a CPU cell it is a failure."""
        self.counters["canary_probes"] += 1
        outstanding = self._cell_probes.get(index)
        if outstanding is not None and not outstanding[0].done():
            if self._cell_lane_busy_with_warmup(cell, outstanding[1]):
                self.counters["canary_busy_skips"] += 1
                return None, None
            self.counters["canary_failures"] += 1
            return False, None

        loop = asyncio.get_event_loop()
        admission = {"granted": cell.lane is None}

        async def probe() -> float:
            ticket = None
            if cell.lane is not None:
                from .scheduler import CLASS_CANARY

                ticket = await cell.lane.admit(CLASS_CANARY, site="canary", ignore_pause=True)
            admission["granted"] = True
            started = time.perf_counter()
            try:
                async with cell.plane.flush_lock:
                    # canary_probe makes the cell's device current itself
                    await loop.run_in_executor(None, cell.plane.canary_probe)
            finally:
                if ticket is not None:
                    ticket.release()
            return time.perf_counter() - started

        future = asyncio.ensure_future(probe())
        future.add_done_callback(lambda f: f.exception() if not f.cancelled() else None)
        self._cell_probes[index] = (future, admission)
        tracer = get_tracer()
        try:
            latency = await asyncio.wait_for(asyncio.shield(future), self.canary_deadline)
        except asyncio.TimeoutError:
            if self._cell_lane_busy_with_warmup(cell, admission):
                self.counters["canary_busy_skips"] += 1
                return None, None
            self.counters["canary_failures"] += 1
            tracer.event("supervisor.canary_overrun", deadline_s=self.canary_deadline, cell=index)
            return False, None
        except Exception as error:
            self.counters["canary_errors"] += 1
            tracer.event("supervisor.canary_error", error=repr(error), cell=index)
            if self._card():
                self._fail_stop(f"cell {index} canary", error)
                raise
            self.counters["canary_failures"] += 1
            return False, None
        self.last_canary_latency = latency
        for fn in list(self.on_canary):
            try:
                fn(latency)
            except Exception:
                pass
        return True, latency

    def _cell_lane_busy_with_warmup(self, cell, admission: dict) -> bool:
        """Per-cell twin of `_lane_busy_with_warmup`: a probe still
        queued behind the cell lane's bounded warm-grid holder is a busy
        cell, not a sick one."""
        if admission.get("granted") or cell.lane is None:
            return False
        info = cell.lane.holder_info()
        if info is None or info[0] != "warmup":
            return False
        budget = max(4.0 * self.canary_deadline, 1.0)
        return info[2] < budget

    def _trip_cell(self, runtime, index: int) -> None:
        """One cell's breaker opened: degrade that cell only. The runtime
        pauses the cell's serving, parks its lane, drops it out of
        placement and drains its docs to the CPU documents; the other
        cells keep serving."""
        self.counters["degrades"] += 1
        self.cell_states[index] = STATE_DEGRADED
        _logger_mod.log_error(
            f"plane watchdog: cell {index} breaker OPEN; draining its documents "
            "to the CPU path (other cells unaffected)"
        )
        get_flight_recorder().record("__plane__", "cell_breaker_open", cell=index)
        try:
            runtime.degrade_cell(index)
        except Exception:
            _logger_mod.log_error(f"cell {index} degrade sweep failed (docs heal via sync)")

    async def _restore_cell(self, runtime, index: int) -> None:
        """A half-open probe passed: restore the cell and re-onboard the
        live docs that place on it. On the card a re-onboard that raises
        stops the server (`_fail_stop`); on a CPU cell the docs stay on
        the CPU documents."""
        self.counters["attaches"] += 1
        self.cell_states[index] = STATE_READY
        _logger_mod.logger.info(f"plane cell {index} recovered; hot re-attaching its documents")
        get_flight_recorder().record("__plane__", "cell_breaker_close", cell=index)
        try:
            await runtime.restore_cell(index, self._instance)
        except Exception as error:
            if self._card():
                self._fail_stop(f"cell {index} re-onboard", error)
                raise
            _logger_mod.log_error(f"cell {index} restore failed; docs stay on the CPU path")

    def _lane_busy_with_warmup(self) -> bool:
        """True when the outstanding probe is still queued for the
        device lane AND the lane's active holder is a warm-grid
        admission that has held for less than the warm-hold budget.

        Bounded on purpose, in both directions: a build-sized hold is
        accounted boot work (skipping those ticks stops the breaker
        false-tripping at every boot whose warm pass outlasts two probe
        windows), while a warm hold that outlives the budget is
        indistinguishable from a wedged device and must fail the tick —
        otherwise a device that wedges DURING warmup never trips, and
        teardown hangs behind its flush lock."""
        admission = self._canary_admission
        if admission is None or admission.get("granted"):
            return False
        lane = getattr(self.runtime, "lane", None)
        if lane is None:
            return False
        info = lane.holder_info()
        if info is None or info[0] != "warmup":
            return False
        budget = max(4.0 * self.canary_deadline, 1.0)
        return info[2] < budget

    def _trip(self) -> None:
        """Breaker just opened while serving: drain everything to CPU.

        Order matters — pause + abort FIRST so no new work enters the
        device path while the full-state fallback broadcasts go out.
        """
        self.counters["degrades"] += 1
        self._set_state(STATE_DEGRADED)
        _logger_mod.log_error(
            "plane watchdog: circuit breaker OPEN; draining served documents "
            "to the CPU path"
        )
        runtime = self.runtime
        if runtime is None:
            return
        for serving in runtime.servings():
            serving.paused = True
            serving.abort_pending()
        # park the device lane: queued flush/hydration/compaction
        # admissions defer (their tasks reschedule instead of stacking
        # onto a wedged device); only pause-exempt canary probes pass,
        # so half-open recovery can still reach the card
        for lane in _runtime_lanes(runtime):
            lane.pause()
        try:
            runtime.degrade_all()
        except Exception:
            _logger_mod.log_error("plane degrade sweep failed (docs heal via sync)")

    def _card(self) -> bool:
        """True when the runtime's device is the card."""
        runtime = self.runtime
        if runtime is None:
            return self.on_card
        return self.on_card or any(
            plane.device.type == "cuda" for plane in runtime.planes()
        )

    def card_fault(self, what: str, error: BaseException) -> bool:
        """A caller outside the supervisor (the fleet controller's
        actuation) saw `what` raise: on the card the supervisor stops
        serving with the error (`_fail_stop`) and True comes back, so the
        caller re-raises it; on the CPU nothing happens and False comes
        back, so the caller counts the failure and goes on."""
        if not self._card():
            return False
        self._fail_stop(what, error)
        return True

    def _fail_stop(self, what: str, error: BaseException) -> None:
        """A card runtime's `what` raised: a kernel that does not build
        or launch, or a device that faults. Nothing moves to the CPU
        documents (they would serve with the card's tensors left idle):
        the supervisor goes BROKEN with the error in `fault` (logged at
        error, in `snapshot()`), the runtime's timers stop, every
        connection closes, and `on_connect` refuses new ones with the
        error. The caller re-raises it."""
        self.counters["card_faults"] += 1
        self.fault = error
        self._set_state(STATE_BROKEN)
        _logger_mod.log_error(
            f"plane {what} failed on the card ({error!r}); the server stops serving"
        )
        if self.runtime is not None:
            try:
                self.runtime.cancel_timers()
            except Exception:
                pass
        if self._instance is not None:
            self._instance.close_connections()

    # -- state surface -------------------------------------------------------

    def _set_state(self, to: str) -> None:
        frm = self.state
        if frm == to:
            return
        self.state = to
        key = f"{frm}->{to}"
        self.transitions[key] = self.transitions.get(key, 0) + 1
        get_tracer().event("supervisor.transition", frm=frm, to=to)
        # plane-level history rides the recorder under a pseudo-doc, so
        # /debug/docs/__plane__ shows the supervisor's timeline next to
        # the per-doc lifecycle rings
        get_flight_recorder().record("__plane__", "supervisor.transition", frm=frm, to=to)
        for fn in list(self.on_transition):
            try:
                fn(frm, to)
            except Exception:
                pass

    def state_code(self) -> int:
        return STATE_CODES.get(self.state, -1)

    def breaker_code(self) -> int:
        return BREAKER_CODES.get(self.breaker.state, -1)

    def snapshot(self) -> dict:
        """JSON-able health summary (healthz payload / get_health)."""
        cells = None
        if self.cell_states:
            cells = [
                {"cell": i, "state": state, "breaker": breaker.state}
                for i, (state, breaker) in enumerate(zip(self.cell_states, self.cell_breakers))
            ]
        return {
            **({"cells": cells} if cells is not None else {}),
            "state": self.state,
            "serving_from_plane": self.state == STATE_READY,
            "degraded": self.state != STATE_READY,
            "breaker": {
                "state": self.breaker.state,
                "consecutive_failures": self.breaker.consecutive_failures,
                "threshold": self.breaker.threshold,
                "transitions": dict(self.breaker.transitions),
            },
            "transitions": dict(self.transitions),
            "counters": dict(self.counters),
            "fault": None if self.fault is None else repr(self.fault),
            "canary": {
                "last_latency_s": self.last_canary_latency,
                "deadline_s": self.canary_deadline,
                "interval_s": self.watchdog_interval,
            },
            "init": {
                "timeout_s": self.init_timeout,
                "elapsed_s": self.init_elapsed,
                "pending": self.runtime is None and self.state != STATE_BROKEN,
            },
        }


# -- the extension adapter ---------------------------------------------------


class SupervisedTpuMergeExtension(Extension):
    """The boot-safe face of the merge plane: a `TpuMergeExtension` whose
    construction, health and recovery a `PlaneSupervisor` owns.

    Per-document hooks forward to the runtime only while READY; in every
    other state the document stays on the CPU path the server already
    has. Also serves `/healthz` (JSON from `Hocuspocus.get_health()`).

    `plane_kwargs` go to `TpuMergeExtension`. The plane runs on the card
    unless `device="cpu"` is given: without `device`, construction
    raises when CUDA is not available, before any worker thread starts,
    and on the card an error of the runtime stops serving
    (`PlaneSupervisor._fail_stop`): new connections are refused with it.
    `devices != 1` builds the multi-device cell plane (tpu/cells.py): one
    plane, lane and governor per cell with load-aware placement (0 = one
    cell per visible device; on the CPU, `devices` cells on the CPU).
    `shards > 1` (a sharded plane) is not ported yet (ROADMAP.md, Queue A
    item 7b).
    """

    priority = 900

    def __init__(
        self,
        *,
        shards: int = 1,
        devices: int = 1,
        init_timeout: float = 30.0,
        watchdog_interval: float = 5.0,
        breaker_threshold: int = 3,
        canary_deadline: Optional[float] = None,
        healthz_path: str = "/healthz",
        runtime_factory: Optional[Callable[[], Any]] = None,
        **plane_kwargs: Any,
    ) -> None:
        if devices != 1 and shards > 1:
            raise ValueError(
                "pass either devices (per-card cells) or shards "
                "(single-card doc partitions), not both"
            )
        if shards > 1:
            raise NotImplementedError(
                "shards > 1 (a sharded plane) is not ported yet: ROADMAP.md, "
                "Queue A item 7b"
            )
        on_card = False
        if runtime_factory is None:
            device = plane_kwargs.get("device")
            on_card = device is None or str(device).startswith("cuda")
            if on_card:
                import torch

                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "SupervisedTpuMergeExtension needs a CUDA device; pass "
                        "device='cpu' to run the plane on the CPU"
                    )

            def runtime_factory() -> Any:
                # imported HERE, in the worker thread: the kernel modules,
                # the CUDA context and both builds run under the init budget
                if devices != 1:
                    from .cells import MultiDeviceMergeExtension

                    runtime = MultiDeviceMergeExtension(devices=devices, **plane_kwargs)
                    for plane in runtime.planes():
                        plane.load_kernels()
                    return runtime
                from .merge_plane import TpuMergeExtension

                runtime = TpuMergeExtension(**plane_kwargs)
                runtime.plane.load_kernels()
                return runtime

        self.healthz_path = healthz_path
        self.supervisor = PlaneSupervisor(
            runtime_factory,
            init_timeout=init_timeout,
            watchdog_interval=watchdog_interval,
            breaker_threshold=breaker_threshold,
            canary_deadline=canary_deadline,
            on_card=on_card,
        )

    # -- passthroughs --------------------------------------------------------

    @property
    def runtime(self):
        return self.supervisor.runtime

    @property
    def plane(self):
        return getattr(self.supervisor.runtime, "plane", None)

    @property
    def _ready(self) -> bool:
        supervisor = self.supervisor
        return supervisor.state == STATE_READY and supervisor.runtime is not None

    def health_status(self) -> dict:
        return self.supervisor.snapshot()

    # -- hooks ---------------------------------------------------------------

    async def on_configure(self, data: Payload) -> None:
        self.supervisor._instance = data.instance

    async def on_listen(self, data: Payload) -> None:
        self.supervisor.start(data.instance)

    async def on_connect(self, data: Payload) -> None:
        # a card fault stopped serving: refuse, never serve from the CPU
        if self.supervisor.fault is not None:
            raise self.supervisor.fault

    async def after_load_document(self, data: Payload) -> None:
        if self._ready:
            await self.supervisor.runtime.after_load_document(data)

    async def on_change(self, data: Payload) -> None:
        if self._ready:
            await self.supervisor.runtime.on_change(data)

    async def after_unload_document(self, data: Payload) -> None:
        # non-READY states may hold the device locks for good; stale
        # registrations are swept at the next re-attach instead
        if self._ready:
            await self.supervisor.runtime.after_unload_document(data)

    async def on_destroy(self, data: Payload) -> None:
        await self.supervisor.stop()

    async def on_request(self, data: Payload) -> None:
        request = data.request
        path = getattr(getattr(request, "rel_url", None), "path", None) or getattr(
            request, "path", ""
        )
        if path != self.healthz_path:
            return
        import json

        from aiohttp import web

        health = data.instance.get_health()
        data.response = web.Response(
            text=json.dumps(health), content_type="application/json"
        )
        error = _ServeHealth()
        error.response = data.response
        raise error


class _ServeHealth(Exception):
    """Internal: short-circuits the on_request chain with a response."""

    def __str__(self) -> str:  # suppress hook-chain error logging
        return ""
