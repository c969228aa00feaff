"""Fleet autoscaling: digest-driven decisions, warm-spare actuation.

A copy of the JAX package's `fleet/controller.py` over the port's
per-device merge cells (`tpu/cells.py`). Two layers, deliberately
separated:

`FleetController` is the pure decision core. Per tick it consumes
digest-shaped per-cell stats (work-unit *rates*, lane queue depth,
arena occupancy), folds them into one normalized fleet-load signal, and
answers with a single decision — ``hold``, ``scale_up``, ``scale_down``,
or ``park``. All state that makes it flap-proof lives here and nowhere
else, mirroring the brownout ladder's discipline:

* **streaks** — a threshold crossing must persist for ``hold_ticks``
  consecutive ticks before it acts; an oscillating signal resets the
  streak every flip and never scales anything;
* **cooldown** — every action buys ``cooldown_ticks`` of mandatory
  holds, so the fleet settles (migrations complete, rates stop lying)
  before the next decision;
* **projection** — scale-down additionally requires that the survivors
  could absorb the load below ``projected_max``, so the controller
  never removes a cell it would have to re-add next tick;
* **park** — while the OverloadController sits at BROWNOUT-1 or above,
  every decision is ``park``: load signals under brownout are shaped
  by shedding, and topology churn is exactly the deferrable work the
  ladder exists to stop. Unparking re-arms a full cooldown before the
  first post-brownout action.

`FleetControllerExtension` is the driver: an asyncio tick loop that
samples the co-installed multi-device plane, converts its cumulative
dispatch counters into rates, feeds the core, and actuates — scale-up
activates a warm-spare cell (arena and registry were never torn down,
so rejoining is one placement-epoch bump), scale-down migrates every
doc off the coldest cell over the evict-snapshot→hydrate rail and
*then* parks it (overrides land before the epoch bump:
placement-epoch-safe by construction). A parked cell keeps its arena on
its device: nothing is copied to the host for a park. On a supervised
card plane an actuation that raises (a migration's serve that faults)
stops serving through the supervisor (`PlaneSupervisor.card_fault`), as
a raised canary does; it is never retried onto a CPU snapshot.
Deployments where a "cell" is a whole process (the edge tier) inject
their own actuators — e.g. ``scale_down=server.drain`` for the drain
handoff.

Everything the controller does is observable: decisions land in the
``__autoscale__`` flight-recorder ring, `hocuspocus_fleet_autoscale_*`
metrics export the roster and signal, and `GET /debug/fleet` carries a
live ``autoscale`` section via the FleetView attachment seam.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Callable, Optional

from ..observability.fleet import get_fleet_view
from ..observability.flight_recorder import get_flight_recorder
from ..observability.metrics import Counter, Gauge
from ..server.types import Extension, Payload

RING = "__autoscale__"


class FleetController:
    """Pure decision core — stats in, one decision out. No clocks, no
    I/O: tests drive it tick-by-tick with injected digests."""

    def __init__(
        self,
        num_cells: int,
        min_cells: int = 1,
        max_cells: Optional[int] = None,
        up_threshold: float = 0.75,
        down_threshold: float = 0.35,
        projected_max: Optional[float] = None,
        hold_ticks: int = 3,
        cooldown_ticks: int = 5,
        work_target: float = 150.0,
        lane_target: float = 64.0,
        occupancy_target: float = 0.85,
        history: int = 64,
    ) -> None:
        self.num_cells = max(int(num_cells), 1)
        self.min_cells = max(int(min_cells), 1)
        self.max_cells = (
            self.num_cells if max_cells is None else min(int(max_cells), self.num_cells)
        )
        self.up_threshold = float(up_threshold)
        self.down_threshold = float(down_threshold)
        # the load the survivors would carry after a scale-down; default
        # midway between the thresholds so a removal can never land the
        # fleet straight back in scale-up territory
        self.projected_max = (
            (self.up_threshold + self.down_threshold) / 2.0
            if projected_max is None
            else float(projected_max)
        )
        self.hold_ticks = max(int(hold_ticks), 1)
        self.cooldown_ticks = max(int(cooldown_ticks), 0)
        self.work_target = max(float(work_target), 1e-9)
        self.lane_target = max(float(lane_target), 1e-9)
        self.occupancy_target = max(float(occupancy_target), 1e-9)
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self.tick = 0
        self.parked = False
        self.park_reason: Optional[str] = None
        self.signal: Optional[float] = None
        self.last_decision: Optional[dict] = None
        self.decisions: "deque[dict]" = deque(maxlen=max(int(history), 1))
        self.counters = {
            "ticks": 0,
            "scale_ups": 0,
            "scale_downs": 0,
            "holds": 0,
            "parks": 0,
            "unparks": 0,
        }

    # -- signal ---------------------------------------------------------------

    def cell_load(self, cell: dict) -> float:
        """One cell's normalized load: the hottest of its signals. Max,
        not mean — a saturated lane on an otherwise idle cell is still
        a reason to keep capacity."""
        work = float(cell.get("work_rate") or 0.0) / self.work_target
        lane = float(cell.get("lane_queue_depth") or 0.0) / self.lane_target
        occupancy = float(cell.get("occupancy") or 0.0) / self.occupancy_target
        return max(work, lane, occupancy)

    # -- decision table ---------------------------------------------------------

    def observe(
        self,
        cells: "list[dict]",
        scaling_allowed: bool = True,
        park_reason: Optional[str] = None,
    ) -> dict:
        """One tick: digest-shaped per-cell stats (``healthy`` marks
        active members; unhealthy entries are the warm-spare pool) plus
        the brownout park signal, out comes the decision."""
        self.tick += 1
        self.counters["ticks"] += 1
        active = [c for c in cells if c.get("healthy")]
        spares = [c for c in cells if not c.get("healthy")]
        if active:
            loads = [self.cell_load(c) for c in active]
            self.signal = sum(loads) / len(loads)
        else:
            self.signal = None

        if not scaling_allowed:
            # hard park: never fight the overload plane. Streaks reset
            # (brownout-shaped signals prove nothing) and the cooldown
            # re-arms so unparking starts from a clean slate.
            reason = park_reason or "overload"
            newly_parked = not self.parked
            if newly_parked:
                self.parked = True
                self.counters["parks"] += 1
            self.park_reason = reason
            self._up_streak = self._down_streak = 0
            self._cooldown = self.cooldown_ticks
            return self._decide("park", None, reason, record=newly_parked)
        if self.parked:
            self.parked = False
            self.park_reason = None
            self.counters["unparks"] += 1
            self._decide("unpark", None, "scaling_resumed", record=True)

        if self._cooldown > 0:
            self._cooldown -= 1
            return self._decide("hold", None, "cooldown")
        if self.signal is None:
            return self._decide("hold", None, "no_active_cells")

        if self.signal >= self.up_threshold:
            self._down_streak = 0
            self._up_streak += 1
            if self._up_streak < self.hold_ticks:
                return self._decide("hold", None, "up_streak_building")
            if not spares or len(active) >= self.max_cells:
                return self._decide("hold", None, "no_spare_capacity")
            self._up_streak = 0
            self._cooldown = self.cooldown_ticks
            target = min(spares, key=lambda c: c.get("cell", 0))
            return self._decide("scale_up", target.get("cell"), "load_high")

        if self.signal <= self.down_threshold:
            self._up_streak = 0
            self._down_streak += 1
            if self._down_streak < self.hold_ticks:
                return self._decide("hold", None, "down_streak_building")
            if len(active) <= self.min_cells:
                return self._decide("hold", None, "at_min_cells")
            projected = self.signal * len(active) / (len(active) - 1)
            if projected > self.projected_max:
                return self._decide("hold", None, "survivors_too_hot")
            self._down_streak = 0
            self._cooldown = self.cooldown_ticks
            coldest = min(
                active, key=lambda c: (self.cell_load(c), c.get("cell", 0))
            )
            return self._decide("scale_down", coldest.get("cell"), "load_low")

        # mid-band: load is where we want it — both streaks reset, so a
        # signal oscillating across a threshold never accumulates one
        self._up_streak = self._down_streak = 0
        return self._decide("hold", None, "in_band")

    def _decide(
        self, action: str, cell: Any, reason: str, record: Optional[bool] = None
    ) -> dict:
        decision = {
            "action": action,
            "cell": cell,
            "reason": reason,
            "signal": None if self.signal is None else round(self.signal, 4),
            "tick": self.tick,
        }
        self.last_decision = decision
        if action == "hold":
            self.counters["holds"] += 1
        elif action == "scale_up":
            self.counters["scale_ups"] += 1
        elif action == "scale_down":
            self.counters["scale_downs"] += 1
        # the bounded decision history keeps TRANSITIONS (scales, the
        # first tick of a park, the unpark), not the parked steady state
        if record if record is not None else action in ("scale_up", "scale_down"):
            self.decisions.append(decision)
        return decision

    def status(self) -> dict:
        return {
            "parked": self.parked,
            "park_reason": self.park_reason,
            "signal": None if self.signal is None else round(self.signal, 4),
            "thresholds": {
                "up": self.up_threshold,
                "down": self.down_threshold,
                "projected_max": self.projected_max,
                "hold_ticks": self.hold_ticks,
                "cooldown_ticks": self.cooldown_ticks,
                "work_target": self.work_target,
            },
            "bounds": {"min_cells": self.min_cells, "max_cells": self.max_cells},
            "last_decision": self.last_decision,
            "decisions": list(self.decisions),
            "counters": dict(self.counters),
        }


class FleetControllerExtension(Extension):
    """The tick driver: samples the plane, feeds the core, actuates.

    Ordered after Metrics (1000) and CellIngress (950) so telemetry and
    the cell identity are lit, before the plane (900) so `on_configure`
    can still find it by walking the extension list either way.
    """

    priority = 920

    def __init__(
        self,
        interval_s: float = 0.5,
        warm_spares: int = 0,
        scale_up: Optional[Callable] = None,
        scale_down: Optional[Callable] = None,
        **tuning: Any,
    ) -> None:
        self.interval_s = max(float(interval_s), 0.01)
        self.warm_spares = max(int(warm_spares), 0)
        self._scale_up_override = scale_up
        self._scale_down_override = scale_down
        self._tuning = tuning
        self.controller: Optional[FleetController] = None
        # the plane either co-installs directly (harness, tests) or
        # lives behind a supervised wrapper whose runtime is built in a
        # worker thread AFTER listen — resolved lazily via the property
        self._plane_direct = None
        self._plane_host = None
        self._num_cells_from_plane = "num_cells" not in tuning
        self._spares_applied = False
        self.instance = None
        self._task: Optional[asyncio.Task] = None
        self._t0: Optional[float] = None
        # rate derivation off the plane's monotonic dispatch counters
        self._last_sample: "dict[int, float]" = {}
        self._last_sample_t: Optional[float] = None
        self._rate_ewma: "dict[int, float]" = {}
        # roster timeline: every membership change, stamped relative to
        # listen time — the bench artifact's scale story
        self.timeline: "deque[dict]" = deque(maxlen=256)
        self.actuation = {
            "activations": 0,
            "parks": 0,
            "docs_migrated": 0,
            "failures": 0,
        }
        # -- exposition (adopted by a co-installed Metrics registry) ------
        self.decisions_metric = Counter(
            "hocuspocus_fleet_autoscale_decisions_total",
            "Autoscaling decisions by action (scale_up/scale_down/park)",
        )
        self.active_cells_gauge = Gauge(
            "hocuspocus_fleet_autoscale_active_cells",
            "Cells currently in placement under the autoscaler",
            fn=lambda: float(len(self.active_cells())),
        )
        self.parked_gauge = Gauge(
            "hocuspocus_fleet_autoscale_parked",
            "1 while scaling is parked by the overload ladder",
            fn=lambda: 1.0
            if self.controller is not None and self.controller.parked
            else 0.0,
        )
        self.signal_gauge = Gauge(
            "hocuspocus_fleet_autoscale_signal",
            "Normalized fleet-load signal (1.0 = at target)",
            fn=lambda: float(
                (self.controller.signal or 0.0)
                if self.controller is not None
                else 0.0
            ),
        )
        self.migrations_metric = Counter(
            "hocuspocus_fleet_autoscale_migrations_total",
            "Docs migrated off cells by scale-down decisions",
        )

    # -- wiring ---------------------------------------------------------------

    @property
    def plane(self):
        if self._plane_direct is not None:
            return self._plane_direct
        if self._plane_host is not None:
            runtime = getattr(self._plane_host, "runtime", None)
            if (
                runtime is not None
                and hasattr(runtime, "cell_stats")
                and hasattr(runtime, "placement")
            ):
                self._adopt_plane(runtime)
                return runtime
        return None

    @plane.setter
    def plane(self, value) -> None:
        self._plane_direct = value

    def _adopt_plane(self, plane) -> None:
        """First resolution of a supervised runtime: size the core to
        the real fleet and apply any still-pending warm-spare parking
        (listen came and went while the supervisor was still booting)."""
        self._plane_direct = plane
        if self.controller is not None and self._num_cells_from_plane:
            total = max(len(plane.cells), 1)
            self.controller.num_cells = total
            if "max_cells" not in self._tuning:
                self.controller.max_cells = total
            else:
                self.controller.max_cells = min(
                    self.controller.max_cells, total
                )
        if self._t0 is not None and not self._spares_applied:
            self._park_warm_spares()
            self._note_roster("boot")

    def _park_warm_spares(self) -> None:
        """Boot-time warm spares: the last N cells start parked — BUILT
        (arena allocated, registry warm) but out of placement, so the
        fleet boots at its trough footprint."""
        if self._spares_applied:
            return
        self._spares_applied = True
        if self._plane_direct is None or not self.warm_spares:
            return
        total = len(self._plane_direct.cells)
        floor = self.controller.min_cells if self.controller else 1
        spares = min(self.warm_spares, max(total - floor, 0))
        for index in range(total - spares, total):
            self._plane_direct.placement.mark_down(index)
        if spares:
            get_flight_recorder().record(
                RING, "warm_spares_parked", count=spares, total=total
            )

    async def on_configure(self, data: Payload) -> None:
        self.instance = data.instance
        extensions = getattr(data.instance, "_extensions", None) or getattr(
            data.instance.configuration, "extensions", []
        )
        for extension in extensions:
            if hasattr(extension, "cell_stats") and hasattr(
                extension, "placement"
            ):
                self._plane_direct = extension
                break
        else:
            for extension in extensions:
                # the supervised face (tpu/supervisor.py) builds its
                # runtime asynchronously — remember the host, resolve
                # the plane lazily once the supervisor is READY
                if getattr(extension, "supervisor", None) is not None:
                    self._plane_host = extension
                    break
        num_cells = (
            len(self._plane_direct.cells)
            if self._plane_direct is not None
            else 1
        )
        self._tuning.setdefault("num_cells", num_cells)
        self.controller = FleetController(**self._tuning)
        # metric adoption: same registry-walk pattern as the replica and
        # edge families — whichever co-installed extension exposes one
        for extension in extensions:
            registry = getattr(extension, "registry", None)
            if registry is not None and callable(
                getattr(registry, "register", None)
            ):
                for metric in self.metrics():
                    try:
                        registry.register(metric)
                    except ValueError:
                        pass
                break
        get_fleet_view().attach_autoscale(self.status)

    async def on_listen(self, data: Payload) -> None:
        self._t0 = time.monotonic()
        # reading .plane may adopt an already-READY supervised runtime,
        # which parks the spares and notes the boot itself
        if self.plane is not None and not self._spares_applied:
            self._park_warm_spares()
            self._note_roster("boot")
        # a still-booting supervised runtime is handled by _adopt_plane
        # once it resolves
        self._task = asyncio.ensure_future(self._run())

    async def on_destroy(self, data: Payload) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        view = get_fleet_view()
        if view.autoscale_status is self.status:
            view.attach_autoscale(None)

    def metrics(self) -> tuple:
        return (
            self.decisions_metric,
            self.active_cells_gauge,
            self.parked_gauge,
            self.signal_gauge,
            self.migrations_metric,
        )

    # -- sampling -------------------------------------------------------------

    def active_cells(self) -> "list[int]":
        if self.plane is None:
            return []
        return sorted(self.plane.placement.healthy)

    def sample_cells(self) -> "list[dict]":
        """Digest-shaped stats with work-unit RATES. The plane's
        `dispatched_total` is monotonic and migration-invariant (unlike
        the per-slot counters, which hydration credits wholesale), so
        the diff is pure fresh dispatch work; a low-RTT-style EWMA
        smooths tick-boundary noise. Device bytes come through the cell
        plane's own `cell_stats` (`hbm_bytes`, from
        `torch.cuda.memory_allocated` of a card cell's device): cells
        wrapped onto one card all read that card's total."""
        stats = self.plane.cell_stats()
        now = time.monotonic()
        dt = (
            None
            if self._last_sample_t is None
            else max(now - self._last_sample_t, 1e-6)
        )
        for entry in stats:
            index = entry["cell"]
            plane = self.plane.cells[index].plane
            total = float(getattr(plane, "dispatched_total", 0.0))
            last = self._last_sample.get(index)
            rate = 0.0
            if dt is not None and last is not None:
                rate = max(total - last, 0.0) / dt
            smoothed = self._rate_ewma.get(index)
            smoothed = rate if smoothed is None else 0.5 * smoothed + 0.5 * rate
            self._rate_ewma[index] = smoothed
            self._last_sample[index] = total
            entry["work_rate"] = round(smoothed, 2)
        self._last_sample_t = now
        return stats

    # -- tick loop -------------------------------------------------------------

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.tick_once()
            except asyncio.CancelledError:
                raise
            except Exception as error:
                self.actuation["failures"] += 1
                # on a card plane an actuation that raised (a migration
                # whose serve or flush faulted) stops the supervised
                # server, as a raised canary does, and ends the loop
                supervisor = getattr(self._plane_host, "supervisor", None)
                if supervisor is not None and supervisor.card_fault(
                    "fleet actuation", error
                ):
                    get_flight_recorder().record(
                        RING, "card_fault", error=repr(error)
                    )
                    raise

    async def tick_once(self, cells: "Optional[list[dict]]" = None) -> dict:
        """One full control cycle; tests inject digest-shaped `cells`
        to drive the loop without wall-clock sampling."""
        from ..server.overload import RUNG_NAMES, get_overload_controller

        overload = get_overload_controller()
        allowed = overload.scaling_allowed()
        park_reason = (
            None if allowed else f"brownout:{RUNG_NAMES[overload.rung]}"
        )
        if cells is None:
            if self.plane is None:
                return {"action": "hold", "reason": "no_plane"}
            cells = self.sample_cells()
        decision = self.controller.observe(
            cells, scaling_allowed=allowed, park_reason=park_reason
        )
        await self._apply(decision)
        return decision

    async def _apply(self, decision: dict) -> None:
        action = decision["action"]
        if action in ("scale_up", "scale_down"):
            self.decisions_metric.inc(action=action)
            get_flight_recorder().record(
                RING,
                action,
                cell=decision["cell"],
                signal=decision["signal"],
                reason=decision["reason"],
            )
        elif action in ("park", "unpark") and decision is (
            self.controller.decisions[-1] if self.controller.decisions else None
        ):
            # transition tick only (steady parked ticks aren't recorded)
            self.decisions_metric.inc(action=action)
            get_flight_recorder().record(
                RING, action, reason=decision["reason"]
            )
        if action == "scale_up":
            await self._do_scale_up(decision["cell"])
        elif action == "scale_down":
            await self._do_scale_down(decision["cell"])

    async def _do_scale_up(self, index: Any) -> None:
        if self._scale_up_override is not None:
            await self._scale_up_override(index)
        elif self.plane is not None:
            await self.plane.activate_cell(index, self.instance)
        self.actuation["activations"] += 1
        self._note_roster("scale_up")

    async def _do_scale_down(self, index: Any) -> None:
        if self._scale_down_override is not None:
            await self._scale_down_override(index)
            self.actuation["parks"] += 1
        elif self.plane is not None:
            result = await self.plane.park_cell(index)
            moved = int(result.get("migrated", 0))
            self.actuation["parks"] += 1
            self.actuation["docs_migrated"] += moved
            if moved:
                self.migrations_metric.inc(moved)
        self._note_roster("scale_down")

    def _note_roster(self, action: str) -> None:
        entry = {
            "t_s": 0.0
            if self._t0 is None
            else round(time.monotonic() - self._t0, 3),
            "action": action,
            "active": self.active_cells(),
        }
        self.timeline.append(entry)
        get_flight_recorder().record(
            RING, "roster", action=action, active=entry["active"]
        )

    # -- status (the /debug/fleet `autoscale` section) -------------------------

    def status(self) -> dict:
        payload = {
            "enabled": True,
            "interval_s": self.interval_s,
            "roster": {
                "active": self.active_cells(),
                "total": len(self.plane.cells) if self.plane is not None else 0,
            },
            "timeline": list(self.timeline),
            "actuation": dict(self.actuation),
        }
        if self.controller is not None:
            payload.update(self.controller.status())
        return payload
