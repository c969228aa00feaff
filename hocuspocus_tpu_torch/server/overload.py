"""Overload control plane: admission quotas + the brownout ladder.

Nothing used to stand between a flash crowd and the event loop: the only
overload responses were per-socket (the send-queue backpressure
watermark, the fan-out catch-up tier) and the only global refusal was the
drain path's 503. This module is the process-wide front door — a single
controller that samples the load signals already flowing through the system and
turns them into a hysteresis-driven degradation ladder plus per-tenant
token-bucket admission:

**Signals** (each with (brownout1, brownout2, red) thresholds):

- ``loop_lag_ms``   — event-loop scheduling lag, measured by the
  controller's own sampler (the truest "the process is drowning" bit);
- ``send_queue_depth`` / ``backpressure_per_s`` — summed transport
  send queues and watermark-crossing rate (observability/wire.py);
- ``lane_depth``    — waiters queued for the device lane(s)
  (tpu/scheduler.py registers every ``DeviceLane``);
- ``wal_commit_ms`` — last WAL group-commit duration (storage/wal.py);
- ``inbox_depth``   — queued inbound replication frames
  (extensions/redis.py via the wire collector);
- ``injected``      — synthetic pressure for chaos/scenario runs
  (``inject_pressure``; the loadgen ``overload`` op drives it).

**The ladder** (worst signal wins; escalation is immediate,
de-escalation steps down ONE rung per ``hold_s`` of sustained calm so a
signal oscillating around a threshold can never flap the rung):

==============  =============================================================
GREEN           full service
BROWNOUT-1      park compaction/eviction maintenance sweeps
                (tpu/residency.py), stretch the awareness broadcast
                cadence (server/fanout.py)
BROWNOUT-2      additionally defer catch-up/full-state frames
                (CatchupTier stays in elision) and elide awareness
                fan-out entirely
RED             additionally reject new upgrades with 503 + Retry-After
                (the same helper the drain path uses), refuse new
                document channels at auth, and close channels 1013 on
                ingress-quota overflow
==============  =============================================================

**Admission.** Per-tenant token buckets at two seams: connect/auth (one
charge per document channel established) and message ingress (one per
inbound frame). Tenancy resolves from the connection context, the
``x-tenant`` header or the ``tenant`` query parameter; quotas default
OFF (rate 0 = unlimited) so single-tenant deployments pay nothing. A
tenant that exhausts its bucket is refused — other tenants' buckets are
untouched, so one noisy tenant can never starve the rest.

Every rung transition lands in the flight recorder under
``__overload__``, the whole surface exports as ``hocuspocus_overload_*``
metrics, ``/healthz`` carries the rung + active shed reasons (via the
extension's ``health_status``), and ``/debug/slo`` embeds
``status()``. Enabled by the :class:`OverloadExtension` (CLI
``--overload``); disabled, every hot-path seam costs one attribute
read, the same contract as the wire-telemetry collector.
"""

from __future__ import annotations

import asyncio
import logging
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Optional

from ..observability.flight_recorder import get_flight_recorder
from ..observability.metrics import Counter, Gauge
from ..observability.wire import get_wire_telemetry
from .types import Extension, Payload

logger = logging.getLogger("hocuspocus_tpu_torch")

# ladder rungs (ordered: comparisons like `rung >= BROWNOUT2` are the
# hot-path idiom)
GREEN = 0
BROWNOUT1 = 1
BROWNOUT2 = 2
RED = 3

RUNG_NAMES = ("green", "brownout1", "brownout2", "red")

# default signal thresholds: (enter BROWNOUT-1, BROWNOUT-2, RED).
# Deliberately conservative — a healthy server under normal load never
# leaves GREEN; operators (and scenarios) tighten per deployment.
DEFAULT_THRESHOLDS: "dict[str, tuple]" = {
    "loop_lag_ms": (60.0, 200.0, 600.0),
    "send_queue_depth": (512.0, 2048.0, 8192.0),
    "backpressure_per_s": (4.0, 16.0, 64.0),
    "lane_depth": (8.0, 32.0, 128.0),
    "wal_commit_ms": (50.0, 250.0, 1000.0),
    "inbox_depth": (256.0, 1024.0, 4096.0),
    "injected": (1.0, 2.0, 3.0),
}


def resolve_tenant(
    request: Any = None,
    context: Any = None,
    headers: Optional[dict] = None,
    parameters: Optional[dict] = None,
) -> str:
    """Tenant identity for admission accounting. Precedence: connection
    context (an auth hook may have stamped it), the ``x-tenant``
    header, the ``tenant`` query parameter, else ``"default"``."""
    if context is not None:
        get = getattr(context, "get", None)
        if callable(get):
            tenant = get("tenant")
            if tenant:
                return str(tenant)
    if headers is None and request is not None:
        headers = getattr(request, "headers", None)
    if parameters is None and request is not None:
        parameters = getattr(request, "parameters", None)
    if headers:
        for key in ("x-tenant", "X-Tenant", "x-hocuspocus-tenant"):
            tenant = headers.get(key)
            if tenant:
                return str(tenant)
    if parameters:
        tenant = parameters.get("tenant")
        if tenant:
            return str(tenant)
    return "default"


def service_unavailable_response(reason: str, retry_after_s: float = 1.0):
    """THE 503 + ``Retry-After`` rejection: the graceful-drain path and
    RED-state/quota admission build their refusals here so both emit
    identical wire behavior (balancers fail the health check over;
    direct clients back off — the provider treats any connect failure
    as retryable and keeps climbing its backoff ladder)."""
    from aiohttp import web

    return web.Response(
        status=503,
        text=f"Service Unavailable: {reason}",
        headers={"Retry-After": str(max(int(round(retry_after_s)), 1))},
    )


class TokenBucket:
    """Standard token bucket; ``rate <= 0`` means unlimited."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self.last = time.monotonic()

    def _refill(self, now: float) -> None:
        if now > self.last:
            self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
            self.last = now

    def take(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        if self.rate <= 0:
            return True
        self._refill(time.monotonic() if now is None else now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def peek(self, n: float = 1.0, now: Optional[float] = None) -> bool:
        """Non-consuming availability check (the upgrade path peeks;
        the auth path charges — a websocket admission must not pay the
        bucket twice)."""
        if self.rate <= 0:
            return True
        self._refill(time.monotonic() if now is None else now)
        return self.tokens >= n


class _Signal:
    __slots__ = ("name", "read", "thresholds")

    def __init__(self, name: str, read: Callable[[], float], thresholds: tuple) -> None:
        self.name = name
        self.read = read
        self.thresholds = tuple(float(t) for t in thresholds)

    def rung_for(self, value: float) -> int:
        rung = GREEN
        for i, threshold in enumerate(self.thresholds):
            if value >= threshold:
                rung = i + 1
        return rung


class OverloadController:
    """Process-global degradation ladder + tenant admission quotas.

    One instance per process by default (``get_overload_controller()``),
    matching the wire-telemetry/tracer singleton pattern: the hot-path
    seams (upgrade, auth, ingress, fan-out, maintenance) read it
    directly and pay one truth test while ``enabled`` is False.
    Construct instances directly for isolated tests.
    """

    def __init__(self) -> None:
        self.enabled = False
        self.rung = GREEN
        self._apply_default_tuning()
        # -- state ----------------------------------------------------
        self._injected = 0.0
        self._loop_lag_ms = 0.0
        self._below_since: Optional[float] = None
        self._last_sample_at = 0.0
        self._last_backpressure_total = 0.0
        self._sampler_task: Optional[asyncio.Task] = None
        # loop-lag listeners: the sampling profiler's burst trigger
        # (observability/profiler.py) registers here — invoked with the
        # smoothed lag each sampler tick; exceptions are the listener's
        # problem, never the ladder's
        self.on_loop_lag: "list" = []
        self.last_signals: "dict[str, dict]" = {}
        self.transitions: "deque[dict]" = deque(maxlen=256)
        self._shed_counts: "dict[str, int]" = {}
        self._shed_ts: "dict[str, float]" = {}
        # bounded per-tenant buckets (LRU: a burst of one-shot tenants
        # must not grow the maps forever)
        self._connect_buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._message_buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        # registered signal sources (weak: a torn-down lane/WAL falls
        # out on its own)
        self._lanes: "weakref.WeakSet" = weakref.WeakSet()
        self._wals: "weakref.WeakSet" = weakref.WeakSet()
        # -- exposition (adopted by the Metrics registry) --------------
        self.state_gauge = Gauge(
            "hocuspocus_overload_state",
            "Degradation ladder rung (0=green 1=brownout1 2=brownout2 3=red)",
            fn=lambda: self.rung,
        )
        self.transitions_total = Counter(
            "hocuspocus_overload_transitions_total",
            "Degradation ladder rung transitions",
        )
        self.shed_total = Counter(
            "hocuspocus_overload_shed_total",
            "Work shed by the overload ladder, by reason (awareness "
            "elided/stretched, catch-up deferred, maintenance parked, "
            "messages throttled)",
        )
        self.admitted_total = Counter(
            "hocuspocus_overload_admitted_total",
            "Admissions granted, by scope (upgrade/connect)",
        )
        self.rejected_total = Counter(
            "hocuspocus_overload_rejected_total",
            "Admissions refused, by scope (upgrade/connect/message) and "
            "reason (red/tenant_quota/draining)",
        )
        self.signal_gauge = Gauge(
            "hocuspocus_overload_signal",
            "Last sampled value per overload signal",
        )
        self.tenants_gauge = Gauge(
            "hocuspocus_overload_tenants",
            "Tenants with live admission buckets",
            fn=lambda: max(len(self._connect_buckets), len(self._message_buckets)),
        )
        self.signals: "list[_Signal]" = self._build_signals()

    # -- configuration -------------------------------------------------------

    def _apply_default_tuning(self) -> None:
        self.sample_interval_s = 0.25
        # de-escalation hold: desired rung must stay BELOW the current
        # one for this long before the ladder steps down (one rung per
        # hold window — the no-flap guarantee)
        self.hold_s = 2.0
        self.retry_after_s = 1.0
        # BROWNOUT-1: awareness ticks with no update payload defer this
        # long instead of flushing on call_soon
        self.awareness_stretch_ms = 250.0
        # BROWNOUT-2: a deferred catch-up exit re-checks on this cadence
        self.catchup_retry_s = 0.5
        # tenant quotas, tokens/second + burst; rate 0 disables
        self.connect_rate = 0.0
        self.connect_burst = 8.0
        self.message_rate = 0.0
        self.message_burst = 256.0
        self.max_tenants = 4096
        self.thresholds: "dict[str, tuple]" = dict(DEFAULT_THRESHOLDS)

    def _build_signals(self) -> "list[_Signal]":
        wire = get_wire_telemetry()
        return [
            _Signal("loop_lag_ms", lambda: self._loop_lag_ms, self.thresholds["loop_lag_ms"]),
            _Signal(
                "send_queue_depth",
                wire.queue_depth_total,
                self.thresholds["send_queue_depth"],
            ),
            _Signal(
                "backpressure_per_s",
                self._backpressure_rate,
                self.thresholds["backpressure_per_s"],
            ),
            _Signal("lane_depth", self._lane_depth, self.thresholds["lane_depth"]),
            _Signal("wal_commit_ms", self._wal_commit_ms, self.thresholds["wal_commit_ms"]),
            _Signal(
                "inbox_depth", wire.inbox_depth_total, self.thresholds["inbox_depth"]
            ),
            _Signal("injected", lambda: self._injected, self.thresholds["injected"]),
        ]

    def configure(self, **options: Any) -> "OverloadController":
        """Apply tuning options; ``thresholds`` merges per-signal
        (missing signals keep their defaults)."""
        thresholds = options.pop("thresholds", None)
        for key, value in options.items():
            if not hasattr(self, key):
                raise TypeError(f"unknown overload option {key!r}")
            setattr(self, key, value)
        if thresholds:
            for name, bounds in thresholds.items():
                if name not in self.thresholds:
                    raise KeyError(f"unknown overload signal {name!r}")
                if len(tuple(bounds)) != 3:
                    raise ValueError(f"signal {name!r} needs (b1, b2, red) thresholds")
                self.thresholds[name] = tuple(float(b) for b in bounds)
        self.signals = self._build_signals()
        return self

    def enable(self) -> "OverloadController":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Back to a cold, DISABLED GREEN state with default tuning
        (test and scenario isolation — configure() mutates the
        process-global singleton, so a driven run must hand the next
        one a clean controller)."""
        self.stop()
        self.enabled = False
        self._apply_default_tuning()
        self.signals = self._build_signals()
        for metric in (
            self.transitions_total,
            self.shed_total,
            self.admitted_total,
            self.rejected_total,
        ):
            metric._values.clear()
        self.signal_gauge.clear()
        self.rung = GREEN
        self._injected = 0.0
        self._loop_lag_ms = 0.0
        self._below_since = None
        self._last_sample_at = 0.0
        self._last_backpressure_total = 0.0
        self.last_signals = {}
        self.transitions.clear()
        self._shed_counts.clear()
        self._shed_ts.clear()
        self._connect_buckets.clear()
        self._message_buckets.clear()
        self.on_loop_lag = []

    # -- signal reads --------------------------------------------------------

    def _backpressure_rate(self) -> float:
        """Watermark crossings per second since the previous sample."""
        wire = get_wire_telemetry()
        total = float(wire.backpressure_total())
        now = time.monotonic()
        dt = now - self._last_sample_at if self._last_sample_at else 0.0
        delta = total - self._last_backpressure_total
        self._last_backpressure_total = total
        if dt <= 0:
            return 0.0
        # floor the window: an out-of-band sample (inject_pressure fires
        # one immediately) right after a sampler tick must not divide a
        # single crossing by a near-zero dt and spuriously read as a
        # crossing storm
        return max(delta, 0.0) / max(dt, self.sample_interval_s / 2)

    def _lane_depth(self) -> float:
        total = 0
        for lane in list(self._lanes):
            try:
                total += sum(lane.queue_depths())
            except Exception:
                continue
        return float(total)

    def _wal_commit_ms(self) -> float:
        worst = 0.0
        for wal in list(self._wals):
            try:
                worst = max(worst, float(wal.stats.get("commit_last_ms", 0.0)))
            except Exception:
                continue
        return worst

    def register_lane(self, lane: Any) -> None:
        """A DeviceLane joins the lane-depth signal (weakly held)."""
        self._lanes.add(lane)

    def register_wal(self, wal: Any) -> None:
        """A WalManager joins the commit-latency signal (weakly held)."""
        self._wals.add(wal)

    def inject_pressure(self, value: float) -> None:
        """Synthetic pressure in rung units (1=BROWNOUT-1 … 3=RED) for
        chaos/scenario runs; 0 clears. Samples immediately so the
        ladder reacts between sampler ticks."""
        self._injected = float(value)
        if self.enabled:
            self.sample()

    # -- the ladder ----------------------------------------------------------

    def sample(self) -> int:
        """One ladder evaluation; returns the (possibly new) rung."""
        now = time.monotonic()
        desired = GREEN
        reasons: "list[str]" = []
        snapshot: "dict[str, dict]" = {}
        for signal in self.signals:
            try:
                value = float(signal.read())
            except Exception:
                value = 0.0
            rung = signal.rung_for(value)
            snapshot[signal.name] = {
                "value": round(value, 3),
                "rung": rung,
                "thresholds": list(signal.thresholds),
            }
            self.signal_gauge.set(round(value, 3), signal=signal.name)
            if rung > desired:
                desired, reasons = rung, [signal.name]
            elif rung == desired and rung > GREEN:
                reasons.append(signal.name)
        self.last_signals = snapshot
        self._last_sample_at = now
        if desired > self.rung:
            # escalation is immediate: shedding late is shedding never
            self._below_since = None
            self._transition(desired, reasons)
        elif desired < self.rung:
            if self._below_since is None:
                self._below_since = now
            elif now - self._below_since >= self.hold_s:
                # hysteresis: ONE rung down per sustained hold window —
                # the ladder walks back, it never jumps or bounces
                self._below_since = now
                self._transition(self.rung - 1, reasons or ["recovering"])
        else:
            self._below_since = None
        return self.rung

    def _transition(self, new_rung: int, reasons: "list[str]") -> None:
        old = self.rung
        self.rung = new_rung
        entry = {
            "ts": time.time(),
            "from_rung": RUNG_NAMES[old],
            "to_rung": RUNG_NAMES[new_rung],
            "reasons": sorted(set(reasons)),
        }
        self.transitions.append(entry)
        self.transitions_total.inc(
            from_state=RUNG_NAMES[old], to_state=RUNG_NAMES[new_rung]
        )
        get_flight_recorder().record(
            "__overload__",
            "rung_change",
            from_rung=entry["from_rung"],
            to_rung=entry["to_rung"],
            reasons=",".join(entry["reasons"]),
        )
        log = logger.warning if new_rung > old else logger.info
        log(
            "overload ladder: %s -> %s (%s)",
            RUNG_NAMES[old],
            RUNG_NAMES[new_rung],
            ", ".join(entry["reasons"]),
        )

    # -- hot-path policy reads -----------------------------------------------

    def maintenance_allowed(self) -> bool:
        """BROWNOUT-1+: park compaction/eviction maintenance sweeps."""
        if self.enabled and self.rung >= BROWNOUT1:
            self.shed("maintenance_parked")
            return False
        return True

    def scaling_allowed(self) -> bool:
        """BROWNOUT-1+: hard-park fleet autoscaling
        (fleet/controller.py). Topology churn — migrations, drains,
        placement epochs — is deferrable background work exactly like
        maintenance, and worse: a controller acting on brownout-shaped
        load signals (shedding flattens them) would scale DOWN into an
        overload, fighting the ladder's own recovery."""
        if self.enabled and self.rung >= BROWNOUT1:
            self.shed("autoscale_parked")
            return False
        return True

    def awareness_delay_s(self) -> float:
        """BROWNOUT-1+: stretch awareness-only broadcast ticks."""
        if self.enabled and self.rung >= BROWNOUT1:
            return self.awareness_stretch_ms / 1000.0
        return 0.0

    def elide_awareness(self) -> bool:
        """BROWNOUT-2+: drop awareness fan-out entirely (presence is
        ephemeral LWW state; the next tick at a lower rung heals it)."""
        return self.enabled and self.rung >= BROWNOUT2

    def defer_catchup(self) -> bool:
        """BROWNOUT-2+: hold slow consumers in the catch-up tier instead
        of serving their full-state frame now."""
        return self.enabled and self.rung >= BROWNOUT2

    def reject_upgrades(self) -> bool:
        return self.enabled and self.rung >= RED

    def shed(self, reason: str, count: int = 1) -> None:
        self.shed_total.inc(count, reason=reason)
        self._shed_counts[reason] = self._shed_counts.get(reason, 0) + count
        self._shed_ts[reason] = time.monotonic()

    def active_shed_reasons(self, window_s: float = 10.0) -> "list[str]":
        now = time.monotonic()
        return sorted(
            reason for reason, ts in self._shed_ts.items() if now - ts <= window_s
        )

    # -- admission -----------------------------------------------------------

    def _bucket(
        self,
        buckets: "OrderedDict[str, TokenBucket]",
        tenant: str,
        rate: float,
        burst: float,
    ) -> TokenBucket:
        bucket = buckets.get(tenant)
        if bucket is None:
            while len(buckets) >= self.max_tenants:
                buckets.popitem(last=False)
            bucket = buckets[tenant] = TokenBucket(rate, burst)
        else:
            buckets.move_to_end(tenant)
        return bucket

    def admit_upgrade(self, tenant: str) -> "Optional[str]":
        """Websocket-upgrade admission; returns None (admit) or the
        refusal reason. PEEKS the connect bucket — the charge lands at
        auth so a websocket admission never pays twice."""
        if not self.enabled:
            return None
        if self.rung >= RED:
            self.rejected_total.inc(scope="upgrade", reason="red")
            self.shed("upgrades_rejected")
            return "overloaded"
        bucket = self._bucket(
            self._connect_buckets, tenant, self.connect_rate, self.connect_burst
        )
        if not bucket.peek():
            self.rejected_total.inc(scope="upgrade", reason="tenant_quota")
            self.shed("upgrades_rejected")
            return "tenant-quota"
        self.admitted_total.inc(scope="upgrade")
        return None

    def admit_connect(self, tenant: str) -> "Optional[str]":
        """Document-channel (auth-time) admission; returns None or the
        refusal reason. Charges the tenant's connect bucket."""
        if not self.enabled:
            return None
        if self.rung >= RED:
            self.rejected_total.inc(scope="connect", reason="red")
            self.shed("connects_rejected")
            return "overloaded"
        bucket = self._bucket(
            self._connect_buckets, tenant, self.connect_rate, self.connect_burst
        )
        if not bucket.take():
            self.rejected_total.inc(scope="connect", reason="tenant_quota")
            self.shed("connects_rejected")
            return "tenant-quota"
        self.admitted_total.inc(scope="connect")
        return None

    def admit_message(self, tenant: str) -> bool:
        """Message-ingress admission (one token per inbound frame).
        Over-quota frames are counted; the CALLER decides hard vs soft
        enforcement from the rung (close 1013 at RED)."""
        if not self.enabled:
            return True
        bucket = self._bucket(
            self._message_buckets, tenant, self.message_rate, self.message_burst
        )
        if bucket.take():
            return True
        self.rejected_total.inc(scope="message", reason="tenant_quota")
        self.shed("messages_throttled")
        return False

    def count_drain_rejection(self) -> None:
        """The drain path's 503 shares the rejection accounting."""
        self.rejected_total.inc(scope="upgrade", reason="draining")

    # -- sampler lifecycle ---------------------------------------------------

    def start(self) -> None:
        """Spawn the background sampler (measures event-loop lag and
        drives ladder evaluation); idempotent."""
        if self._sampler_task is None or self._sampler_task.done():
            self._sampler_task = asyncio.ensure_future(self._sampler())

    def stop(self) -> None:
        if self._sampler_task is not None:
            self._sampler_task.cancel()
            self._sampler_task = None

    async def _sampler(self) -> None:
        try:
            loop = asyncio.get_running_loop()
            while True:
                t0 = loop.time()
                await asyncio.sleep(self.sample_interval_s)
                lag_ms = max(loop.time() - t0 - self.sample_interval_s, 0.0) * 1000.0
                # fast-attack, slow-decay: one bad wake registers fully,
                # recovery needs sustained healthy wakes (smooths the
                # signal without hiding a spike from the ladder)
                self._loop_lag_ms = max(lag_ms, self._loop_lag_ms * 0.5)
                for listener in self.on_loop_lag:
                    try:
                        listener(self._loop_lag_ms)
                    except Exception:
                        pass
                self.sample()
        except asyncio.CancelledError:
            pass

    # -- exposition ----------------------------------------------------------

    def metrics(self) -> tuple:
        """Metric objects for MetricsRegistry.register adoption."""
        return (
            self.state_gauge,
            self.transitions_total,
            self.shed_total,
            self.admitted_total,
            self.rejected_total,
            self.signal_gauge,
            self.tenants_gauge,
        )

    def status(self) -> dict:
        """The full control-plane picture (`/debug/slo` embeds this)."""
        return {
            "enabled": self.enabled,
            "state": RUNG_NAMES[self.rung],
            "rung": self.rung,
            "hold_s": self.hold_s,
            "signals": self.last_signals,
            "shed": dict(self._shed_counts),
            "active_shed_reasons": self.active_shed_reasons(),
            "tenants": len(self._connect_buckets),
            "quotas": {
                "connect_rate": self.connect_rate,
                "connect_burst": self.connect_burst,
                "message_rate": self.message_rate,
                "message_burst": self.message_burst,
            },
            "transitions": list(self.transitions)[-20:],
        }

    def health_brief(self) -> dict:
        """The `/healthz` section: rung + what is actively being shed."""
        return {
            "state": RUNG_NAMES[self.rung],
            "rung": self.rung,
            "degraded": self.enabled and self.rung > GREEN,
            "shed_reasons": self.active_shed_reasons(),
        }


_default = OverloadController()


def get_overload_controller() -> OverloadController:
    return _default


class OverloadExtension(Extension):
    """Enables + configures the process-global controller and folds its
    state into `/healthz` (the 200-always convention holds: degraded is
    a steer signal for body-parsing probes, never a kill signal)."""

    # after Metrics (1000) so the wire collector is lit first, before
    # ordinary extensions
    priority = 990

    def __init__(self, controller: Optional[OverloadController] = None, **options: Any) -> None:
        self.controller = controller or get_overload_controller()
        self._options = options

    async def on_configure(self, data: Payload) -> None:
        self.controller.configure(**self._options).enable()

    async def on_listen(self, data: Payload) -> None:
        self.controller.start()

    def health_status(self) -> dict:
        return self.controller.health_brief()

    async def on_destroy(self, data: Payload) -> None:
        self.controller.stop()
        self.controller.disable()
