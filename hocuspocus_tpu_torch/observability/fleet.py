"""Fleet observability plane: telemetry federation + cross-tier tracing glue.

A split deployment runs stateless edges relaying to multi-device merge
cells, but every observability surface is per-process: answering
"is the fleet healthy?" meant curling N processes and stitching the
answers by hand. This module is the single pane:

- **Digests.** Every role (edge / cell / monolith) publishes a compact
  periodic telemetry digest — health rung, SLO burn rates, lane/queue
  depths, session counts, placement epoch, per-device cell stats — on the
  existing ``{prefix}:cells`` relay control channel (`edge/relay.DIGEST`
  envelopes). `build_digest` assembles one from the process-global
  collectors plus whatever the publishing role passes in `extra`.

- **`FleetView`.** A process-global singleton (like the wire collector,
  enabled by the `Metrics` extension) ingesting digests into a bounded
  per-peer ring. It serves ``GET /debug/fleet`` (role table, per-cell /
  per-device rollups, placement-epoch skew detection, stale-peer
  flagging), exports ``hocuspocus_fleet_*`` rollup gauges, and records
  topology transitions (`peer_up` / `peer_stale` / `peer_down` /
  `epoch_skew_detected`) in the flight recorder's ``__fleet__`` ring —
  silent drift is diagnosable after the fact, mirroring the
  ``__edge__``/``__overload__`` conventions.

- **Cross-tier trace plumbing.** `ClockOffsetEstimator` turns the edge's
  relay PING/PONG exchange into a smoothed peer-clock offset (NTP-style
  RTT midpoint), and `TraceReturnOutbox` carries a traced update's
  return context from the cell's trace book to the relay envelope headed
  back to the originating edge. The edge folds any one-way skew into the
  two relay spans (clamped at zero) so the full
  ``edge_ingress → relay_out → [cell stages] → relay_return →
  edge_egress`` chain still sums exactly to the edge-to-edge e2e — which
  feeds the ``hocuspocus_fleet_e2e_seconds`` histogram and the
  ``--slo-fleet-e2e-ms`` target.

Rollups skip peers that do not report a field (an edge has no documents;
a freshly-booted cell has no burn rates yet) instead of averaging zeros
in, and quantile reads guard on the observation count so an empty
histogram contributes nothing.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from typing import Any, Optional

from .flight_recorder import get_flight_recorder
from .metrics import Counter, Gauge, Histogram

DIGEST_VERSION = 1

# peers are stale after max(floor, STALE_INTERVALS x their own declared
# publish interval), and down after DOWN_FACTOR x the stale threshold;
# down peers are FORGOTTEN (rings, state, offsets dropped) once quiet
# past FORGET_FACTOR x the stale threshold — edges default to per-boot
# uuid identities, so a churning fleet mints new node ids forever and
# an unevicted peer table would grow without bound. MAX_PEERS is the
# hard backstop (oldest non-up peers shed first).
STALE_FLOOR_S = 5.0
STALE_INTERVALS = 3.0
DOWN_FACTOR = 5.0
FORGET_FACTOR = 20.0
MAX_PEERS = 256

# cross-tier stage names (the edge-side spans; the cell's interior
# stages are the existing update-lifecycle chain)
EDGE_STAGES = ("edge_ingress", "relay_out", "relay_return", "edge_egress")


def utc_stamp(ts: Optional[float] = None) -> str:
    """ISO-8601 UTC second-resolution stamp for attributable payloads."""
    return time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() if ts is None else ts)
    )


def stamp_header(payload: dict) -> dict:
    """The consistent top-level `{"generated_utc", "role", "node_id"}`
    header every /debug endpoint stamps, so aggregated or archived
    payloads stay attributable. Existing keys are never overwritten."""
    view = get_fleet_view()
    header = {
        "generated_utc": utc_stamp(),
        "role": view.role or "monolith",
        "node_id": view.node_id or f"pid-{_pid()}",
    }
    for key, value in header.items():
        payload.setdefault(key, value)
    return payload


def _pid() -> int:
    import os

    return os.getpid()


# -- digest assembly ----------------------------------------------------------


# digest publication identity: a per-process boot token + monotonic
# sequence lets FleetView.ingest drop the same published digest fanning
# back in through co-resident subscribers WITHOUT keying on the
# publisher's wall clock (an NTP step-back must never silently mute a
# live peer) and without confusing a restarted cell reusing its node id
# (new boot token => always fresh)
_BOOT = uuid.uuid4().hex[:12]
_digest_seq = itertools.count(1)


def build_digest(
    role: str,
    node_id: str,
    instance: Any = None,
    interval_s: Optional[float] = None,
    extra: Optional[dict] = None,
) -> dict:
    """One compact telemetry digest for `node_id`, pulled from the
    process-global collectors plus the publishing role's `extra` fields
    (which win on key collisions — an edge knows its own session count
    better than the instance walk does)."""
    digest: dict = {
        "v": DIGEST_VERSION,
        "role": role,
        "node_id": node_id,
        "ts_utc": time.time(),
        "boot": _BOOT,
        "seq": next(_digest_seq),
    }
    if interval_s is not None:
        digest["interval_s"] = interval_s
    try:
        from ..server.overload import RUNG_NAMES, get_overload_controller

        controller = get_overload_controller()
        digest["rung"] = (
            RUNG_NAMES[controller.rung] if controller.enabled else "green"
        )
    except Exception:
        digest["rung"] = "green"
    try:
        from .wire import get_wire_telemetry

        wire = get_wire_telemetry()
        if wire.enabled:
            digest["queues"] = {
                "send_queue_depth": wire.queue_depth_total(),
                "inbox_depth": wire.inbox_depth_total(),
            }
    except Exception:
        pass
    try:
        # per-node wire-saturation headroom (observability/costs.py):
        # every role publishes through build_digest, so /debug/fleet
        # shows the whole fleet's modeled frames/s budget in one table
        from .costs import get_cost_ledger

        ledger = get_cost_ledger()
        if ledger.enabled:
            headroom = ledger.headroom_frames_per_s()
            if headroom > 0:
                digest["headroom_frames_per_s"] = round(headroom, 1)
    except Exception:
        pass
    if instance is not None:
        _fold_instance(digest, instance)
    if extra:
        digest.update(extra)
    return digest


def _fold_instance(digest: dict, instance: Any) -> None:
    """Session/doc counts, SLO burn rates and per-device cell stats
    read off the instance's extension set (best-effort: a digest must
    never fail its publisher)."""
    try:
        digest["sessions"] = int(instance.get_connections_count())
        digest["docs"] = int(instance.get_documents_count())
    except Exception:
        pass
    extensions = getattr(instance, "_extensions", None)
    if extensions is None:
        extensions = getattr(
            getattr(instance, "configuration", None), "extensions", []
        )
    for ext in extensions or []:
        slo = getattr(ext, "slo", None)
        if slo is not None and hasattr(slo, "targets"):
            burns: dict = {}
            breaching: list = []
            try:
                # keep the windows warm: a digest built before the first
                # sampler tick must still carry burn rates — read the
                # engine's exported gauges (last computed values, 0.0
                # when a window has no traffic yet)
                slo.maybe_sample()
                for key, value in slo.burn_gauge._series.items():
                    labels = dict(key)
                    name = labels.get("slo")
                    window = labels.get("window")
                    if name and window:
                        burns.setdefault(name, {})[window] = round(value, 4)
                for target in slo.targets:
                    if slo.breaching(target):
                        breaching.append(target.name)
            except Exception:
                pass
            if burns:
                digest["slo_burn"] = burns
            if breaching:
                digest["slo_breaching"] = breaching
        cell_stats = getattr(ext, "cell_stats", None)
        if callable(cell_stats):
            try:
                digest["cells"] = [
                    {
                        key: stat.get(key)
                        for key in (
                            "cell",
                            "device",
                            "healthy",
                            "docs",
                            "rows_in_use",
                            "pending_ops",
                            "lane_queue_depth",
                            "work_units",
                        )
                    }
                    for stat in cell_stats()
                ]
                placement = getattr(ext, "placement", None)
                if placement is not None:
                    digest["placement_epoch"] = int(placement.epoch)
            except Exception:
                pass
        lane = getattr(ext, "lane", None)
        if lane is not None and callable(getattr(lane, "queue_depths", None)):
            try:
                digest.setdefault("queues", {})["lane_depth"] = int(
                    sum(lane.queue_depths())
                )
            except Exception:
                pass


# -- clock-offset estimation --------------------------------------------------


class ClockOffsetEstimator:
    """Peer-clock offset from PING/PONG round trips: the classic NTP
    midpoint — ``offset = t_peer - (t_sent + rtt/2)`` — smoothed with an
    EWMA, preferring low-RTT samples (a congested round trip bounds the
    one-way skew poorly, so it moves the estimate less)."""

    __slots__ = ("offset_s", "rtt_s", "samples", "_alpha")

    def __init__(self, alpha: float = 0.3) -> None:
        self.offset_s = 0.0
        self.rtt_s: Optional[float] = None
        self.samples = 0
        self._alpha = alpha

    def observe(self, t_sent: float, t_peer: float, t_recv: float) -> float:
        """Fold one round trip (all perf_counter seconds: `t_sent` and
        `t_recv` on OUR clock, `t_peer` on the peer's) into the
        estimate; returns the new smoothed offset (peer - local)."""
        rtt = max(t_recv - t_sent, 0.0)
        sample = t_peer - (t_sent + rtt / 2.0)
        if self.samples == 0:
            self.offset_s = sample
            self.rtt_s = rtt
        else:
            # a high-RTT sample carries more midpoint uncertainty:
            # shrink its weight by how much worse it is than the best
            weight = self._alpha
            if self.rtt_s is not None and rtt > 0 and self.rtt_s > 0:
                weight *= min(self.rtt_s / rtt, 1.0)
            self.offset_s += weight * (sample - self.offset_s)
            self.rtt_s = min(self.rtt_s, rtt) if self.rtt_s is not None else rtt
        self.samples += 1
        return self.offset_s


# -- cross-tier trace return path ---------------------------------------------


class TraceReturnOutbox:
    """Holds finished cross-tier trace contexts between the cell's trace
    book closing a trace (the flush cycle's readback barrier — which
    lands AFTER the encode-once broadcast frame already left, fan-out
    being host-decoupled) and the cell's relay machinery shipping them
    back to the stamping edge as TRACE_RET envelopes. `add_waker` is
    the cell's wake-up seam: deposits can come from the flush executor
    thread, so callbacks must be thread-safe (the cell ingress uses
    `call_soon_threadsafe`). Bounded: returns nobody drains (no cell
    role bound) are shed oldest-first with accounting, never leaked."""

    MAX_PENDING = 1024

    def __init__(self) -> None:
        # doc -> list of return contexts, insertion-ordered. Deposits
        # arrive from the flush executor thread while the cell drains on
        # the event loop: the compound dict+counter updates take a real
        # lock (same discipline as UpdateTraceBook's RLock — GIL
        # atomicity does not cover a setdefault racing a drain swap).
        self._lock = threading.Lock()
        self._pending: "dict[str, list[dict]]" = {}
        self.pending = 0
        self.dropped = 0
        # wake-up subscribers (one per serving cell in this process):
        # a SET, not a slot — one cell's teardown must not unhook its
        # in-process siblings
        self._wakers: "set[Any]" = set()

    def add_waker(self, callback: Any) -> None:
        self._wakers.add(callback)

    def remove_waker(self, callback: Any) -> None:
        self._wakers.discard(callback)

    def deposit(self, doc: str, context: dict) -> None:
        with self._lock:
            while self.pending >= self.MAX_PENDING and self._pending:
                key = next(iter(self._pending))
                shed = self._pending.pop(key)
                self.pending -= len(shed)
                self.dropped += len(shed)
            self._pending.setdefault(doc, []).append(context)
            self.pending += 1
        for callback in list(self._wakers):
            try:
                callback()
            except Exception:
                pass  # a broken drain seam must not fail the trace close

    def take(self, doc: str) -> "Optional[list[dict]]":
        with self._lock:
            contexts = self._pending.pop(doc, None)
            if contexts:
                self.pending -= len(contexts)
            return contexts

    def take_all(self) -> "dict[str, list[dict]]":
        with self._lock:
            drained, self._pending = self._pending, {}
            self.pending = 0
            return drained

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self.pending = 0


# -- the aggregator -----------------------------------------------------------


class FleetView:
    """Bounded per-peer digest rings + the /debug/fleet rollup."""

    def __init__(self, max_digests_per_peer: int = 32) -> None:
        self.enabled = False
        self.role: Optional[str] = None
        self.node_id: Optional[str] = None
        self.max_digests_per_peer = max_digests_per_peer
        # peer node_id -> deque of digests (newest last)
        self.peers: "dict[str, deque]" = {}
        # peer node_id -> {"last_seen": monotonic, "state": up|stale|down}
        self._peer_state: "dict[str, dict]" = {}
        self._skew_roles: "set[str]" = set()  # roles currently flagged
        self.counters = {
            "digests_ingested": 0,
            "digests_invalid": 0,
            "peers_marked_down": 0,
        }
        self.trace_returns = TraceReturnOutbox()
        self.offsets: "dict[str, ClockOffsetEstimator]" = {}
        # set via attach_autoscale by the elastic-fleet controller
        self.autoscale_status = None
        # cross-tier e2e: the edge-to-edge latency series the fleet SLO
        # targets (stage="total"), plus the four edge-side stages
        self.e2e_histogram = Histogram(
            "hocuspocus_fleet_e2e_seconds",
            "Cross-tier (edge→cell→edge) update latency by stage "
            "(docs/guides/observability.md fleet view)",
        )
        self.digests_total = Counter(
            "hocuspocus_fleet_digests_ingested_total",
            "Telemetry digests ingested into the fleet view, by role",
        )
        self.peers_gauge = Gauge(
            "hocuspocus_fleet_peers",
            "Live (non-stale) fleet peers by role",
        )
        # fn gauges read the LAST-swept peer states: the scrape handler
        # calls refresh_gauges() (one sweep) right before exposition, so
        # per-gauge re-sweeps would just repeat the same table walk
        self.stale_gauge = Gauge(
            "hocuspocus_fleet_stale_peers",
            "Fleet peers whose digests went quiet past their threshold",
            fn=lambda: len(self._stale_ids()),
        )
        self.sessions_gauge = Gauge(
            "hocuspocus_fleet_sessions",
            "Client sessions summed over fresh fleet peers",
            fn=lambda: self._sum_field("sessions"),
        )
        self.docs_gauge = Gauge(
            "hocuspocus_fleet_docs",
            "Documents summed over fresh fleet peers",
            fn=lambda: self._sum_field("docs"),
        )
        self.epoch_skew_gauge = Gauge(
            "hocuspocus_fleet_epoch_skew",
            "1 when fresh peers of a role disagree on placement epoch",
        )

    # -- identity / lifecycle ----------------------------------------------

    def enable(self) -> "FleetView":
        self.enabled = True
        return self

    def set_identity(
        self, role: str, node_id: str, force: bool = True
    ) -> None:
        if force or self.role is None:
            self.role = role
            self.node_id = node_id

    def offset_for(self, peer_id: str) -> ClockOffsetEstimator:
        estimator = self.offsets.get(peer_id)
        if estimator is None:
            estimator = self.offsets[peer_id] = ClockOffsetEstimator()
        return estimator

    def attach_autoscale(self, status_fn) -> None:
        """The elastic-fleet controller (fleet/controller.py) hangs its
        live status here; `/debug/fleet` renders it as the `autoscale`
        section. Pass None to detach (controller teardown)."""
        self.autoscale_status = status_fn

    def reset(self) -> None:
        """Back to a cold state (tests / scenario-runner isolation):
        peers, counters, offsets, identity, the e2e histogram and the
        trace outbox all clear; enablement persists. The next role to
        configure claims the identity again."""
        self.role = None
        self.node_id = None
        self.autoscale_status = None
        self.peers.clear()
        self._peer_state.clear()
        self._skew_roles.clear()
        self.offsets.clear()
        self.trace_returns.clear()
        for key in self.counters:
            self.counters[key] = 0
        self.e2e_histogram._series.clear()
        self.digests_total._values.clear()
        self.peers_gauge._series.clear()
        self.epoch_skew_gauge._series.clear()

    # -- ingest -------------------------------------------------------------

    def ingest(self, digest: Any) -> bool:
        """Fold one digest (local or off the control channel) into the
        per-peer ring. Returns False (counted) for malformed digests."""
        if (
            not isinstance(digest, dict)
            or digest.get("v") != DIGEST_VERSION
            or not digest.get("node_id")
            or not digest.get("role")
        ):
            self.counters["digests_invalid"] += 1
            return False
        node_id = str(digest["node_id"])
        state = self._peer_state.get(node_id)
        boot = digest.get("boot")
        seq = digest.get("seq")
        if (
            state is not None
            and boot is not None
            and isinstance(seq, int)
            and state.get("boot") == boot
            and state.get("last_seq") is not None
            and seq <= state["last_seq"]
        ):
            # one published digest fans back in once per co-resident
            # subscriber (the publisher ingests locally AND every role
            # in this process watches the control channel): the echoes
            # would inflate the ingest counters and burn the bounded
            # ring N-fold, so a digest not newer (same boot, seq not
            # above the high-water mark) than the peer's latest is
            # acknowledged without re-ingesting. Keyed on boot+seq, not
            # the publisher's wall clock: a clock step-back must never
            # mute a live peer, and a restarted cell reusing its node id
            # carries a fresh boot token.
            return True
        ring = self.peers.get(node_id)
        if ring is None:
            ring = self.peers[node_id] = deque(maxlen=self.max_digests_per_peer)
        ring.append(digest)
        now = time.monotonic()
        if state is None:
            state = self._peer_state[node_id] = {"last_seen": now, "state": "up"}
            get_flight_recorder().record(
                "__fleet__", "peer_up", peer=node_id, role=digest["role"]
            )
        else:
            if state["state"] != "up":
                get_flight_recorder().record(
                    "__fleet__", "peer_up", peer=node_id, role=digest["role"]
                )
            state["last_seen"] = now
            state["state"] = "up"
        if boot is not None and isinstance(seq, int):
            state["boot"] = boot
            state["last_seq"] = seq
        self.counters["digests_ingested"] += 1
        self.digests_total.inc(role=str(digest["role"]))
        self._sweep(now)
        return True

    def mark_down(self, node_id: str) -> None:
        """An explicit departure (CELL_DOWN on the control channel):
        flip the peer to down without waiting out the stale window."""
        state = self._peer_state.get(node_id)
        if state is None or state["state"] == "down":
            return
        state["state"] = "down"
        self.counters["peers_marked_down"] += 1
        get_flight_recorder().record("__fleet__", "peer_down", peer=node_id)

    # -- freshness ----------------------------------------------------------

    def _stale_after(self, node_id: str) -> float:
        ring = self.peers.get(node_id)
        interval = None
        if ring:
            interval = ring[-1].get("interval_s")
        if not interval:
            return STALE_FLOOR_S
        return max(STALE_FLOOR_S, STALE_INTERVALS * float(interval))

    def _sweep(self, now: Optional[float] = None) -> None:
        """Re-evaluate peer freshness + epoch skew, recording each
        transition once in the __fleet__ ring (called on ingest and on
        every status/metrics read — no timer needed)."""
        if now is None:
            now = time.monotonic()
        forgotten = []
        for node_id, state in self._peer_state.items():
            age = now - state["last_seen"]
            threshold = self._stale_after(node_id)
            if state["state"] == "down":
                if age > FORGET_FACTOR * threshold:
                    forgotten.append(node_id)
                continue
            if state["state"] == "up" and age > threshold:
                state["state"] = "stale"
                get_flight_recorder().record(
                    "__fleet__",
                    "peer_stale",
                    peer=node_id,
                    age_s=round(age, 1),
                    threshold_s=round(threshold, 1),
                )
            elif state["state"] == "stale" and age > DOWN_FACTOR * threshold:
                state["state"] = "down"
                get_flight_recorder().record(
                    "__fleet__", "peer_down", peer=node_id, age_s=round(age, 1)
                )
        for node_id in forgotten:
            self._forget_peer(node_id)
        if len(self._peer_state) > MAX_PEERS:
            # hard backstop: shed non-up peers first (the __fleet__ ring
            # keeps their down transition for forensics), then — when a
            # fleet genuinely outgrows the cap and every peer is fresh —
            # the quietest up peers too, so the cap really caps
            evictable = sorted(
                (state["state"] == "up", state["last_seen"], node_id)
                for node_id, state in self._peer_state.items()
            )
            for _up, _seen, node_id in evictable[
                : len(self._peer_state) - MAX_PEERS
            ]:
                self._forget_peer(node_id)
        skew = self._epoch_skew()
        for role, info in skew.items():
            if info["skew"] and role not in self._skew_roles:
                self._skew_roles.add(role)
                get_flight_recorder().record(
                    "__fleet__",
                    "epoch_skew_detected",
                    role=role,
                    epochs=",".join(
                        f"{peer}={epoch}" for peer, epoch in info["epochs"].items()
                    ),
                )
            elif not info["skew"]:
                self._skew_roles.discard(role)

    def _forget_peer(self, node_id: str) -> None:
        self.peers.pop(node_id, None)
        self._peer_state.pop(node_id, None)
        self.offsets.pop(node_id, None)

    def peer_state(self, node_id: str) -> Optional[str]:
        state = self._peer_state.get(node_id)
        return None if state is None else state["state"]

    def _fresh_ids(self) -> "list[str]":
        """Up peers per the LAST sweep (no re-evaluation — callers that
        are entry points sweep once and pass results down rather than
        re-walking the table per read)."""
        return [
            node_id
            for node_id, state in self._peer_state.items()
            if state["state"] == "up"
        ]

    def _stale_ids(self) -> "list[str]":
        return sorted(
            node_id
            for node_id, state in self._peer_state.items()
            if state["state"] != "up"
        )

    def fresh_peers(self) -> "list[str]":
        self._sweep()
        return self._fresh_ids()

    def stale_peers(self) -> "list[str]":
        self._sweep()
        return self._stale_ids()

    def _latest(self, node_id: str) -> Optional[dict]:
        ring = self.peers.get(node_id)
        return ring[-1] if ring else None

    def _sum_field(self, field: str, fresh: "Optional[list[str]]" = None) -> int:
        """Sum a digest field over FRESH peers, skipping peers that do
        not report it — an edge has no docs and a booting cell has no
        sessions yet; averaging zeros in would understate the fleet.
        `fresh=None` reads the last-swept states (the scrape path and
        status() both sweep once up front)."""
        total = 0
        for node_id in self._fresh_ids() if fresh is None else fresh:
            digest = self._latest(node_id)
            value = None if digest is None else digest.get(field)
            if value is not None:
                total += int(value)
        return total

    def _epoch_skew(self) -> "dict[str, dict]":
        """Per-role epoch agreement over fresh (up) peers. Skew is only
        meaningful where peers derive an epoch from a SHARED event
        stream, and each role now has one: edge router epochs ride the
        control channel (as before), and — since the roster went
        dynamic (fleet/roster.py) — cells fold the same control-channel
        membership transitions into a `roster_epoch` published in their
        digests. Cell *placement* epochs remain local per-instance
        bookkeeping: reported, never flagged."""
        placement_by_role: "dict[str, dict[str, int]]" = {}
        roster_by_role: "dict[str, dict[str, int]]" = {}
        for node_id, state in self._peer_state.items():
            if state["state"] != "up":
                continue
            digest = self._latest(node_id)
            if digest is None:
                continue
            role = str(digest["role"])
            if digest.get("placement_epoch") is not None:
                placement_by_role.setdefault(role, {})[node_id] = int(
                    digest["placement_epoch"]
                )
            if digest.get("roster_epoch") is not None:
                roster_by_role.setdefault(role, {})[node_id] = int(
                    digest["roster_epoch"]
                )
        result: "dict[str, dict]" = {}
        for role in set(placement_by_role) | set(roster_by_role):
            epochs = placement_by_role.get(role, {})
            rosters = roster_by_role.get(role, {})
            skew = (
                role == "edge" and len(set(epochs.values())) > 1
            ) or len(set(rosters.values())) > 1
            result[role] = {
                "epochs": epochs,
                "roster_epochs": rosters,
                "skew": skew,
            }
        return result

    # -- cross-tier latency --------------------------------------------------

    def record_cross_tier(self, stage: str, seconds: float) -> None:
        self.e2e_histogram.observe(max(seconds, 0.0), stage=stage)

    def cross_tier_quantiles(self) -> Optional[dict]:
        """p50/p99 of the edge-to-edge e2e series, or None when no
        cross-tier trace has completed (never a fabricated zero)."""
        count = self.e2e_histogram.series_count(stage="total")
        if count == 0:
            return None
        return {
            "p50_ms": round(
                self.e2e_histogram.quantile(0.5, stage="total") * 1000.0, 3
            ),
            "p99_ms": round(
                self.e2e_histogram.quantile(0.99, stage="total") * 1000.0, 3
            ),
            "count": count,
        }

    # -- exposition ----------------------------------------------------------

    def metrics(self) -> tuple:
        """Metric objects for MetricsRegistry.register adoption."""
        return (
            self.e2e_histogram,
            self.digests_total,
            self.peers_gauge,
            self.stale_gauge,
            self.sessions_gauge,
            self.docs_gauge,
            self.epoch_skew_gauge,
        )

    def refresh_gauges(self) -> None:
        """Re-label the rollup gauges from the current peer table
        (called at scrape time by the Metrics extension)."""
        self._sweep()
        by_role: "dict[str, int]" = {}
        for node_id, state in self._peer_state.items():
            if state["state"] != "up":
                continue
            digest = self._latest(node_id)
            if digest is not None:
                role = str(digest["role"])
                by_role[role] = by_role.get(role, 0) + 1
        self.peers_gauge._series.clear()
        for role, count in by_role.items():
            self.peers_gauge.set(count, role=role)
        self.epoch_skew_gauge._series.clear()
        for role, info in self._epoch_skew().items():
            self.epoch_skew_gauge.set(1.0 if info["skew"] else 0.0, role=role)

    def status(self) -> dict:
        """The `/debug/fleet` payload. One sweep up front; every
        freshness-derived section below reads the swept states instead
        of re-walking the table."""
        self._sweep()
        fresh = self._fresh_ids()
        now = time.monotonic()
        peers: dict = {}
        roles: "dict[str, list]" = {}
        cells: dict = {}
        for node_id in sorted(self._peer_state):
            state = self._peer_state[node_id]
            digest = self._latest(node_id)
            if digest is None:
                continue
            role = str(digest["role"])
            roles.setdefault(role, []).append(node_id)
            entry = {
                "role": role,
                "state": state["state"],
                "age_s": round(now - state["last_seen"], 2),
                "rung": digest.get("rung"),
                "digests": len(self.peers.get(node_id) or ()),
            }
            for key in (
                "sessions",
                "docs",
                "placement_epoch",
                "roster_epoch",
                "slo_burn",
                "slo_breaching",
                "queues",
                "headroom_frames_per_s",
                "edge",
                "cell",
                "replica",
            ):
                value = digest.get(key)
                if value is not None:
                    entry[key] = value
            replica = digest.get("replica")
            if isinstance(replica, dict):
                # the hot-doc followers column: how many follower
                # subscriptions this cell is serving (owner side) and
                # how many docs it follows (replica side)
                entry["followers"] = sum(
                    len(owned.get("followers") or ())
                    for owned in (replica.get("owned") or {}).values()
                )
                entry["following"] = len(replica.get("following") or ())
            peers[node_id] = entry
            if digest.get("cells") is not None:
                cells[node_id] = digest["cells"]
        payload = {
            "peers": peers,
            "roles": {role: sorted(ids) for role, ids in sorted(roles.items())},
            "cells": cells,
            "epoch_skew": self._epoch_skew(),
            "stale_peers": self._stale_ids(),
            "totals": {
                "peers": len(peers),
                "fresh": len(fresh),
                "sessions": self._sum_field("sessions", fresh),
                "docs": self._sum_field("docs", fresh),
                "followers": sum(
                    entry.get("followers", 0)
                    for node_id, entry in peers.items()
                    if self._peer_state[node_id]["state"] == "up"
                ),
            },
            "cross_tier_e2e_ms": self.cross_tier_quantiles(),
            "counters": dict(self.counters),
        }
        if self.autoscale_status is not None:
            # live controller state (roster, last decision, park
            # reason) — attached by FleetControllerExtension, and a
            # status read must never take /debug/fleet down with it
            try:
                payload["autoscale"] = self.autoscale_status()
            except Exception:
                payload["autoscale"] = {"error": "unavailable"}
        return stamp_header(payload)


# The process-default view every role publishes into. Disabled by
# default; the Metrics extension enables it (like the wire collector).
_default = FleetView()


def get_fleet_view() -> FleetView:
    return _default
