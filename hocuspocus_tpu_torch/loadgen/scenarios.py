"""Built-in scenario library: the production mixes the paper promises.

Each factory returns a :class:`~.scenario.Scenario` sized by keyword
arguments (defaults are CI-scale; pass bigger numbers for real storms).
``get_scenario(name, **overrides)`` resolves by registry name — the
``python -m hocuspocus_tpu_torch.loadgen`` CLI and ``chip_smoke.py`` go
through it. The library is the reference's, every scenario included;
the port runs the single-plane ones (``smoke``, ``replication_lag``,
``overload_storm``, ``partition_heal``, ``wire_saturation``) and the edge
ones (``edge_fanout``, ``edge_handoff``, ``mega_audience``), and raises
NotImplementedError for the sharded and multi-device ones (ROADMAP.md,
Queue A item 7).

The mixes (ROADMAP item 5, Collabs arXiv:2212.02618 composed multi-user
workloads, Eg-walker arXiv:2409.14252 realistic-concurrency merges):

- ``smoke``            — tiny three-phase mix for tier-1 CI
- ``diurnal``          — trough → ramp → peak → ramp-down edit rates
- ``flash_crowd``      — a join storm lands on one hot doc mid-run
- ``reconnect_herd``   — flaky-mobile clients drop and resync in herds
- ``mega_doc``         — one outsized doc among thousands of small ones
- ``replication_lag``  — cross-instance lag injected into mini_redis
- ``storm``            — flash crowd + reconnect herd composed (slow)
- ``overload_storm``   — injected RED pressure: brownout shedding +
  admission rejections while interactive p99 holds, hysteresis-clean
  recovery to GREEN
- ``partition_heal``   — one-way mini_redis partition, accounted drops,
  anti-entropy heal to byte-identical convergence
- ``edge_fanout``      — split front door: edge-terminated join storm +
  cross-edge fan-out over two merge cells
- ``edge_handoff``     — mid-run cell drain: transparent handoff, zero
  acked-update loss, byte-identical convergence
- ``multi_device_storm`` — hot-doc skew on the per-chip cell plane: one
  mega-doc plus a small-doc population forces load-aware rebalancing
  mid-run (docs migrate between device cells with zero acked loss)
- ``diurnal_autoscale`` — the diurnal ramp with the elastic-fleet
  controller on: SLOs hold through the peak while the steady-trough
  active-cell footprint drops to warm spares (ratio latched into the
  verdict and gated)
- ``mega_audience``    — one viral doc, few writers, a huge read
  audience through the edge tier: the replica watermark grows follower
  cells and the fan-out spreads across them (owner work stays bounded)
- ``wire_saturation`` — ramping ingress edit rate with the per-frame
  cost ledger on: the runner attaches offered vs. achieved frames/s per
  rung, the headroom model's sustainable rate and the top-5 cost
  attribution as ``extra.wire_saturation``
"""

from __future__ import annotations

import random
from typing import Callable

from .scenario import OpEvent, PhaseSpec, Scenario


def _spread(rng: random.Random, count: int, duration_ms: int) -> "list[int]":
    """`count` op times spread over the phase with seeded jitter."""
    if count <= 0:
        return []
    step = duration_ms / count
    return sorted(
        min(int(i * step + rng.random() * step), duration_ms - 1)
        for i in range(count)
    )


def _edit_gen(
    rate_per_s: float,
    size_lo: int = 8,
    size_hi: int = 24,
    mega_every: int = 0,
    mega_lo: int = 192,
    mega_hi: int = 384,
    background: bool = False,
) -> Callable:
    """Steady random-doc edit traffic at `rate_per_s` (logical time).

    With ``mega_every`` = N, every Nth op targets doc 0 with a
    mega-sized insert — the one-big-doc-among-thousands mix. With
    ``background`` the edits are fire-and-forget even on sampled docs
    (``OpEvent.value = 1``) — traffic that must keep flowing while its
    observation channel is deliberately broken (a partition phase)."""

    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        count = max(int(rate_per_s * phase.duration_ms / 1000), 1)
        ops = []
        for i, at in enumerate(_spread(rng, count, phase.duration_ms)):
            if mega_every and i % mega_every == 0:
                doc, size = 0, rng.randrange(mega_lo, mega_hi)
            else:
                doc = rng.randrange(scenario.num_docs)
                size = rng.randrange(size_lo, size_hi)
            ops.append(
                OpEvent(
                    at,
                    phase.name,
                    "edit",
                    doc=doc,
                    size=size,
                    value=1 if background else 0,
                )
            )
        return ops

    return gen


def _compose(*gens: Callable) -> Callable:
    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        ops = []
        for sub in gens:
            ops.extend(sub(rng, scenario, phase))
        return ops

    return gen


def _join_storm_gen(joins: int, doc: int = 0, window_frac: float = 0.5) -> Callable:
    """`joins` new clients pile onto one hot doc inside the first
    `window_frac` of the phase — the flash-crowd front edge."""

    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        window = max(int(phase.duration_ms * window_frac), 1)
        return [
            OpEvent(at, phase.name, "join", doc=doc, value=i)
            for i, at in enumerate(_spread(rng, joins, window))
        ]

    return gen


def _leave_gen(leaves: int, doc: int = 0) -> Callable:
    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        return [
            OpEvent(at, phase.name, "leave", doc=doc)
            for at in _spread(rng, leaves, phase.duration_ms)
        ]

    return gen


def _reconnect_gen(reconnects: int) -> Callable:
    """Flaky-mobile herd: measured docs drop and resync repeatedly."""

    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        return [
            OpEvent(
                at,
                phase.name,
                "reconnect",
                doc=rng.randrange(max(scenario.sampled, 1)),
            )
            for at in _spread(rng, reconnects, phase.duration_ms)
        ]

    return gen


def _lag_gen(lag_ms: int, at_ms: int = 0) -> Callable:
    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        return [OpEvent(at_ms, phase.name, "lag", value=lag_ms)]

    return gen


def _partition_gen(on: bool, at_ms: int = 0) -> Callable:
    """Start (on=True) or heal (on=False) the one-way mini_redis
    partition of instance 0's publisher."""

    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        return [OpEvent(at_ms, phase.name, "partition", value=1 if on else 0)]

    return gen


def _overload_gen(rung: int, at_ms: int = 0) -> Callable:
    """Inject `rung` rungs of synthetic pressure into the overload
    ladder (0 clears)."""

    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        return [OpEvent(at_ms, phase.name, "overload", value=rung)]

    return gen


def _drain_gen(cell: int, at_ms: int = 0) -> Callable:
    """Gracefully drain merge cell `cell` (edge topologies): the cell
    announces departure, the router remaps, edges re-establish."""

    def gen(rng: random.Random, scenario: Scenario, phase: PhaseSpec):
        return [OpEvent(at_ms, phase.name, "drain", value=cell)]

    return gen


# -- the library -------------------------------------------------------------


def smoke(
    num_docs: int = 6,
    phase_ms: int = 800,
    rate: float = 20.0,
) -> Scenario:
    """Tier-1 CI mix: edits, one tiny join wave, a leave — seconds on CPU."""
    return Scenario(
        name="smoke",
        description="tiny three-phase mix proving the harness end to end",
        num_docs=num_docs,
        sampled=min(4, num_docs),
        shards=1,
        capacity=512,
        shard_rows=max(num_docs * 2, 16),
        docs_per_socket=num_docs,
        phases=[
            PhaseSpec("warm", phase_ms, _edit_gen(rate), slo_e2e_ms=1000.0),
            PhaseSpec(
                "burst",
                phase_ms,
                _compose(_edit_gen(rate * 2), _join_storm_gen(2)),
                slo_e2e_ms=1000.0,
            ),
            PhaseSpec(
                "cool",
                phase_ms,
                _compose(_edit_gen(rate / 2), _leave_gen(2)),
                slo_e2e_ms=1000.0,
            ),
        ],
    )


def diurnal(
    num_docs: int = 48,
    phase_ms: int = 2000,
    peak_rate: float = 120.0,
) -> Scenario:
    """A day of traffic compressed into four phases: trough, morning
    ramp, peak, evening ramp-down. The peak phase carries the tight
    SLO; the trough proves the idle floor doesn't rot."""
    return Scenario(
        name="diurnal",
        description="diurnal ramp: trough -> ramp -> peak -> ramp-down",
        num_docs=num_docs,
        sampled=min(12, num_docs),
        shards=2,
        capacity=768,
        phases=[
            PhaseSpec("trough", phase_ms, _edit_gen(peak_rate / 8)),
            PhaseSpec("ramp_up", phase_ms, _edit_gen(peak_rate / 2)),
            PhaseSpec("peak", phase_ms, _edit_gen(peak_rate), slo_e2e_ms=500.0),
            PhaseSpec("ramp_down", phase_ms, _edit_gen(peak_rate / 4)),
        ],
    )


def flash_crowd(
    num_docs: int = 32,
    joins: int = 24,
    phase_ms: int = 2000,
) -> Scenario:
    """A hot doc goes viral: a join storm lands mid-run while steady
    edits continue everywhere (the join-storm sync cache under a
    composed mix, not an isolated pass)."""
    return Scenario(
        name="flash_crowd",
        description="flash-crowd join storm on one hot doc",
        num_docs=num_docs,
        sampled=min(8, num_docs),
        shards=2,
        capacity=768,
        params={"joins": joins},
        phases=[
            PhaseSpec("steady", phase_ms, _edit_gen(40.0)),
            PhaseSpec(
                "storm",
                phase_ms,
                _compose(_edit_gen(40.0), _join_storm_gen(joins)),
                slo_e2e_ms=1000.0,
                slo_objective=0.90,
            ),
            PhaseSpec(
                "drain",
                phase_ms,
                _compose(_edit_gen(20.0), _leave_gen(joins)),
            ),
        ],
    )


def reconnect_herd(
    num_docs: int = 32,
    reconnects: int = 16,
    phase_ms: int = 2000,
) -> Scenario:
    """Flaky-mobile herd: a subway tunnel's worth of clients drop and
    resync while edits continue — catch-up tiering and SyncStep2 under
    churn, measured as resync latency."""
    return Scenario(
        name="reconnect_herd",
        description="flaky-mobile reconnect herd over steady edits",
        num_docs=num_docs,
        sampled=min(8, num_docs),
        shards=2,
        capacity=768,
        params={"reconnects": reconnects},
        phases=[
            PhaseSpec("steady", phase_ms, _edit_gen(40.0)),
            PhaseSpec(
                "herd",
                phase_ms,
                _compose(_edit_gen(40.0), _reconnect_gen(reconnects)),
                slo_e2e_ms=2000.0,
                slo_objective=0.90,
            ),
            PhaseSpec("recovered", phase_ms, _edit_gen(40.0)),
        ],
    )


def mega_doc(
    num_docs: int = 64,
    phase_ms: int = 2000,
) -> Scenario:
    """One mega-document among a small-doc population: every 4th op is
    an outsized insert into doc 0. The merge plane must keep the small
    docs' latency flat while the mega doc's row grows."""
    return Scenario(
        name="mega_doc",
        description="one mega-doc among a population of small docs",
        num_docs=num_docs,
        sampled=min(8, num_docs),
        shards=2,
        capacity=4096,
        mega_doc=True,
        phases=[
            PhaseSpec("steady", phase_ms, _edit_gen(40.0, mega_every=8)),
            PhaseSpec(
                "mega_burst",
                phase_ms,
                _edit_gen(60.0, mega_every=4),
                slo_e2e_ms=1000.0,
            ),
            PhaseSpec("settle", phase_ms, _edit_gen(30.0, mega_every=8)),
        ],
    )


def replication_lag(
    num_docs: int = 16,
    phase_ms: int = 1500,
    lag_ms: int = 40,
) -> Scenario:
    """Cross-instance mix: writers on instance A, readers on instance B
    through mini_redis; the middle phase injects publish latency, so the
    lagged phase's SLO must absorb exactly the injected delay — and the
    recovered phase must return to the healthy budget."""
    return Scenario(
        name="replication_lag",
        description="cross-instance replication lag via mini_redis injection",
        num_docs=num_docs,
        sampled=min(6, num_docs),
        instances=2,
        shards=1,
        capacity=512,
        docs_per_socket=num_docs,
        params={"lag_ms": lag_ms},
        phases=[
            PhaseSpec("healthy", phase_ms, _edit_gen(24.0), slo_e2e_ms=1000.0),
            PhaseSpec(
                "lagged",
                phase_ms,
                _compose(_lag_gen(lag_ms), _edit_gen(24.0)),
                slo_e2e_ms=2000.0,
                slo_objective=0.90,
            ),
            PhaseSpec(
                "recovered",
                phase_ms,
                _compose(_lag_gen(0), _edit_gen(24.0)),
                slo_e2e_ms=1000.0,
            ),
        ],
    )


def storm(
    num_docs: int = 64,
    joins: int = 48,
    reconnects: int = 32,
    phase_ms: int = 3000,
) -> Scenario:
    """The composed worst hour: flash crowd AND reconnect herd over a
    peak edit rate — the slow-marked stress scenario."""
    return Scenario(
        name="storm",
        description="composed flash crowd + reconnect herd at peak rate",
        num_docs=num_docs,
        sampled=min(12, num_docs),
        shards=4,
        capacity=768,
        params={"joins": joins, "reconnects": reconnects},
        phases=[
            PhaseSpec("build_up", phase_ms, _edit_gen(60.0)),
            PhaseSpec(
                "landfall",
                phase_ms,
                _compose(
                    _edit_gen(80.0),
                    _join_storm_gen(joins),
                    _reconnect_gen(reconnects),
                ),
                slo_e2e_ms=2000.0,
                slo_objective=0.85,
            ),
            PhaseSpec(
                "aftermath",
                phase_ms,
                _compose(_edit_gen(40.0), _leave_gen(joins)),
            ),
        ],
    )


def overload_storm(
    num_docs: int = 12,
    phase_ms: int = 1200,
    joins: int = 3,
    hold_s: float = 0.1,
) -> Scenario:
    """The overload control plane under deterministic pressure
    (docs/guides/overload.md): a calm phase, then synthetic RED-rung
    pressure lands WITH a join wave — the ladder must reject the new
    joins (shed/reject counters go nonzero) while the already-admitted
    interactive edits keep their p99, then a recovery phase clears the
    pressure and the ladder must walk back to GREEN one rung per hold
    window (hysteresis-clean: the flight recorder shows a monotonic
    descent, never a flap). The runner installs an OverloadExtension
    from ``params["overload"]`` and attaches the controller's
    transition/shed evidence to the artifact."""
    return Scenario(
        name="overload_storm",
        description="brownout ladder + admission under injected RED pressure",
        num_docs=num_docs,
        sampled=min(6, num_docs),
        shards=1,
        capacity=512,
        docs_per_socket=num_docs,
        params={
            "overload": {
                "hold_s": hold_s,
                "sample_interval_s": min(hold_s / 2, 0.05),
                "awareness_stretch_ms": 100.0,
                "catchup_retry_s": 0.1,
                # the INJECTED signal alone drives this scenario's
                # ladder: ambient signals (loop lag on a loaded CI
                # runner, send queues) are parked far out of range so
                # the transition path is deterministic
                "thresholds": {
                    "loop_lag_ms": (1e7, 2e7, 3e7),
                    "send_queue_depth": (1e7, 2e7, 3e7),
                    "backpressure_per_s": (1e7, 2e7, 3e7),
                    "lane_depth": (1e7, 2e7, 3e7),
                    "wal_commit_ms": (1e7, 2e7, 3e7),
                    "inbox_depth": (1e7, 2e7, 3e7),
                },
            }
        },
        phases=[
            PhaseSpec("calm", phase_ms, _edit_gen(20.0), slo_e2e_ms=1000.0),
            PhaseSpec(
                "storm",
                phase_ms,
                _compose(
                    _overload_gen(3),  # straight to RED at phase start
                    _edit_gen(40.0),
                    _join_storm_gen(joins),
                ),
                # the acceptance bar: interactive edit p99 HOLDS while
                # the ladder sheds — the joins are the sacrificed load
                # (they fail fast with permission-denied), so the
                # op-success objective tolerates exactly them
                slo_e2e_ms=1000.0,
                slo_objective=0.90,
                error_objective=0.85,
            ),
            PhaseSpec(
                "recover",
                phase_ms,
                _compose(_overload_gen(0), _edit_gen(20.0)),
                slo_e2e_ms=1000.0,
            ),
        ],
    )


def partition_heal(
    num_docs: int = 8,
    phase_ms: int = 1500,
    anti_entropy_s: float = 0.25,
) -> Scenario:
    """Partition-heal chaos (docs/guides/overload.md): writers on
    instance A, readers on instance B; the middle phase one-way
    blackholes A's publishes at the mini_redis hop (every drop is
    accounted in ``dropped_partition`` — zero silent loss) while edits
    keep flowing fire-and-forget; the heal phase ends the partition and
    measures edits end to end again — their latency INCLUDES the
    anti-entropy exchange that pulls back the partition-era updates.
    ``params["verify_convergence"]`` makes the runner assert the
    instances' documents converge byte-identically after the schedule
    (a failure latches the verdict to fail)."""
    return Scenario(
        name="partition_heal",
        description="one-way mini_redis partition, anti-entropy heal, "
        "byte-identical convergence",
        num_docs=num_docs,
        sampled=min(4, num_docs),
        instances=2,
        shards=1,
        capacity=512,
        docs_per_socket=num_docs,
        params={
            "verify_convergence": True,
            "anti_entropy_s": anti_entropy_s,
        },
        phases=[
            PhaseSpec("healthy", phase_ms, _edit_gen(16.0), slo_e2e_ms=1000.0),
            PhaseSpec(
                "partitioned",
                phase_ms,
                _compose(
                    _partition_gen(True),
                    # fire-and-forget even on sampled docs: the traffic
                    # must keep flowing while its replication channel is
                    # deliberately dead (measuring here would only time
                    # out — the HEAL phase measures the recovery)
                    _edit_gen(16.0, background=True),
                ),
            ),
            PhaseSpec(
                "healed",
                phase_ms,
                _compose(_partition_gen(False), _edit_gen(12.0)),
                # the first measured edits carry the heal: their
                # latency includes the anti-entropy exchange pulling
                # back everything the partition dropped
                slo_e2e_ms=2000.0,
                slo_objective=0.90,
                error_objective=0.90,
            ),
        ],
    )


def multi_device_storm(
    num_docs: int = 24,
    phase_ms: int = 1500,
    devices: int = 4,
) -> Scenario:
    """Hot-doc skew on the multi-device cell plane
    (docs/guides/multi-device.md): a small-doc population plus one
    mega-doc whose outsized inserts pile dispatched work onto its
    owning chip. The storm phase's skew must force the rebalancer to
    migrate docs OFF the hot cell mid-run (evict-snapshot→hydrate, zero
    acked-update loss — ``verify_convergence`` latches divergence into
    the verdict via the cross-instance check), and the small docs'
    interactive p99 holds while the mega-doc churns — the
    `multi_device_storm.interactive_p99` gate stage in
    tools/bench_gate.py. Per-device doc counts, utilization spread,
    placement hash and migration accounting land in
    ``extra.multi_device`` so the next on-chip capture can verify the
    226 ms → <50 ms trajectory chip by chip."""
    return Scenario(
        name="multi_device_storm",
        description="hot-doc skew forcing load-aware rebalancing across "
        "per-device merge cells",
        num_docs=num_docs,
        sampled=min(6, num_docs),
        instances=2,
        shards=1,
        devices=devices,
        capacity=8192,
        mega_doc=True,
        docs_per_socket=num_docs,
        params={
            "verify_convergence": True,
            "multi_device": {
                # CI-scale rebalancer: sweep fast, trip on small skews,
                # so a three-phase run demonstrably migrates mid-storm
                "rebalance_interval_s": 0.25,
                "rebalance_ratio": 1.5,
                "rebalance_min_units": 64.0,
                "migrate_batch": 4,
            },
        },
        phases=[
            PhaseSpec("steady", phase_ms, _edit_gen(24.0, mega_every=12), slo_e2e_ms=1000.0),
            PhaseSpec(
                "storm",
                phase_ms,
                # every 3rd op is a mega insert into doc 0: its cell's
                # dispatched-work counter races ahead of its peers and
                # the rebalancer must spread the small docs away
                _edit_gen(36.0, mega_every=3, mega_lo=256, mega_hi=512),
                slo_e2e_ms=1000.0,
                slo_objective=0.90,
            ),
            PhaseSpec(
                "rebalanced",
                phase_ms,
                _edit_gen(24.0, mega_every=12),
                slo_e2e_ms=1000.0,
            ),
        ],
    )


def edge_fanout(
    num_docs: int = 10,
    phase_ms: int = 1200,
    joins: int = 4,
) -> Scenario:
    """The split front door under load (docs/guides/edge-routing.md):
    writers on edge 0, readers on edge 1, two merge cells behind the
    relay lane — every measured edit crosses edge→cell→edge, and a join
    storm lands THROUGH the edge tier mid-run (door auth + relay
    session establishment under pressure). The fanout phase's p99 is
    the `edge_fanout.interactive_p99` gate stage in
    tools/bench_gate.py: the edge hop must stay a constant tax, not a
    new tail."""
    return Scenario(
        name="edge_fanout",
        description="edge-terminated join storm + cross-edge fan-out "
        "over two merge cells",
        num_docs=num_docs,
        sampled=min(5, num_docs),
        edges=2,
        cells=2,
        shards=1,
        capacity=512,
        docs_per_socket=num_docs,
        params={"joins": joins},
        phases=[
            PhaseSpec("steady", phase_ms, _edit_gen(20.0), slo_e2e_ms=1000.0),
            PhaseSpec(
                "fanout",
                phase_ms,
                _compose(_edit_gen(30.0), _join_storm_gen(joins)),
                slo_e2e_ms=1000.0,
                slo_objective=0.90,
            ),
            PhaseSpec(
                "cool",
                phase_ms,
                _compose(_edit_gen(15.0), _leave_gen(joins)),
                slo_e2e_ms=1000.0,
            ),
        ],
    )


def mega_audience(
    num_docs: int = 4,
    phase_ms: int = 1500,
    joins: int = 18,
    watermark: int = 6,
) -> Scenario:
    """One doc goes viral (docs/guides/hot-doc-replication.md): a tiny
    writer population keeps editing doc 0 while a huge read audience
    piles in through edge 1 — crossing the replica watermark mid-run,
    so the router grows an owner + follower placement, followers
    bootstrap off the owner's snapshot rail and the edge spreads the
    audience's channels across the whole route set. The fanout phase's
    p99 is the `mega_audience.fanout_p99` gate stage in
    tools/bench_gate.py: the measured write→observe path must stay FLAT
    as the audience (and the follower count) scales, because the owner
    only streams one coalesced tick per flush regardless of audience —
    reads are the followers' problem. ``verify_convergence`` latches a
    follower serving stale state into the verdict, and the per-edge
    route tables + per-cell ReplicaManager stats land in
    ``extra.replica`` so follower counts and tick lag are checkable
    from the artifact alone."""
    return Scenario(
        name="mega_audience",
        description="viral mega-doc: huge read audience fanned out over "
        "follower cells while the write path stays on one owner",
        num_docs=num_docs,
        sampled=min(4, num_docs),
        edges=2,
        cells=3,
        shards=1,
        capacity=768,
        docs_per_socket=num_docs,
        params={
            "verify_convergence": True,
            "joins": joins,
            # CI-scale watermark: the join wave must cross it with room
            # to want several followers (wanted = audience // watermark,
            # capped at healthy-1 by the gateway)
            "replica_watermark": watermark,
        },
        phases=[
            # every 2nd op lands on doc 0 at NORMAL sizes (the doc is
            # hot by audience, not by payload — mega_doc covers that)
            PhaseSpec(
                "steady",
                phase_ms,
                _edit_gen(16.0, mega_every=2, mega_lo=16, mega_hi=32),
                slo_e2e_ms=1000.0,
            ),
            PhaseSpec(
                "swarm",
                phase_ms,
                _compose(
                    _edit_gen(16.0, mega_every=2, mega_lo=16, mega_hi=32),
                    _join_storm_gen(joins),
                ),
                # the swarm measures join time-to-synced WHILE followers
                # bootstrap — a follower mid-hydration still admits and
                # serves SyncStep2, so joins must not stall on it
                slo_e2e_ms=2000.0,
                slo_objective=0.90,
            ),
            PhaseSpec(
                "fanout",
                phase_ms,
                _edit_gen(24.0, mega_every=2, mega_lo=16, mega_hi=32),
                slo_e2e_ms=1000.0,
                slo_objective=0.90,
            ),
        ],
    )


def diurnal_autoscale(
    num_docs: int = 24,
    phase_ms: int = 2500,
    peak_rate: float = 96.0,
    devices: int = 4,
) -> Scenario:
    """The diurnal ramp with the elastic-fleet controller ON
    (docs/guides/elastic-fleet.md): the same trough → ramp → peak →
    ramp-down shape over a multi-device cell plane, plus a long steady
    `night` trough where the autoscaler must have parked the fleet back
    down to warm spares. Two latched verdict inputs: the per-phase SLOs
    (peak p99 is the `diurnal_autoscale.interactive_p99` gate stage —
    elasticity must not cost the peak), and the **steady-trough
    footprint ratio** — mean active cells during `night` over the
    static fleet size — which must stay ≤ `max_ratio`
    (`diurnal_autoscale.steady_footprint_ratio` in tools/bench_gate.py).
    Scale-downs migrate docs over the evict-snapshot→hydrate rail with
    zero acked loss; the runner attaches the roster timeline, scale
    decisions and migration counts as ``extra.autoscale``."""
    return Scenario(
        name="diurnal_autoscale",
        description="diurnal ramp under the elastic-fleet autoscaler: "
        "SLOs hold while the trough footprint drops",
        num_docs=num_docs,
        sampled=min(8, num_docs),
        shards=1,
        devices=devices,
        capacity=4096,
        docs_per_socket=num_docs,
        params={
            # FleetControllerExtension tuning (loadgen/harness.py):
            # CI-scale cadence so a 2.5s trough fits several decisions
            "autoscale": {
                "interval_s": 0.1,
                "hold_ticks": 2,
                "cooldown_ticks": 3,
                "min_cells": 1,
                "up_threshold": 0.75,
                "down_threshold": 0.35,
                # normalized so the trough (peak/8 edit units/s spread
                # over the fleet) reads well below down_threshold while
                # the peak saturates past up_threshold
                "work_target": 600.0,
                "lane_target": 64.0,
            },
            # runner-side verdict latch: mean active cells over the
            # `night` phase vs. the static fleet, latched like an SLO
            "autoscale_slo": {"trough_phase": "night", "max_ratio": 0.6},
            "multi_device": {
                # the rebalancer stays on (it coexists with the
                # controller) but sweeps slowly — scale decisions own
                # topology here, the rebalancer only polishes
                "rebalance_interval_s": 1.0,
                "rebalance_ratio": 2.0,
                "rebalance_min_units": 256.0,
            },
        },
        phases=[
            PhaseSpec("trough", phase_ms, _edit_gen(peak_rate / 8)),
            PhaseSpec("ramp_up", phase_ms, _edit_gen(peak_rate / 2)),
            PhaseSpec(
                "peak", phase_ms, _edit_gen(peak_rate), slo_e2e_ms=1000.0
            ),
            PhaseSpec("ramp_down", phase_ms, _edit_gen(peak_rate / 4)),
            # the measured steady trough: long enough for hold_ticks +
            # cooldown + the scale-down migrations to fully settle
            PhaseSpec("night", phase_ms, _edit_gen(peak_rate / 8)),
        ],
    )


def edge_handoff(
    num_docs: int = 8,
    phase_ms: int = 1500,
) -> Scenario:
    """Mid-run cell drain with transparent handoff
    (docs/guides/edge-routing.md): steady cross-edge traffic, then cell
    0 gracefully drains — it announces departure, the router remaps its
    docs and every affected session re-establishes on cell 1 via the
    replayed Auth + SyncStep1 resync, with NO client-visible
    disconnect. The handoff phase's edits measure the re-establishment
    tax; ``verify_convergence`` latches the zero-acknowledged-update-
    loss assertion (writer vs reader client docs byte-identical, the
    surviving-reference-client check) into the SLO verdict."""
    return Scenario(
        name="edge_handoff",
        description="mid-run cell drain: transparent handoff, zero "
        "acked-update loss, byte-identical convergence",
        num_docs=num_docs,
        sampled=min(4, num_docs),
        edges=2,
        cells=2,
        shards=1,
        capacity=512,
        docs_per_socket=num_docs,
        params={"verify_convergence": True},
        phases=[
            PhaseSpec("steady", phase_ms, _edit_gen(16.0), slo_e2e_ms=1000.0),
            PhaseSpec(
                "handoff",
                phase_ms,
                _compose(
                    _drain_gen(0),
                    # the drain runs mid-phase edits: sessions hand off
                    # UNDER traffic, and the measured latencies include
                    # the resync exchange
                    _edit_gen(16.0),
                ),
                slo_e2e_ms=5000.0,
                slo_objective=0.80,
                error_objective=0.80,
            ),
            PhaseSpec(
                "settled",
                phase_ms,
                _edit_gen(12.0),
                slo_e2e_ms=1000.0,
                slo_objective=0.90,
            ),
        ],
    )


def wire_saturation(
    num_docs: int = 8,
    phase_ms: int = 900,
    base_rate: float = 30.0,
) -> Scenario:
    """Ramping ingress rate with the per-frame cost ledger ON
    (docs/guides/observability.md "profiling & cost attribution"): four rungs
    doubling the offered edit rate. The runner enables the
    :mod:`~..observability.costs` ledger for the run and attaches
    ``extra.wire_saturation`` — per-rung offered vs. achieved frames/s
    (from the phase wire deltas), the headroom model's sustainable
    rate (``hocuspocus_profile_headroom_frames_per_s``) and the top-5
    per-frame cost attribution. tools/bench_gate.py gates
    ``wire_saturation.frames_per_s`` and
    ``wire_saturation.headroom_frames_per_s`` as higher-is-better
    stages. SLOs are deliberately generous — the verdict input here is
    throughput and attribution, not interactive latency."""
    return Scenario(
        name="wire_saturation",
        description="ramping ingress rate: cost-ledger attribution + "
        "headroom model vs. achieved frames/s",
        num_docs=num_docs,
        sampled=min(4, num_docs),
        shards=1,
        capacity=1024,
        docs_per_socket=num_docs,
        params={
            # runner-side: enable the cost ledger, attach the evidence.
            # min_achieved_ratio is a soft floor on achieved/offered for
            # the *first* rung only (the others are allowed to saturate
            # — that is the point of the ramp)
            "wire_saturation": {"min_achieved_ratio": 0.5},
        },
        phases=[
            PhaseSpec(
                "rung_1x",
                phase_ms,
                _edit_gen(base_rate),
                slo_e2e_ms=5000.0,
                slo_objective=0.80,
            ),
            PhaseSpec(
                "rung_2x",
                phase_ms,
                _edit_gen(base_rate * 2),
                slo_e2e_ms=5000.0,
                slo_objective=0.80,
            ),
            PhaseSpec(
                "rung_4x",
                phase_ms,
                _edit_gen(base_rate * 4),
                slo_e2e_ms=5000.0,
                slo_objective=0.80,
            ),
            PhaseSpec(
                "rung_8x",
                phase_ms,
                _edit_gen(base_rate * 8),
                slo_e2e_ms=5000.0,
                slo_objective=0.70,
                error_objective=0.90,
            ),
        ],
    )


SCENARIOS: "dict[str, Callable[..., Scenario]]" = {
    "smoke": smoke,
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
    "reconnect_herd": reconnect_herd,
    "mega_doc": mega_doc,
    "replication_lag": replication_lag,
    "storm": storm,
    "overload_storm": overload_storm,
    "partition_heal": partition_heal,
    "multi_device_storm": multi_device_storm,
    "diurnal_autoscale": diurnal_autoscale,
    "edge_fanout": edge_fanout,
    "edge_handoff": edge_handoff,
    "mega_audience": mega_audience,
    "wire_saturation": wire_saturation,
}

# the default suite bench.py / bench_capture run: fast enough for every
# round, covers the single-instance, cross-instance, overload-shed,
# partition-heal, multi-device-rebalance and edge-tier (split front
# door, cell-drain handoff, hot-doc follower fan-out) paths
BENCH_SUITE = (
    "smoke",
    "replication_lag",
    "overload_storm",
    "partition_heal",
    "multi_device_storm",
    "diurnal_autoscale",
    "edge_fanout",
    "edge_handoff",
    "mega_audience",
    "wire_saturation",
)


def get_scenario(name: str, **overrides) -> Scenario:
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(sorted(SCENARIOS))}"
        ) from None
    return factory(**overrides)
