"""Scenario execution: drive a compiled Schedule through real servers.

The runner is the bridge between the declarative half (scenario.py) and
the verdict: it boots the ``ServedLoadHarness`` topology the schedule's
population describes (real Server objects, full provider pipeline, one
serve-mode merge plane per instance on the card unless ``device="cpu"``
is given, mini_redis when cross-instance), executes the
op-stream with wall-clock pacing (``time_scale`` compresses logical
time), and judges the run with the burn-rate :class:`SloEngine`:

- every phase registers TWO targets on one run-scoped engine — a
  latency objective over the phase's measured end-to-end edits/joins
  and an op-success objective over its measured op outcomes;
- the engine samples on a cadence throughout the run; a target whose
  burn rate exceeds the alert threshold on EVERY window (the
  multi-window rule) is **latched** as breached the moment it happens —
  the verdict cannot un-breach when the window later slides past;
- the run's verdict IS that latched breach status: ``pass`` iff no
  target ever breached.

Live observability: the runner narrates into the process-global
loadgen timeline (``GET /debug/loadgen``) and mirrors run/phase edges
into the flight recorder's ``__loadgen__`` ring, so a failing scenario
is diagnosable from the same ``/debug/*`` surfaces production uses.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

import numpy as np

from ..observability.flight_recorder import get_flight_recorder
from ..observability.metrics import Histogram
from ..observability.slo import SloEngine, SloTarget, latency_slo
from ..observability.wire import get_wire_telemetry
from ..provider import HocuspocusProvider
from ..provider.inprocess import InProcessProviderSocket
from .harness import ServedLoadHarness
from .scenario import Schedule
from .timeline import get_loadgen_timeline

# bucket bounds the phase SLO thresholds snap to: scenario thresholds
# (0.5s/1s/2s defaults) sit EXACTLY on bounds so good/bad counting is
# bucket-exact (observability/slo.py snap_to_bucket)
_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0,
)


class ScenarioRunner:
    """One measured, SLO-judged execution of a compiled Schedule."""

    def __init__(
        self,
        schedule: Schedule,
        time_scale: float = 1.0,
        op_timeout_s: float = 15.0,
        alert_burn_rate: float = 14.4,
        with_metrics: bool = True,
        device: str = "cuda",
        progress=None,
    ) -> None:
        self.schedule = schedule
        self.time_scale = max(float(time_scale), 1e-6)
        self.op_timeout_s = op_timeout_s
        self._progress = progress or (lambda msg: None)

        pop = schedule.population
        params = pop.get("params") or {}
        # scenario-scoped overload control plane: params["overload"]
        # installs an OverloadExtension per instance with the given
        # tuning (docs/guides/overload.md); the runner resets the
        # process-global controller at teardown
        self._overload_config = params.get("overload")
        self._current_phase: "Optional[str]" = None
        self._verify_convergence = bool(params.get("verify_convergence"))
        # wire-saturation seam: params["wire_saturation"] turns the
        # per-frame cost ledger on for the run and attaches offered vs.
        # achieved frames/s per rung plus the headroom model's verdict
        # inputs as extra.wire_saturation (docs/guides/load-testing.md)
        self._wire_sat_config = params.get("wire_saturation")
        self._tracer_state = None  # (enabled, sample) to restore post-run
        # elastic-fleet seam: params["autoscale"] installs a
        # FleetControllerExtension next to each multi-device plane;
        # params["autoscale_slo"] makes the steady-trough footprint a
        # latched verdict input
        self._autoscale_config = params.get("autoscale")
        self._autoscale_slo = params.get("autoscale_slo") or {}
        self._autoscale_samples: "dict[str, list[int]]" = {}
        self._autoscale_evidence: "Optional[dict]" = None
        # sharded populations raise here, before anything starts
        # (ROADMAP.md, Queue A item 7b)
        self.harness = ServedLoadHarness(
            num_docs=pop["num_docs"],
            instances=pop["instances"],
            edges=pop.get("edges", 0),
            cells=pop.get("cells", 0),
            sampled=pop["sampled"],
            shards=pop["shards"],
            devices=pop.get("devices", 0),
            multi_device=params.get("multi_device"),
            shard_rows=pop.get("shard_rows"),
            capacity=pop["capacity"],
            flush_interval_ms=pop.get("flush_interval_ms", 2.0),
            docs_per_socket=pop.get("docs_per_socket", 64),
            with_metrics=with_metrics,
            seed=schedule.seed,
            overload=self._overload_config,
            anti_entropy_s=params.get("anti_entropy_s"),
            replica_watermark=params.get("replica_watermark"),
            autoscale=self._autoscale_config,
            device=device,
            progress=self._progress,
        )

        # run-scoped SLO engine: windows sized to the run so the
        # multi-window rule can vote before it ends — "burst" proves the
        # problem is still happening, "run" proves it is real
        planned_s = max(schedule.total_ms / 1000.0 / self.time_scale, 1.0)
        self.engine = SloEngine(
            windows=(("burst", max(planned_s / 4, 0.5)), ("run", planned_s)),
            sample_interval_s=max(planned_s / 50, 0.02),
            alert_burn_rate=alert_burn_rate,
        )
        self.latency_hist = Histogram(
            "hocuspocus_loadgen_scenario_e2e_seconds",
            "Measured end-to-end op latency by scenario phase",
            buckets=_LATENCY_BUCKETS,
        )
        self._phase_counts: "dict[str, dict]" = {}
        self._target_phase: "dict[str, str]" = {}
        for spec in schedule.phases:
            name = spec["name"]
            self._phase_counts[name] = {"total": 0.0, "bad": 0.0}
            latency = latency_slo(
                f"{name}:latency",
                self.latency_hist,
                threshold_s=spec["slo_e2e_ms"] / 1000.0,
                objective=spec["slo_objective"],
                stage=name,
            )
            self.engine.add(latency)
            counts = self._phase_counts[name]
            self.engine.add(
                SloTarget(
                    name=f"{name}:op_success",
                    description=(
                        f"{spec['error_objective']:.0%} of phase "
                        f"'{name}' measured ops succeed"
                    ),
                    objective=spec["error_objective"],
                    collect=(lambda c=counts: (c["total"], c["bad"])),
                )
            )
            self._target_phase[f"{name}:latency"] = name
            self._target_phase[f"{name}:op_success"] = name

        self._breached: "dict[str, bool]" = {}
        self._max_burn: "dict[str, dict[str, float]]" = {}
        self._phase_lat: "dict[str, list[float]]" = {
            spec["name"]: [] for spec in schedule.phases
        }
        self._joined: "dict[int, list]" = {}
        self._join_sockets: "list[InProcessProviderSocket]" = []
        self._behind_ms_max = 0.0

    # -- SLO sampling --------------------------------------------------------

    def _sample_slo(self, force: bool = False) -> None:
        if force:
            self.engine.sample()
        elif not self.engine.maybe_sample():
            return
        if self._current_phase and self.harness.fleet_controllers:
            # footprint evidence rides the SLO cadence: per-phase active
            # cell counts feed the steady-trough footprint verdict
            active = sum(
                len(ext.active_cells())
                for ext in self.harness.fleet_controllers
            )
            self._autoscale_samples.setdefault(
                self._current_phase, []
            ).append(active)
        timeline = get_loadgen_timeline()
        for target in self.engine.targets:
            for window, _secs in self.engine.windows:
                burn = self.engine.burn_rate(target.name, window)
                if burn is not None:
                    prev = self._max_burn.setdefault(target.name, {})
                    prev[window] = max(prev.get(window, 0.0), burn)
            if self.engine.breaching(target) and not self._breached.get(
                target.name
            ):
                # latch: the verdict must remember a breach even after
                # the windows slide past it
                self._breached[target.name] = True
                phase = self._target_phase.get(target.name, "?")
                timeline.note_breach(phase, target.name)
                get_flight_recorder().record(
                    "__loadgen__", "slo_breach", phase=phase, target=target.name
                )
                self._progress(f"SLO BREACH {target.name}")

    # -- op execution --------------------------------------------------------

    async def _await_synced(
        self, provider, abort: "Optional[asyncio.Event]" = None
    ) -> "Optional[float]":
        """Seconds until the provider syncs; None on timeout OR when
        `abort` fires first (e.g. admission denied — the op must fail
        fast, not burn the op timeout)."""
        t0 = time.perf_counter()
        while not provider.synced:
            if abort is not None and abort.is_set():
                return None
            if time.perf_counter() - t0 > self.op_timeout_s:
                return None
            await asyncio.sleep(0.002)
        return time.perf_counter() - t0

    def _join_server(self):
        servers = self.harness.servers
        return servers[1 if len(servers) > 1 else 0]

    async def _op_join(self, doc: int) -> "Optional[float]":
        socket = InProcessProviderSocket(self._join_server())
        self._join_sockets.append(socket)
        provider = HocuspocusProvider(
            name=f"load-{doc}", websocket_provider=socket
        )
        # overload admission refuses at auth with permission-denied —
        # the join must FAIL FAST (a bad op), not burn the op timeout
        denied = asyncio.Event()
        provider.on("authentication_failed", lambda *args: denied.set())
        provider.attach()
        latency = await self._await_synced(provider, abort=denied)
        self._joined.setdefault(doc, []).append(provider)
        return latency

    async def _op_leave(self, doc: int) -> "Optional[float]":
        joined = self._joined.get(doc) or []
        if joined:
            joined.pop(0).destroy()
            await asyncio.sleep(0)
        return 0.0

    async def _op_reconnect(self, doc: int) -> "Optional[float]":
        """Flaky mobile: the doc's reader drops and resyncs — the
        measured latency is the full rejoin (auth + SyncStep1/2)."""
        harness = self.harness
        if doc >= len(harness.readers):
            return 0.0
        old = harness.readers[doc]
        socket = old.websocket_provider
        old.destroy()
        await asyncio.sleep(0)
        provider = HocuspocusProvider(
            name=f"load-{doc}", websocket_provider=socket
        )
        provider.attach()
        harness.readers[doc] = provider
        return await self._await_synced(provider)

    async def _op_drain(self, value: int) -> "Optional[float]":
        """Gracefully drain merge cell `value` mid-run (edge topology):
        the handoff contract — remap + transparent re-establishment —
        is what the rest of the phase then measures."""
        if not self.harness.cell_servers:
            return 0.0
        outcome = await self.harness.drain_cell(value % len(self.harness.cell_servers))
        get_flight_recorder().record(
            "__loadgen__",
            "cell_drained",
            cell=value,
            stored=outcome.get("stored"),
            duration_s=outcome.get("duration_s"),
        )
        return 0.0

    def _op_lag(self, value: int) -> "Optional[float]":
        redis = self.harness.mini_redis
        if redis is not None:
            redis.publish_latency_ms = value
        return 0.0

    def _op_partition(self, value: int) -> "Optional[float]":
        """One-way partition of instance 0's publisher at the mini_redis
        hop (value 1), or heal (value 0). Drops are accounted in the
        server's `dropped_partition` counter — never silent."""
        redis = self.harness.mini_redis
        if redis is not None:
            if value:
                redis.partition_publisher(self.harness.redis_identifier(0))
            else:
                redis.heal_partition()
        return 0.0

    def _op_overload(self, value: int) -> "Optional[float]":
        from ..server.overload import get_overload_controller

        get_overload_controller().inject_pressure(float(value))
        return 0.0

    async def _execute(self, op) -> None:
        """Run one op; measured kinds feed the phase histogram and the
        success counters. A timeout is a bad event, never an abort."""
        measured = True
        latency: "Optional[float]" = 0.0
        if op.kind == "edit":
            if op.doc < self.harness.sampled and not op.value:
                latency = await self.harness.timed_edit(
                    op.doc,
                    max(op.size, 1),
                    timeout_s=self.op_timeout_s,
                    raise_on_timeout=False,
                )
            else:
                # background traffic (non-sampled doc, or an edit
                # flagged fire-and-forget — e.g. during a partition
                # phase whose observation channel is deliberately
                # dead): load, not signal
                wtext = self.harness.writers[op.doc].document.get_text("body")
                wtext.insert(len(wtext), "b" * max(op.size, 1))
                measured = False
        elif op.kind == "join":
            latency = await self._op_join(op.doc)
        elif op.kind == "leave":
            latency = await self._op_leave(op.doc)
            measured = False
        elif op.kind == "reconnect":
            latency = await self._op_reconnect(op.doc)
        elif op.kind == "lag":
            latency = self._op_lag(op.value)
            measured = False
        elif op.kind == "partition":
            latency = self._op_partition(op.value)
            measured = False
        elif op.kind == "overload":
            latency = self._op_overload(op.value)
            measured = False
        elif op.kind == "drain":
            latency = await self._op_drain(op.value)
            measured = False
        ok = latency is not None
        if measured:
            counts = self._phase_counts[op.phase]
            counts["total"] += 1
            if not ok:
                counts["bad"] += 1
            if ok and latency > 0:
                self.latency_hist.observe(latency, stage=op.phase)
                self._phase_lat[op.phase].append(latency)
        get_loadgen_timeline().op_done(
            op.phase,
            op.kind,
            ok,
            latency_ms=(latency * 1000 if measured and ok and latency else None),
        )

    # -- phases --------------------------------------------------------------

    def _phase_summary(self, spec: dict) -> dict:
        name = spec["name"]
        lat = self._phase_lat[name]
        lat_ms = np.array(lat) * 1000 if lat else None
        counts = self._phase_counts[name]
        burn = {}
        for target in (f"{name}:latency", f"{name}:op_success"):
            burn[target] = {
                window: self.engine.burn_rate(target, window)
                for window, _secs in self.engine.windows
            }
        return {
            "name": name,
            "planned_ms": spec["duration_ms"],
            "slo_e2e_ms": spec["slo_e2e_ms"],
            "measured_ops": int(counts["total"]),
            "failed_ops": int(counts["bad"]),
            "latency_p50_ms": None
            if lat_ms is None
            else round(float(np.percentile(lat_ms, 50)), 3),
            "latency_p99_ms": None
            if lat_ms is None
            else round(float(np.percentile(lat_ms, 99)), 3),
            "burn_rates": burn,
            "breached": [
                target
                for target in burn
                if self._breached.get(target)
            ],
        }

    def _start_phase(self, name: str) -> None:
        self._current_phase = name
        get_loadgen_timeline().phase_start(name)
        get_flight_recorder().record(
            "__loadgen__", "phase_start", phase=name, scenario=self.schedule.scenario
        )
        self._progress(f"phase {name} start")
        self._wire_before = get_wire_telemetry().totals()
        self._lane_before = self._lane_counters() or {}
        self._phase_wall_started = time.perf_counter()

    def _end_phase(self, spec: dict, summaries: "list[dict]") -> None:
        name = spec["name"]
        summary = self._phase_summary(spec)
        summary["wall_s"] = round(
            time.perf_counter()
            - getattr(self, "_phase_wall_started", time.perf_counter()),
            3,
        )
        after = get_wire_telemetry().totals()
        summary["wire"] = {
            key: int(after[key] - self._wire_before.get(key, 0))
            for key in ("messages_in", "messages_out", "bytes_in", "bytes_out")
        }
        lane = self._lane_counters()
        if lane is not None:
            before = getattr(self, "_lane_before", None) or {}
            summary["lane"] = {
                key: value - before.get(key, 0) for key, value in lane.items()
            }
        summaries.append(summary)
        get_loadgen_timeline().phase_end(
            name,
            latency_p50_ms=summary["latency_p50_ms"],
            latency_p99_ms=summary["latency_p99_ms"],
        )
        get_flight_recorder().record(
            "__loadgen__",
            "phase_end",
            phase=name,
            measured_ops=summary["measured_ops"],
            failed_ops=summary["failed_ops"],
            p99_ms=summary["latency_p99_ms"],
        )
        self._progress(
            f"phase {name} done: {summary['measured_ops']} measured ops, "
            f"p99={summary['latency_p99_ms']}ms"
        )

    async def _check_convergence(self, timeout_s: float = 8.0) -> dict:
        """Zero-silent-loss acceptance. Replicated topology: every
        sampled doc's server-side state must converge BYTE-IDENTICALLY
        across the two instances (encode_state_as_update orders structs
        deterministically, so equal logical state means equal bytes).
        Edge topology: the kill-9-style assertion runs against the
        SURVIVING REFERENCE CLIENTS — writer and reader docs (which
        hold every acknowledged update, connected through DIFFERENT
        edges) must converge byte-identically even across a mid-run
        cell drain. Waits out the trailing resync/anti-entropy
        exchange; a doc still diverged at the deadline is reported and
        latches the verdict."""
        from ..crdt import encode_state_as_update

        harness = self.harness
        if harness.edges > 0:
            pairs = [
                (f"load-{d}", harness.writers[d].document, harness.readers[d].document)
                for d in range(harness.sampled)
            ]

            def states(name):
                for label, doc_a, doc_b in pairs:
                    if label == name:
                        return doc_a, doc_b
                return None, None

        else:
            docs_a = harness.servers[0].hocuspocus.documents
            docs_b = harness.servers[1].hocuspocus.documents

            def states(name):
                return docs_a.get(name), docs_b.get(name)

        names = [f"load-{d}" for d in range(harness.sampled)]
        pending = set(names)
        t0 = time.perf_counter()
        while pending and time.perf_counter() - t0 < timeout_s:
            for name in list(pending):
                doc_a, doc_b = states(name)
                if doc_a is None or doc_b is None:
                    continue
                try:
                    if encode_state_as_update(doc_a) == encode_state_as_update(
                        doc_b
                    ):
                        pending.discard(name)
                except Exception:
                    pass
            if pending:
                await asyncio.sleep(0.05)
        return {
            "docs_checked": len(names),
            "converged": not pending,
            "diverged": sorted(pending),
            "wait_ms": round((time.perf_counter() - t0) * 1000, 1),
        }

    def _latch_autoscale_footprint(self) -> None:
        """The elasticity acceptance (docs/guides/elastic-fleet.md):
        mean active cells during the configured trough phase over the
        static fleet size must stay <= max_ratio — a fleet that never
        scales back down fails the run even with every latency SLO
        green. Latched like any breach; the ratio lands in
        ``extra.autoscale`` for the bench gate's
        diurnal_autoscale.steady_footprint_ratio stage."""
        controllers = self.harness.fleet_controllers
        if not self._autoscale_config or not controllers:
            return
        total = sum(
            ext.controller.num_cells if ext.controller else 0
            for ext in controllers
        )
        phase_means = {
            phase: round(sum(samples) / len(samples), 3)
            for phase, samples in self._autoscale_samples.items()
            if samples
        }
        evidence: dict = {
            "fleet_cells": total,
            "phase_active_cells": phase_means,
            "controllers": [ext.status() for ext in controllers],
        }
        trough = self._autoscale_slo.get("trough_phase")
        max_ratio = self._autoscale_slo.get("max_ratio")
        if trough and max_ratio is not None and total:
            samples = self._autoscale_samples.get(trough) or []
            if samples:
                ratio = (sum(samples) / len(samples)) / total
                evidence["trough_phase"] = trough
                evidence["max_ratio"] = float(max_ratio)
                evidence["steady_footprint_ratio"] = round(ratio, 4)
                if ratio > float(max_ratio):
                    self._breached["autoscale_footprint"] = True
                    get_loadgen_timeline().note_breach(
                        trough, "autoscale_footprint"
                    )
                    get_flight_recorder().record(
                        "__loadgen__",
                        "autoscale_footprint_breach",
                        phase=trough,
                        ratio=round(ratio, 4),
                        max_ratio=float(max_ratio),
                    )
                    self._progress(
                        f"AUTOSCALE FOOTPRINT BREACH {ratio:.2f} > "
                        f"{float(max_ratio):.2f}"
                    )
            else:
                # no samples in the measured trough = the verdict input
                # is missing, not vacuously green
                self._breached["autoscale_footprint"] = True
                evidence["steady_footprint_ratio"] = None
        self._autoscale_evidence = evidence


    def _chaos_evidence(self) -> dict:
        """Overload/partition accounting attached to the artifact: the
        ladder's transition history + shed counters, mini_redis's
        partition-drop accounting, and the publish lane's shed
        counters — 'every shed publish accounted' is checkable from
        the artifact alone."""
        evidence: dict = {}
        if self._overload_config:
            from ..server.overload import get_overload_controller

            evidence["overload"] = get_overload_controller().status()
        mini = self.harness.mini_redis
        if mini is not None:
            evidence["mini_redis"] = dict(mini.counters)
        if self.harness.edge_gateways:
            # handoff evidence: relay/handoff/stale-drop counters + the
            # router's final view, per edge — "the drain handed off
            # transparently" is checkable from the artifact alone
            evidence["edge"] = {
                gateway.edge_id: {
                    "counters": dict(gateway.counters),
                    "router": gateway.router.table(),
                }
                for gateway in self.harness.edge_gateways
            }
            # fleet observability evidence (docs/guides/observability.md
            # fleet view): digest federation counts, cross-tier
            # edge→cell→edge latency quantiles, stale peers — the
            # bench gate's edge_fanout.cross_tier_e2e_p99 stage reads
            # the p99 from here
            from ..observability.fleet import get_fleet_view

            view = get_fleet_view()
            fleet_status = view.status()
            evidence["fleet"] = {
                "peers": fleet_status["totals"]["peers"],
                "fresh_peers": fleet_status["totals"]["fresh"],
                "stale_peers": len(fleet_status["stale_peers"]),
                "digests_ingested": view.counters["digests_ingested"],
                "epoch_skew": any(
                    info["skew"] for info in fleet_status["epoch_skew"].values()
                ),
                "cross_tier_e2e_ms": fleet_status["cross_tier_e2e_ms"],
                "traces_stamped": sum(
                    gateway.counters.get("traces_stamped", 0)
                    for gateway in self.harness.edge_gateways
                ),
                "traces_closed": sum(
                    gateway.counters.get("traces_closed", 0)
                    for gateway in self.harness.edge_gateways
                ),
            }
        if self.harness.edge_gateways:
            # hot-doc replication evidence (docs/guides/
            # hot-doc-replication.md): each edge's owner+follower route
            # tables and each cell's ReplicaManager stats — follower
            # counts, tick seqs, lag and resync/promotion counters —
            # so "the audience fanned out over followers with bounded
            # owner work" is checkable from the artifact alone
            replica_evidence: dict = {
                "edges": {
                    gateway.edge_id: {
                        "watermark": gateway.replica_watermark,
                        "docs": (gateway.status().get("replica") or {}).get(
                            "docs", {}
                        ),
                    }
                    for gateway in self.harness.edge_gateways
                },
                "cells": {
                    ingress.cell_id: ingress.replicas.stats()
                    for ingress in self.harness.cell_ingresses
                    if getattr(ingress, "replicas", None) is not None
                },
            }
            if any(
                edge["docs"] for edge in replica_evidence["edges"].values()
            ) or any(
                stats.get("owned") or stats.get("following")
                for stats in replica_evidence["cells"].values()
            ):
                evidence["replica"] = replica_evidence
        multi = {}
        for i, ext in enumerate(self.harness.extensions):
            if callable(getattr(ext, "utilization_spread", None)):
                # per-device placement evidence: "docs spread, no device
                # over 2x the mean, every migration accounted" is
                # checkable from the artifact
                multi[f"instance{i}"] = {
                    "placement": ext.placement.table(),
                    "placement_hash": ext.placement.placement_hash(),
                    "migrations": dict(ext.migration_stats),
                    "utilization": ext.utilization_spread(),
                    "per_device": ext.per_device_latency(),
                    "devices": len(ext.cells),
                }
        if multi:
            evidence["multi_device"] = multi
        if self._autoscale_evidence is not None:
            # elastic-fleet evidence: roster timeline, scale decisions,
            # per-phase active-cell means and the steady-trough
            # footprint ratio
            evidence["autoscale"] = self._autoscale_evidence
        publish = {}
        for i, server in enumerate(self.harness.servers):
            for ext in getattr(server.hocuspocus, "_extensions", []):
                pub = getattr(ext, "pub", None)
                counters = getattr(pub, "counters", None)
                if isinstance(counters, dict):
                    publish[f"instance{i}"] = dict(counters)
        if publish:
            evidence["publish_lane"] = publish
        return evidence

    def _wire_saturation_evidence(self, summaries: "list[dict]") -> dict:
        """The wire-saturation verdict inputs: per-rung offered ops/s
        vs. achieved ingress frames/s (phase wire deltas over measured
        wall time), the headroom model's sustainable rate and the top-5
        per-frame cost attribution. Two latched checks keep the verdict
        non-vacuous: the FIRST rung must achieve at least
        ``min_achieved_ratio`` ingress frames per offered op (later
        rungs are allowed — expected — to saturate), and the cost
        ledger must have produced a non-empty attribution."""
        from ..observability.costs import get_cost_ledger

        ledger = get_cost_ledger()
        config = self._wire_sat_config or {}
        offered_by_phase: "dict[str, int]" = {}
        for op in self.schedule.ops:
            offered_by_phase[op.phase] = offered_by_phase.get(op.phase, 0) + 1
        rungs = []
        for summary in summaries:
            wall_s = summary.get("wall_s") or (
                summary["planned_ms"] / 1000.0 / self.time_scale
            )
            wall_s = max(float(wall_s), 1e-6)
            wire = summary.get("wire") or {}
            offered = offered_by_phase.get(summary["name"], 0) / wall_s
            achieved = wire.get("messages_in", 0) / wall_s
            rungs.append(
                {
                    "phase": summary["name"],
                    "wall_s": round(wall_s, 3),
                    "offered_ops_per_s": round(offered, 1),
                    "achieved_frames_per_s": round(achieved, 1),
                    "bytes_in_per_s": round(
                        wire.get("bytes_in", 0) / wall_s, 1
                    ),
                    "p99_ms": summary["latency_p99_ms"],
                }
            )
        sustained = max(
            (rung["achieved_frames_per_s"] for rung in rungs), default=0.0
        )
        headroom = ledger.headroom_frames_per_s()
        top = ledger.top_costs(5)
        min_ratio = float(config.get("min_achieved_ratio", 0.5))
        if rungs:
            first = rungs[0]
            if first["achieved_frames_per_s"] < (
                min_ratio * first["offered_ops_per_s"]
            ):
                self._breached["wire_saturation_floor"] = True
        if not top or headroom <= 0.0:
            # the whole point of the scenario: evidence, not vacuity
            self._breached["wire_saturation_attribution"] = True
        return {
            "rungs": rungs,
            "sustained_frames_per_s": sustained,
            "headroom_frames_per_s": round(headroom, 1),
            "headroom_ratio": round(headroom / sustained, 3)
            if sustained
            else None,
            "loop_ns_per_frame": round(ledger.loop_ns_per_frame(), 1),
            "ingress_frames": ledger.ingress_frames(),
            "top_costs": top,
        }

    def _lane_counters(self) -> "Optional[dict]":
        total: "dict[str, int]" = {}
        found = False
        for ext in self.harness.extensions:
            lanes_fn = getattr(ext, "lanes", None)
            # the cell plane has one arbiter per cell
            lanes = lanes_fn() if callable(lanes_fn) else [getattr(ext, "lane", None)]
            for lane in lanes:
                counters = getattr(lane, "counters", None)
                if isinstance(counters, dict):
                    found = True
                    for key, value in counters.items():
                        total[key] = total.get(key, 0) + int(value)
        return total if found else None

    # -- the run -------------------------------------------------------------

    async def run(self) -> dict:
        schedule = self.schedule
        harness = self.harness
        timeline = get_loadgen_timeline()
        recorder = get_flight_recorder()
        get_wire_telemetry().enable()
        wire_run_before = get_wire_telemetry().totals()
        if self._wire_sat_config:
            # the ledger is process-global like the overload controller:
            # reset to this run so the headroom model reads THIS
            # scenario's loop-thread costs, not a previous run's
            from ..observability.costs import get_cost_ledger

            ledger = get_cost_ledger()
            ledger.reset()
            ledger.enable()
        t_setup = time.perf_counter()
        summaries: "list[dict]" = []
        timeline.begin_run(
            scenario=schedule.scenario,
            seed=schedule.seed,
            schedule_hash=schedule.schedule_hash,
            phases=[
                {"name": s["name"], "planned_ms": s["duration_ms"]}
                for s in schedule.phases
            ],
            time_scale=self.time_scale,
            ops_total=len(schedule.ops),
        )
        recorder.record(
            "__loadgen__",
            "run_start",
            scenario=schedule.scenario,
            seed=schedule.seed,
            schedule_hash=schedule.schedule_hash,
        )
        verdict = "fail"
        self._tracer_state = None
        if harness.edges > 0:
            # edge topology: light cross-tier tracing so the run lands
            # fleet evidence (extra.fleet cross_tier_e2e_ms feeds the
            # bench gate). The fleet view resets to this run — like the
            # overload controller, it is process-global state a scenario
            # must not inherit; the tracer is restored at teardown.
            from ..observability.fleet import get_fleet_view
            from ..observability.tracing import get_tracer

            view = get_fleet_view()
            view.reset()
            view.enable()
            tracer = get_tracer()
            self._tracer_state = (tracer.enabled, tracer.sample)
            tracer.enabled = True
            # 1-in-4: enough observations for the cross-tier quantiles
            # at CI scale without perturbing the gated interactive_p99
            # (every sampled update pays an aux encode + span chain +
            # one TRACE_RET round trip)
            tracer.sample = 4
        try:
            self._progress(
                f"scenario {schedule.scenario}: booting population "
                f"({harness.num_docs} docs x {harness.instances} instance(s))"
            )
            await harness._start_servers()
            await harness._connect_writers()
            await harness._connect_readers()
            setup_s = time.perf_counter() - t_setup
            self._progress(f"population synced in {setup_s:.1f}s; executing schedule")

            phase_order = [spec["name"] for spec in schedule.phases]
            spec_by_name = {spec["name"]: spec for spec in schedule.phases}
            phase_index = -1
            self._sample_slo(force=True)
            t0 = time.perf_counter()
            for op in schedule.ops:
                due = t0 + op.at_ms / 1000.0 / self.time_scale
                while True:
                    now = time.perf_counter()
                    if now >= due:
                        break
                    await asyncio.sleep(
                        min(due - now, self.engine.sample_interval_s)
                    )
                    self._sample_slo()
                self._behind_ms_max = max(
                    self._behind_ms_max, (time.perf_counter() - due) * 1000
                )
                # advance phases (empty phases open + close in passing)
                while (
                    phase_index < 0
                    or phase_order[phase_index] != op.phase
                ):
                    if phase_index + 1 >= len(phase_order):
                        # only reachable with a hand-edited schedule:
                        # compile() emits phase-monotonic op order
                        raise ValueError(
                            f"op phase {op.phase!r} violates declared "
                            f"phase order {phase_order}"
                        )
                    if phase_index >= 0:
                        self._sample_slo(force=True)
                        self._end_phase(
                            spec_by_name[phase_order[phase_index]], summaries
                        )
                    phase_index += 1
                    self._start_phase(phase_order[phase_index])
                await self._execute(op)
                self._sample_slo()
            # close the tail: final sample with full-run coverage, then
            # remaining phase summaries
            self._sample_slo(force=True)
            while phase_index < len(phase_order):
                if phase_index >= 0:
                    self._end_phase(spec_by_name[phase_order[phase_index]], summaries)
                phase_index += 1
                if phase_index < len(phase_order):
                    self._start_phase(phase_order[phase_index])
            elapsed = time.perf_counter() - t0
            if self._overload_config:
                # the schedule is over: stop the ladder's sampler NOW so
                # teardown churn (provider/server destruction stalls the
                # loop) can't smear spurious transitions into the
                # flight recorder after the measured run
                from ..server.overload import get_overload_controller

                get_overload_controller().stop()

            convergence = None
            if self._verify_convergence and (
                harness.instances > 1 or harness.edges > 0
            ):
                convergence = await self._check_convergence()
                if not convergence["converged"]:
                    # zero-silent-loss acceptance: divergence after the
                    # heal window is a latched failure like any breach
                    self._breached["convergence"] = True
                    get_flight_recorder().record(
                        "__loadgen__",
                        "convergence_failed",
                        diverged=",".join(convergence["diverged"]),
                    )
                    self._progress(
                        f"CONVERGENCE FAILED: {convergence['diverged']}"
                    )

            self._latch_autoscale_footprint()

            wire_sat = None
            if self._wire_sat_config:
                wire_sat = self._wire_saturation_evidence(summaries)

            verdict = "fail" if any(self._breached.values()) else "pass"
            slo_status = self.engine.status()
            result = {
                "metric": "scenario_slo_verdict",
                "value": 1.0 if verdict == "pass" else 0.0,
                "unit": "pass",
                "scenario": schedule.scenario,
                "seed": schedule.seed,
                "schedule_hash": schedule.schedule_hash,
                "verdict": verdict,
                "slo": {
                    "alert_burn_rate": self.engine.alert_burn_rate,
                    "windows": {
                        name: secs for name, secs in self.engine.windows
                    },
                    "breached_targets": sorted(
                        name for name, hit in self._breached.items() if hit
                    ),
                    "max_burn_rates": {
                        name: {
                            window: round(burn, 4)
                            for window, burn in windows.items()
                        }
                        for name, windows in sorted(self._max_burn.items())
                    },
                    "targets": {
                        name: {
                            "description": slo["description"],
                            "objective": slo["objective"],
                            "breached": bool(self._breached.get(name)),
                        }
                        for name, slo in slo_status["slos"].items()
                    },
                },
                "phases": summaries,
                "extra": {
                    "population": schedule.population,
                    "time_scale": self.time_scale,
                    "ops_total": len(schedule.ops),
                    "ops_measured": int(
                        sum(c["total"] for c in self._phase_counts.values())
                    ),
                    "ops_failed": int(
                        sum(c["bad"] for c in self._phase_counts.values())
                    ),
                    "behind_ms_max": round(self._behind_ms_max, 1),
                    "setup_s": round(setup_s, 2),
                    "elapsed_s": round(elapsed, 2),
                    "seed": schedule.seed,
                    "wire": {
                        key: int(value - wire_run_before.get(key, 0))
                        for key, value in get_wire_telemetry().totals().items()
                    },
                    "plane_health": harness.plane_health(),
                },
            }
            if convergence is not None:
                result["extra"]["convergence"] = convergence
            if wire_sat is not None:
                result["extra"]["wire_saturation"] = wire_sat
            chaos = self._chaos_evidence()
            if chaos:
                result["extra"].update(chaos)
            return result
        finally:
            timeline.end_run(verdict)
            recorder.record(
                "__loadgen__", "run_end", scenario=schedule.scenario, verdict=verdict
            )
            await self._teardown()

    async def _teardown(self) -> None:
        for providers in self._joined.values():
            for provider in providers:
                provider.destroy()
        self._joined.clear()
        for socket in self._join_sockets:
            socket.destroy()
        self._join_sockets.clear()
        await asyncio.sleep(0)
        await self.harness._teardown()
        if self._tracer_state is not None:
            from ..observability.tracing import get_tracer

            tracer = get_tracer()
            tracer.enabled, tracer.sample = self._tracer_state
            self._tracer_state = None
        if self._overload_config:
            # the controller is process-global: a scenario that tuned +
            # drove it must hand the next run a cold GREEN one
            from ..server.overload import get_overload_controller

            get_overload_controller().reset()
        if self._wire_sat_config:
            # same process-global discipline for the cost ledger: the
            # next scenario must not pay this run's per-frame timers
            from ..observability.costs import get_cost_ledger

            get_cost_ledger().disable()


async def run_scenario(
    scenario_or_schedule: "Any",
    seed: int = 0,
    time_scale: float = 1.0,
    **runner_kwargs: Any,
) -> dict:
    """Compile (when given a Scenario) and run; returns the artifact."""
    schedule = scenario_or_schedule
    if not isinstance(schedule, Schedule):
        schedule = scenario_or_schedule.compile(seed)
    runner = ScenarioRunner(schedule, time_scale=time_scale, **runner_kwargs)
    return await runner.run()
