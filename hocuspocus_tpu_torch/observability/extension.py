"""`Metrics` extension: lifecycle counters + `/metrics` endpoint.

Fills the observability hole called out in SURVEY.md §5.5 (the reference
has "No Prometheus/OTel"; its only counters are
`getDocumentsCount`/`getConnectionsCount`, reference
`packages/server/src/Hocuspocus.ts:138-160`). Add to a server like any
other extension::

    Server(extensions=[Metrics()])

and scrape `GET /metrics`. Load/store latencies are measured between the
on_*/after_* hook pairs; live gauges (connections, documents) read the
instance at scrape time.
"""

from __future__ import annotations

import asyncio
import gc
import os
import sys
import time
from typing import Optional

from ..server.types import Extension, Payload
from .costs import get_cost_ledger
from .device_watch import compile_metrics
from .fleet import build_digest, get_fleet_view, stamp_header
from .flight_recorder import get_flight_recorder
from .metrics import MetricsRegistry
from .profiler import get_profiler
from .slo import SloEngine, counter_ratio_slo, fraction_slo, latency_slo
from .tracing import get_tracer
from .wire import get_wire_telemetry


class Metrics(Extension):
    # run before ordinary extensions so latency measurement brackets them
    priority = 1000

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        path: str = "/metrics",
        expose_tracer: bool = False,
        debug_endpoints: bool = True,
        slo_e2e_p99_ms: float = 50.0,
        slo_error_rate: float = 0.001,
        slo_fleet_e2e_ms: float = 250.0,
        slo_sample_interval_s: float = 15.0,
    ) -> None:
        self.registry = registry or MetricsRegistry()
        self.path = path
        self.expose_tracer = expose_tracer
        # /debug/trace (Perfetto JSON), /debug/profile (on-demand
        # torch.profiler capture), /debug/profile/cpu (sampling profiler),
        # /debug/docs[/<name>] (flight recorder), /debug/slo (burn-rate
        # rollup), /debug/fleet (federated telemetry rollup),
        # /debug/scheduler, /debug/costs, /debug/loadgen (scenario-run
        # timeline)
        self.debug_endpoints = debug_endpoints
        self._instance = None
        self._plane_owner = None  # extension owning the plane, for /debug/docs
        self._slow_span_cb = None
        self._slo_task: Optional[asyncio.Task] = None

        reg = self.registry
        self.connects = reg.counter(
            "hocuspocus_connects_total", "WebSocket connections accepted"
        )
        self.disconnects = reg.counter(
            "hocuspocus_disconnects_total", "WebSocket connections closed"
        )
        self.changes = reg.counter(
            "hocuspocus_document_changes_total", "Document change events"
        )
        self.loads = reg.counter(
            "hocuspocus_document_loads_total", "Documents loaded into memory"
        )
        self.stores = reg.counter(
            "hocuspocus_document_stores_total", "Document store (persist) events"
        )
        self.unloads = reg.counter(
            "hocuspocus_document_unloads_total", "Documents unloaded from memory"
        )
        self.awareness_updates = reg.counter(
            "hocuspocus_awareness_updates_total", "Awareness update events"
        )
        self.stateless = reg.counter(
            "hocuspocus_stateless_messages_total", "Stateless messages received"
        )
        self.http_requests = reg.counter(
            "hocuspocus_http_requests_total", "Non-websocket HTTP requests"
        )
        self.load_seconds = reg.histogram(
            "hocuspocus_document_load_seconds", "onLoadDocument → afterLoadDocument"
        )
        self.store_seconds = reg.histogram(
            "hocuspocus_document_store_seconds", "onStoreDocument → afterStoreDocument"
        )
        # update-lifecycle stage latencies (docs/guides/observability.md):
        # one series per pipeline stage — queue_wait/build/upload/device/
        # readback/broadcast plus the contiguous total — fed by the
        # plane's UpdateTraceBook for every sampled traced update
        self.update_e2e = reg.histogram(
            "hocuspocus_tpu_update_e2e_seconds",
            "End-to-end update lifecycle latency by pipeline stage",
        )
        self.slow_spans = reg.counter(
            "hocuspocus_tpu_slow_spans_total",
            "Spans promoted past the --trace-slow-ms threshold, by site",
        )
        # wire-path telemetry (observability/wire.py): the socket-edge
        # counters/gauges/histograms are process-global collectors; the
        # registry adopts them so they render on this server's /metrics
        self.wire = get_wire_telemetry()
        for metric in self.wire.metrics():
            reg.register(metric)
        # overload control plane (server/overload.py): ladder state,
        # transitions, shed accounting, admission counters and signal
        # gauges — adopted like the wire collector so every deployment
        # scraping /metrics can alert on brownouts
        from ..server.overload import get_overload_controller

        for metric in get_overload_controller().metrics():
            try:
                reg.register(metric)
            except ValueError:
                pass  # already adopted (shared registry, repeat bind)
        # per-frame cost ledger + sampling CPU profiler (observability/
        # costs.py, observability/profiler.py): process-global collectors
        # adopted like the wire telemetry — the ledger's site counters,
        # the derived headroom gauge and the profiler's overhead/burst
        # series all render on this server's /metrics in deterministic
        # (sorted) order
        self.costs = get_cost_ledger()
        for metric in self.costs.metrics():
            try:
                reg.register(metric)
            except ValueError:
                pass  # already adopted (shared registry, repeat bind)
        self.profiler = get_profiler()
        for metric in self.profiler.metrics():
            try:
                reg.register(metric)
            except ValueError:
                pass  # already adopted (shared registry, repeat bind)
        # compile tracker exposition (observability/device_watch.py):
        # shared by every plane/shard in the process
        for metric in compile_metrics():
            reg.register(metric)
        # native codec availability (native/__init__.py): status gauge
        # set at first get_codec() resolution — a silent fallback to the
        # slow Python codec must be visible on /metrics
        from ..native import codec_info_metrics

        for metric in codec_info_metrics():
            try:
                reg.register(metric)
            except ValueError:
                pass  # already adopted (shared registry, repeat bind)
        # SLO engine (observability/slo.py): e2e latency + wire error
        # rate by default; the breaker-open fraction target joins when a
        # supervised plane binds. Thresholds snap to histogram bucket
        # bounds for exact good/bad counting.
        self.slo = SloEngine(sample_interval_s=slo_sample_interval_s)
        self.slo.add(
            latency_slo(
                "update_e2e_latency",
                self.update_e2e,
                threshold_s=slo_e2e_p99_ms / 1000.0,
                objective=0.99,
                stage="total",
                # description generated by the factory: it reports the
                # EFFECTIVE (bucket-snapped) threshold, not the request
            )
        )
        self.slo.add(
            counter_ratio_slo(
                "wire_error_rate",
                self.wire.messages_in,
                self.wire.errors,
                objective=1.0 - slo_error_rate,
                description=(
                    f"{1.0 - slo_error_rate:.2%} of inbound messages handled "
                    "without closing the channel"
                ),
            )
        )
        # fleet view (observability/fleet.py): the federated-telemetry
        # singleton — adopted like the wire collector, plus the fleet
        # cross-tier e2e target (--slo-fleet-e2e-ms) fed by the
        # edge-to-edge histogram. A process that never sees cross-tier
        # traffic produces no observations, so the target simply never
        # votes (no traffic != breach).
        self.fleet = get_fleet_view().enable()
        for metric in self.fleet.metrics():
            try:
                reg.register(metric)
            except ValueError:
                pass  # already adopted (shared registry, repeat bind)
        self.slo.add(
            latency_slo(
                "fleet_e2e_latency",
                self.fleet.e2e_histogram,
                threshold_s=slo_fleet_e2e_ms / 1000.0,
                objective=0.99,
                stage="total",
            )
        )
        for metric in self.slo.metrics():
            reg.register(metric)

    # -- lifecycle ---------------------------------------------------------

    async def on_configure(self, data: Payload) -> None:
        instance = data.instance
        self._instance = instance
        # light the socket edge: wire-telemetry sites cost one attribute
        # read until this flips
        self.wire.enable()
        # light the per-frame cost ledger and start the always-on
        # sampling profiler (hz<=0, e.g. --profile-hz=0, keeps it off);
        # the burst trigger rides the overload controller's loop-lag
        # sampler — membership-checked so repeat configures (and the
        # singleton profiler across test servers) install it once, and
        # re-installed here after every OverloadController.reset()
        self.costs.enable()
        self.profiler.ensure_started()
        from ..server.overload import get_overload_controller

        controller = get_overload_controller()
        if self.profiler.note_loop_lag not in controller.on_loop_lag:
            controller.on_loop_lag.append(self.profiler.note_loop_lag)
        # default fleet identity (role extensions force their own later:
        # CellIngress at configure, EdgeGateway at listen)
        self.fleet.set_identity("monolith", f"monolith-{os.getpid()}", force=False)
        self._set_build_info()
        # slow-span promotion feeds the labelled counter even when the
        # span ring has wrapped (tracing.Tracer._promote_slow fires at
        # finish time, not export time)
        if self._slow_span_cb is None:
            self._slow_span_cb = lambda sp: self.slow_spans.inc(site=sp.name)
            get_tracer().on_slow.append(self._slow_span_cb)
        self.registry.gauge(
            "hocuspocus_documents",
            "Documents currently in memory",
            fn=lambda: instance.get_documents_count(),
        )
        self.registry.gauge(
            "hocuspocus_connections",
            "Open connections (websocket + direct)",
            fn=lambda: instance.get_connections_count(),
        )
        # TPU merge plane health (degradations, serve traffic): surface
        # every plane counter so a 100k-doc deployment can alert on docs
        # silently falling off the device path. The key set is complete
        # by construction: MergePlane pre-declares every counter in
        # __init__ and retire_doc uses strict key access.
        # durability plane (storage/extension.py): WAL append/commit/
        # recovery counters + the store-quarantine population — the
        # crash-safety story must be alertable, not just logged
        self.registry.gauge(
            "hocuspocus_store_quarantined_docs",
            "Documents whose store chain exhausted its retries (kept "
            "loaded + WAL retained; /healthz reports degraded)",
            fn=lambda: len(getattr(instance, "quarantine", ()) or ()),
        )
        for extension in getattr(instance.configuration, "extensions", []):
            if callable(getattr(extension, "wal_stats", None)):
                self._bind_durability_metrics(extension)
                break
        for extension in getattr(instance.configuration, "extensions", []):
            supervisor = getattr(extension, "supervisor", None)
            if supervisor is not None and hasattr(supervisor, "snapshot"):
                # supervised plane: the runtime (and its counters) may
                # not exist yet — bind the supervisor surface now and
                # the plane metrics at hot-attach time
                self._bind_supervisor_metrics(supervisor)
                break
            if self._bind_plane_metrics(extension):
                break  # one plane per server

    def _set_build_info(self) -> None:
        """`hocuspocus_tpu_build_info 1` with version/backend/device
        labels — the standard join target for dashboards ("which build
        is this scrape from?"). Refreshed at every scrape (labels go
        stale otherwise: the supervisor's worker thread brings CUDA up
        AFTER configure) and must NEVER initialize CUDA itself — that is
        the boot work the plane supervisor bounds with its deadline.
        Only an ALREADY-initialized CUDA runtime is reported as "cuda";
        until then the labels read the CPU backend that torch always
        has, or "none" before torch is imported."""
        from .. import __version__

        backend = "none"
        device_count = 0
        torch = sys.modules.get("torch")
        if torch is not None:
            try:
                if torch.cuda.is_initialized():
                    backend = "cuda"
                    device_count = int(torch.cuda.device_count())
                else:
                    backend = "cpu"
                    device_count = 1
            except Exception:
                backend = "unknown"
        gauge = self.registry.gauge(
            "hocuspocus_tpu_build_info",
            "Build/runtime identity (constant 1; labels carry the data)",
        )
        gauge.clear()
        gauge.set(
            1.0,
            version=str(__version__),
            backend=backend,
            device_count=str(device_count),
        )

    def health_status(self) -> dict:
        """SLO rollup folded into `Hocuspocus.get_health()` / `/healthz`:
        a target breaching its multi-window burn-rate rule downgrades
        the server to "degraded" — the same verdict `/debug/slo` and the
        burn-rate gauges report, so the supervisor story and the SLO
        story can't disagree."""
        self.slo.maybe_sample()
        status = self.slo.status()
        breaching = [
            name for name, slo in status["slos"].items() if slo["breaching"]
        ]
        return {
            "state": "burning" if breaching else "ok",
            "degraded": bool(breaching),
            "breaching": breaching,
            "slos": {
                name: {
                    window: stats["burn_rate"]
                    for window, stats in slo["windows"].items()
                }
                for name, slo in status["slos"].items()
            },
        }

    def _bind_plane_metrics(self, owner) -> bool:
        """Register the plane-counter gauges for `owner` (an extension
        with `.plane`, or the sharded router with `.shards`). Returns
        True when a plane surface was found and bound."""
        reg = self.registry
        # device-lane arbiter telemetry (tpu/scheduler.py): wait
        # histograms per class, queue depths, occupancy, preemption/
        # starvation/deferral counters — adopted like the wire collector
        lane = getattr(owner, "lane", None)
        if lane is not None and callable(getattr(lane, "metrics", None)):
            for metric in lane.metrics():
                try:
                    reg.register(metric)
                except ValueError:
                    pass  # already adopted (shared lane, repeat bind)
        plane = getattr(owner, "plane", None)
        counters = getattr(plane, "counters", None)
        if isinstance(counters, dict):
            self._plane_owner = owner
            self._bind_trace_book(plane)
            for key in counters:
                # keys like "plane_broadcasts" already carry the prefix
                metric = f"hocuspocus_tpu_plane_{key.removeprefix('plane_')}"
                reg.gauge(
                    metric,
                    f"TPU merge plane counter: {key}",
                    fn=(lambda c=counters, k=key: c[k]),
                )
            reg.gauge(
                "hocuspocus_tpu_plane_arena_rows_in_use",
                "Arena rows (sequences) currently allocated on the plane",
                fn=(lambda p=plane: p.num_docs - len(p.free)),
            )
            reg.gauge(
                "hocuspocus_tpu_plane_ops_integrated",
                "Ops integrated by the device since start",
                fn=(lambda p=plane: p.total_integrated),
            )
            # flush-stage pipeline gauges (docs/guides/tpu-merge-
            # pipeline.md): last cycle's build/upload/device times,
            # dispatched (K, B) shape, busy width and upload volume —
            # how an operator sees host work scale with BUSY docs, not
            # the resident population
            for key in getattr(plane, "flush_stats", {}):
                reg.gauge(
                    f"hocuspocus_tpu_plane_flush_{key}",
                    f"TPU merge plane flush stage stat: {key} (last cycle)",
                    fn=(lambda p=plane, k=key: p.flush_stats[k]),
                )
            # arena occupancy (docs/guides/tpu-residency.md): capacity
            # pressure must be visible BEFORE admission starts failing.
            # free + live + retired partition the arena; retired rows
            # are allocated-but-degraded (bound to docs off the device
            # path until unload or compaction reclaims them).
            reg.gauge(
                "hocuspocus_tpu_plane_slots_free",
                "Arena rows on the free list (admission headroom)",
                fn=(lambda p=plane: len(p.free)),
            )
            reg.gauge(
                "hocuspocus_tpu_plane_slots_live",
                "Arena rows bound to live (plane-served) docs",
                fn=(lambda p=plane: int(p.slot_live.sum())),
            )
            reg.gauge(
                "hocuspocus_tpu_plane_slots_retired",
                "Arena rows held by retired/degraded docs until unload",
                fn=(
                    lambda p=plane: p.num_docs
                    - len(p.free)
                    - int(p.slot_live.sum())
                ),
            )
            # residency subsystem stats (evicted population, hydration
            # queue/latency, compaction timings)
            for key in getattr(plane, "residency_stats", {}):
                reg.gauge(
                    f"hocuspocus_tpu_plane_residency_{key}",
                    f"TPU plane residency stat: {key}",
                    fn=(lambda p=plane, k=key: p.residency_stats[k]),
                )
            # device-memory watch (observability/device_watch.py):
            # arena/staging bytes, the biggest single-cycle upload, and
            # the cumulative readback-barrier stall time
            if hasattr(plane, "memory_stats"):
                for key in plane.memory_stats():
                    reg.gauge(
                        f"hocuspocus_tpu_plane_{key}",
                        f"TPU plane device-memory stat: {key}",
                        fn=(lambda p=plane, k=key: p.memory_stats()[k]),
                    )
            return True
        # the sharded router and the multi-device cell plane (their
        # summed and labelled gauges) come with sharding (ROADMAP.md,
        # Queue A)
        return False

    def _bind_durability_metrics(self, durability) -> None:
        """One gauge per WAL stat (hocuspocus_wal_*): appended records/
        bytes, fsyncs, group-commit batch sizes, append errors, and the
        recovery report (replayed records/bytes, torn tails)."""
        # read the live stats dict directly: wal_stats() copies it, and
        # ~15 gauges x one copy each per scrape is pure garbage churn
        stats = durability.wal.stats
        for key in stats:
            self.registry.gauge(
                f"hocuspocus_wal_{key}",
                f"Write-ahead log stat: {key} (docs/guides/durability.md)",
                fn=(lambda s=stats, k=key: s[k]),
            )

    def _bind_trace_book(self, plane) -> None:
        """Point the plane's update-lifecycle trace book at the labelled
        e2e histogram, and route slow-flush promotions into the per-doc
        flight recorder."""
        book = getattr(plane, "update_traces", None)
        if book is None:
            return
        book.histogram = self.update_e2e
        if book.on_slow_flush is None:
            recorder = get_flight_recorder()
            book.on_slow_flush = lambda name, ms: recorder.record(
                name, "slow_flush", e2e_ms=round(ms, 3)
            )

    def _bind_supervisor_metrics(self, supervisor) -> None:
        """Plane supervisor surface (tpu/supervisor.py): state, breaker,
        transition counters and canary latency. Bound at configure time
        — before supervision starts at listen time — so no transition
        or probe is ever missed."""
        reg = self.registry
        reg.gauge(
            "hocuspocus_tpu_supervisor_state",
            "Plane supervisor state (0=initializing 1=ready 2=degraded 3=broken)",
            fn=supervisor.state_code,
        )
        reg.gauge(
            "hocuspocus_tpu_supervisor_breaker_state",
            "Plane circuit breaker state (0=closed 1=open 2=half_open)",
            fn=supervisor.breaker_code,
        )
        reg.gauge(
            "hocuspocus_tpu_supervisor_breaker_consecutive_failures",
            "Consecutive canary failures feeding the breaker",
            fn=(lambda b=supervisor.breaker: b.consecutive_failures),
        )
        reg.gauge(
            "hocuspocus_tpu_supervisor_canary_latency_seconds",
            "Most recent canary merge latency (0 until the first probe)",
            fn=(lambda s=supervisor: s.last_canary_latency or 0.0),
        )
        canary = reg.histogram(
            "hocuspocus_tpu_supervisor_canary_seconds",
            "Watchdog canary merge latency",
        )
        supervisor.on_canary.append(canary.observe)
        transitions = reg.counter(
            "hocuspocus_tpu_supervisor_transitions_total",
            "Supervisor state transitions",
        )
        supervisor.on_transition.append(
            lambda frm, to: transitions.inc(from_state=frm, to_state=to)
        )
        breaker_transitions = reg.counter(
            "hocuspocus_tpu_supervisor_breaker_transitions_total",
            "Circuit breaker state transitions",
        )
        supervisor.breaker.on_transition.append(
            lambda frm, to: breaker_transitions.inc(from_state=frm, to_state=to)
        )
        for key in supervisor.counters:
            reg.gauge(
                f"hocuspocus_tpu_supervisor_{key}",
                f"Plane supervisor counter: {key}",
                fn=(lambda c=supervisor.counters, k=key: c[k]),
            )
        # the plane's own counters bind the moment a runtime attaches
        supervisor.on_attach.append(self._bind_plane_metrics)
        # breaker-open fraction SLO: each engine sample observes the
        # breaker state, so the windowed fraction is time-open at
        # sample-interval resolution
        if not any(t.name == "breaker_open_fraction" for t in self.slo.targets):
            self.slo.add(
                fraction_slo(
                    "breaker_open_fraction",
                    lambda b=supervisor.breaker: b.state != "closed",
                    objective=0.99,
                    description=(
                        "plane circuit breaker closed for 99% of sampled time"
                    ),
                )
            )

    async def on_listen(self, data: Payload) -> None:
        # background burn-rate sampler: scrape-driven sampling alone
        # would leave windows empty on servers nobody is scraping yet
        if self._slo_task is None or self._slo_task.done():
            self._slo_task = asyncio.ensure_future(self._slo_sampler())
        # seed the fleet view so a fresh monolith answers /debug/fleet
        # with itself before the first sampler tick
        self._ingest_local_digest()

    async def _slo_sampler(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.slo.sample_interval_s)
                self.slo.maybe_sample()
                self._ingest_local_digest()
        except asyncio.CancelledError:
            pass

    def _ingest_local_digest(self) -> None:
        """Monolith-role federation: processes with no relay lane still
        show up in their own /debug/fleet (and any co-resident view).
        Edge/cell roles publish richer digests themselves — this ingest
        defers to them."""
        if self.fleet.role not in (None, "monolith"):
            return
        try:
            self.fleet.ingest(
                build_digest(
                    role=self.fleet.role or "monolith",
                    node_id=self.fleet.node_id or f"monolith-{os.getpid()}",
                    instance=self._instance,
                    interval_s=self.slo.sample_interval_s,
                )
            )
        except Exception:
            pass  # the sampler must never die to a digest

    async def connected(self, data: Payload) -> None:
        self.connects.inc()
        name = getattr(data, "document_name", None)
        if name:
            document = getattr(getattr(data, "connection", None), "document", None)
            get_flight_recorder().record(
                name,
                "connect",
                connections=document.get_connections_count()
                if document is not None
                else None,
            )

    async def on_disconnect(self, data: Payload) -> None:
        self.disconnects.inc()
        name = getattr(data, "document_name", None)
        if name:
            # clients_count in the disconnect payload is taken AFTER the
            # connection was removed: the audience remaining
            get_flight_recorder().record(
                name, "disconnect", connections=getattr(data, "clients_count", None)
            )

    async def on_change(self, data: Payload) -> None:
        self.changes.inc()

    # Load/store latency start times ride on the hook payload (the same
    # Payload object reaches the on_* and after_* hooks), so an aborted
    # chain cannot leak bookkeeping.

    async def on_load_document(self, data: Payload) -> None:
        data._metrics_started = time.perf_counter()

    async def after_load_document(self, data: Payload) -> None:
        self.loads.inc()
        started = getattr(data, "_metrics_started", None)
        if started is not None:
            self.load_seconds.observe(time.perf_counter() - started)

    async def on_store_document(self, data: Payload) -> None:
        data._metrics_started = time.perf_counter()

    async def after_store_document(self, data: Payload) -> None:
        self.stores.inc()
        started = getattr(data, "_metrics_started", None)
        if started is not None:
            self.store_seconds.observe(time.perf_counter() - started)

    async def after_unload_document(self, data: Payload) -> None:
        self.unloads.inc()

    async def on_awareness_update(self, data: Payload) -> None:
        self.awareness_updates.inc()

    async def on_stateless(self, data: Payload) -> None:
        self.stateless.inc()

    async def on_destroy(self, data: Payload) -> None:
        if self._slo_task is not None:
            self._slo_task.cancel()
            self._slo_task = None
        # unbind the global-tracer callback so test servers (one Metrics
        # instance each) don't accumulate dead counters on the tracer
        if self._slow_span_cb is not None:
            try:
                get_tracer().on_slow.remove(self._slow_span_cb)
            except ValueError:
                pass
            self._slow_span_cb = None

    # -- scrape + debug endpoints ------------------------------------------

    async def on_request(self, data: Payload) -> None:
        request = data.request
        path = getattr(getattr(request, "rel_url", None), "path", None) or getattr(
            request, "path", ""
        )
        if path == self.path:
            # keep the burn-rate gauges and build-info labels fresh
            self.slo.maybe_sample()
            self._set_build_info()
            try:
                # hocuspocus_fleet_* rollup gauges re-label from the
                # current peer table at scrape time (like the cell gauges)
                self.fleet.refresh_gauges()
            except Exception:
                pass
            body = self.registry.expose()
            if self.expose_tracer:
                import json

                spans = get_tracer().export()
                body += "\n# tracer\n" + "\n".join(
                    "# " + json.dumps(span) for span in spans[-100:]
                ) + "\n"
            from aiohttp import web

            # Prometheus text exposition format 0.0.4: scrapers content-
            # negotiate on the version parameter. Series order is
            # deterministic (registry, label-set and bucket iteration
            # are all sorted), so consecutive scrapes diff cleanly.
            data.response = web.Response(
                body=body.encode("utf-8"),
                headers={
                    "Content-Type": "text/plain; version=0.0.4; charset=utf-8"
                },
            )
            # Raising aborts the rest of the hook chain and the default
            # "Welcome" response; the server serves `data.response` instead
            # (same mechanism as reference request interception,
            # `packages/server/src/Server.ts:114-137`).
            error = _ServeMetrics()
            error.response = data.response
            raise error
        if path == "/healthz" and self._instance is not None:
            # the supervised-plane extension serves this too (same
            # payload); Metrics covers deployments without a plane —
            # e.g. a CPU server whose durability quarantine must still
            # degrade the balancer health check. Repo-wide convention
            # (pinned by test_healthz_endpoint_reports_plane_state):
            # "degraded" still answers HTTP 200 — the server SERVES,
            # degraded is a steer signal for body-parsing probes, not a
            # kill signal that would drop every live session
            # healthz keeps its own payload contract (no debug header):
            # balancer probes parse it, and extra keys buy them nothing
            self._serve_json(data, self._instance.get_health(), stamp=False)
        if self.debug_endpoints:
            if path == "/debug/slo":
                self.slo.maybe_sample()
                status = self.slo.status()
                # overload ladder state rides the SLO surface: burn
                # rates say the budget is going, the rung says what the
                # server is already doing about it
                from ..server.overload import get_overload_controller

                status["overload"] = get_overload_controller().status()
                self._serve_json(data, status)
            if path == "/debug/fleet":
                # federated telemetry rollup (docs/guides/observability.md
                # fleet view): every live role/cell this process knows
                # about, from digests on the relay control channel plus
                # its own — the one pane for "is the fleet healthy?"
                self._serve_json(data, self.fleet.status())
            if path == "/debug/loadgen":
                # live scenario-run timeline: the loadgen runner narrates
                # into a process-global singleton; imported lazily so
                # serving /metrics never pulls the loadgen package
                from ..loadgen.timeline import get_loadgen_timeline

                self._serve_json(data, get_loadgen_timeline().status())
            if path == "/debug/scheduler":
                self._serve_json(data, self._scheduler_overview())
            if path == "/debug/trace":
                self._serve_json(data, get_tracer().export_chrome_trace())
            if path == "/debug/docs":
                self._serve_json(data, self._docs_overview())
            if path.startswith("/debug/docs/"):
                from urllib.parse import unquote

                name = unquote(path[len("/debug/docs/") :])
                self._serve_json(
                    data,
                    {"doc": name, "events": get_flight_recorder().events(name)},
                )
            if path == "/debug/costs":
                # per-frame cost ledger table + headroom model
                # (docs/guides/observability.md "profiling & cost attribution")
                self._serve_json(data, self.costs.table(wire=self.wire))
            if path in ("/debug/profile", "/debug/profile/device"):
                # one /debug/profile/{device,cpu} namespace; the bare
                # path stays a device alias for existing tooling
                self._serve_json(data, await self._run_profile(request))
            if path == "/debug/profile/cpu":
                self._serve_cpu_profile(data, request)
        self.http_requests.inc()

    def _serve_json(
        self, data: Payload, payload: dict, stamp: bool = True, status: int = 200
    ) -> None:
        import json

        from aiohttp import web

        if stamp and isinstance(payload, dict):
            # every /debug payload carries the consistent attributable
            # header {"generated_utc", "role", "node_id"} — aggregated
            # or archived captures stay traceable to their source
            payload = stamp_header(payload)
        data.response = web.Response(
            text=json.dumps(payload), content_type="application/json", status=status
        )
        error = _ServeMetrics()
        error.response = data.response
        raise error

    def _serve_cpu_profile(self, data: Payload, request) -> None:
        """`GET /debug/profile/cpu`: the sampling profiler's folded-stack
        table. Default JSON `{stats, collapsed}` with the standard
        stamped debug header; `?format=collapsed` returns the raw
        collapsed-stack text for flamegraph.pl / speedscope (every line
        stays `stack count`-parseable, so the stamp rides in X- headers
        instead)."""
        query = getattr(getattr(request, "rel_url", None), "query", None)
        if query is None:
            query = getattr(request, "query", None) or {}
        fmt = str(query.get("format", "json"))
        profiler = self.profiler
        if fmt in ("collapsed", "folded", "raw"):
            from aiohttp import web

            stamp = stamp_header({})
            data.response = web.Response(
                text=profiler.collapsed() + "\n",
                content_type="text/plain",
                headers={
                    "X-Generated-Utc": str(stamp["generated_utc"]),
                    "X-Role": str(stamp["role"]),
                    "X-Node-Id": str(stamp["node_id"]),
                },
            )
            error = _ServeMetrics()
            error.response = data.response
            raise error
        self._serve_json(
            data,
            {"stats": profiler.stats(), "collapsed": profiler.collapsed()},
        )

    async def _run_profile(self, request) -> dict:
        """On-demand `torch.profiler` capture: `GET /debug/profile?secs=N`
        records host ops and, where CUDA is up, every kernel the card
        runs (CUPTI) for N seconds, and returns the Chrome trace it wrote
        (open it in Perfetto or chrome://tracing) with the names of the
        device activities it saw (kernels, copies). Device spans
        (`Tracer.device_span`) annotate the capture via
        `torch.profiler.record_function`. A
        capture that cannot start is reported in the answer; it never
        changes how the plane runs. `gc` is the process's garbage
        collections in the window, by generation (count, seconds, share
        of the window): a collection holds the interpreter lock, and the
        sampling profiler cannot see it."""
        query = getattr(getattr(request, "rel_url", None), "query", None)
        if query is None:
            query = getattr(request, "query", None) or {}
        try:
            secs = float(query.get("secs", 3.0))
        except (TypeError, ValueError):
            secs = 3.0
        secs = min(max(secs, 0.1), 60.0)
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
        except Exception as error:
            return {"error": f"torch.profiler unavailable: {error!r}"}
        import tempfile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        fd, artifact = tempfile.mkstemp(prefix="hocuspocus-tpu-profile-", suffix=".json")
        os.close(fd)
        try:
            capture = profile(activities=activities)
            capture.start()
        except Exception as error:
            return {"error": f"profiler start failed: {error!r}"}
        gc_window = _GcWindow()
        try:
            with gc_window:
                await asyncio.sleep(secs)
        finally:
            try:
                capture.stop()
                capture.export_chrome_trace(artifact)
            except Exception as error:
                return {"error": f"profiler stop failed: {error!r}"}
        device_events = [
            event for event in capture.events() if event.device_type == torch.autograd.DeviceType.CUDA
        ]
        return {
            "artifact": artifact,
            "seconds": secs,
            "activities": [activity.name for activity in activities],
            "device_events": len(device_events),
            "kernels": sorted({event.name for event in device_events}),
            "gc": gc_window.summary(secs),
        }

    def _planes(self) -> list:
        owner = self._plane_owner
        plane = getattr(owner, "plane", None) if owner is not None else None
        if plane is not None and hasattr(plane, "_busy_slots"):
            return [plane]
        return []

    def _scheduler_overview(self) -> dict:
        """`/debug/scheduler`: the device-lane arbiter's state (classes,
        queue depths, occupancy, preemption/starvation accounting) plus
        every shard's batching-governor snapshot
        (docs/guides/tpu-scheduling.md)."""
        owner = self._plane_owner
        if owner is None:
            return {"scheduler": None, "note": "no merge plane bound"}
        runtime = getattr(owner, "runtime", None)
        if runtime is not None:
            owner = runtime  # supervised: the runtime holds lane/governor
        snapshot_fn = getattr(owner, "scheduler_snapshot", None)
        if callable(snapshot_fn):
            return snapshot_fn()
        return {"scheduler": None, "note": "plane owner has no scheduler"}

    def _docs_overview(self, top_k: int = 20) -> dict:
        """`/debug/docs`: top-K busiest docs (driven by the planes' busy
        slot sets + queue depths) and the flight recorder's
        recently-eventful docs."""
        rows: dict[str, dict] = {}
        for plane in self._planes():
            for slot in list(plane._busy_slots):
                name = plane.slot_owner.get(slot)
                if name is None:
                    continue
                row = rows.setdefault(
                    name, {"doc": name, "busy_slots": 0, "queued_ops": 0}
                )
                row["busy_slots"] += 1
                row["queued_ops"] += len(plane.queues.get(slot) or ())
        busiest = sorted(
            rows.values(), key=lambda row: -row["queued_ops"]
        )[:top_k]
        return {
            "busiest": busiest,
            "docs": get_flight_recorder().docs()[: max(top_k, 50)],
        }


class _ServeMetrics(Exception):
    """Internal: short-circuits the on_request chain with a response."""

    def __str__(self) -> str:  # suppress hook-chain error logging
        return ""


class _GcWindow:
    """Garbage collections while the context is open, timed through
    `gc.callbacks` (a collection runs on one thread and holds the
    interpreter lock from its start to its stop)."""

    def __init__(self) -> None:
        self.counts = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._started = 0.0

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._started = time.perf_counter()
            return
        generation = int(info.get("generation", 0))
        self.counts[generation] += 1
        self.seconds[generation] += time.perf_counter() - self._started

    def __enter__(self) -> "_GcWindow":
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._callback)

    def summary(self, window_s: float) -> dict:
        return {
            f"gen{generation}": {
                "n": self.counts[generation],
                "seconds": self.seconds[generation],
                "share": self.seconds[generation] / window_s if window_s else None,
            }
            for generation in range(3)
        }
