"""CLI entrypoint (reference `packages/cli`): `hocuspocus-tpu-torch --port 1234`.

The port's counterpart of the JAX package's `hocuspocus-tpu`, with the
same flags. With `--tpu-serve` (or `--tpu-merge`) the merge plane runs
on the card (`--tpu-device cuda`, the default, which fails without
CUDA) unless `--tpu-device cpu` asks for the CPU. `--tpu-devices N`
runs N supervised merge cells (0 = one per visible card; more cells
than cards wrap, so one card holds several), each with its own arena
and device lane, `--tpu-docs` / `--tpu-capacity` sized per cell;
`--fleet-autoscale` puts the fleet controller over those cells
(`--fleet-warm-spares` of them boot parked). The branches whose modules
are not ported yet exit with code 2 and one line on stderr naming their
ROADMAP.md Queue A item: `--tpu-shards > 1`, `--tpu-scheduler off` and
the lane and governor tuning flags away from their defaults (item 7b).
`--role cell` makes the server a merge cell of the edge
tier (with `--tpu-serve`, its plane on the card by default), and
`--role edge` a stateless edge server in front of the cells.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hocuspocus-tpu-torch",
        description="Run the collaboration backend server, its merge plane in "
        "PyTorch and CUDA.",
    )
    parser.add_argument("--port", "-p", type=int, default=1234, help="port to listen on")
    parser.add_argument("--host", default="0.0.0.0", help="host to bind")
    # edge tier + cell router (docs/guides/edge-routing.md): split the
    # million-connection front door from the merge cells. An 'edge'
    # terminates websockets, authenticates/admits at the door and
    # relays frames to each doc's owning cell over the pipelined RESP
    # lane; a 'cell' is a normal serving instance that also accepts
    # relayed edge sessions and announces its lifecycle (up/draining/
    # down) on the relay control channel; 'monolith' (default) is the
    # classic single-role server.
    parser.add_argument(
        "--role",
        choices=("monolith", "edge", "cell"),
        default="monolith",
        help="process role: 'monolith' (default) terminates sockets AND "
        "merges; 'edge' is a stateless front door relaying to cells; "
        "'cell' merges docs and serves relayed edge sessions "
        "(docs/guides/edge-routing.md)",
    )
    parser.add_argument(
        "--cell-id",
        help="stable cell identity on the relay bus (role=cell; default "
        "cell-<port>) — the rendezvous-hash key docs map to, so keep it "
        "stable across restarts",
    )
    parser.add_argument(
        "--edge-id",
        help="edge identity on the relay bus (role=edge; default a "
        "random edge-<hex> — edges are stateless, identity is per-boot)",
    )
    parser.add_argument(
        "--relay-redis-host",
        default="127.0.0.1",
        help="redis host backing the edge<->cell relay lane (default "
        "127.0.0.1)",
    )
    parser.add_argument(
        "--relay-redis-port", type=int, default=6379, help="relay redis port"
    )
    parser.add_argument(
        "--relay-prefix",
        default="hocuspocus-edge",
        help="channel prefix for the relay lane + control channel",
    )
    parser.add_argument(
        "--relay-queue-limit",
        type=int,
        default=1024,
        help="frames a parked/re-establishing edge doc channel may "
        "buffer before the oldest is shed (accounted, healed by the "
        "rebind resync; default 1024)",
    )
    # elastic fleet (docs/guides/elastic-fleet.md): cross-host cell
    # admission + the autoscaling controller over warm-spare cells.
    parser.add_argument(
        "--host-id",
        help="host identity on the relay bus: qualifies this process's "
        "cell id as <host-id>/<cell-id> so cells from DIFFERENT hosts "
        "can share one control channel, and (role=edge) marks which "
        "cells are local — foreign cells are admitted only once their "
        "clock offset resolves (docs/guides/elastic-fleet.md)",
    )
    parser.add_argument(
        "--fleet-autoscale",
        action="store_true",
        help="run the fleet autoscaling controller over the multi-device "
        "cell plane (requires --tpu-devices != 1): scale-up activates "
        "warm-spare cells, scale-down drains the coldest cell over the "
        "migration rail; all scaling parks while the overload ladder is "
        "at BROWNOUT-1+ (docs/guides/elastic-fleet.md)",
    )
    parser.add_argument(
        "--fleet-interval",
        type=float,
        default=2.0,
        help="autoscaler decision cadence in seconds (default 2)",
    )
    parser.add_argument(
        "--fleet-min-cells",
        type=int,
        default=1,
        help="floor the autoscaler may never scale below (default 1)",
    )
    parser.add_argument(
        "--fleet-warm-spares",
        type=int,
        default=0,
        help="cells parked as pre-warmed spares at boot — arena and "
        "registry stay built, so activation is one placement-epoch "
        "bump (default 0 = start with every cell active)",
    )
    parser.add_argument(
        "--fleet-up",
        type=float,
        default=0.75,
        help="mean fleet-load signal that (held for --fleet-hold-ticks) "
        "activates a warm spare (default 0.75)",
    )
    parser.add_argument(
        "--fleet-down",
        type=float,
        default=0.35,
        help="mean fleet-load signal that (held, and only when the "
        "survivors' projected load stays in band) parks the coldest "
        "cell (default 0.35)",
    )
    parser.add_argument(
        "--fleet-hold-ticks",
        type=int,
        default=3,
        help="consecutive out-of-band decision ticks before the "
        "autoscaler acts — the anti-flap hysteresis hold (default 3)",
    )
    parser.add_argument(
        "--fleet-work-target",
        type=float,
        default=150.0,
        help="dispatched merge units/second that count as a fully "
        "loaded cell in the fleet-load signal (default 150)",
    )
    parser.add_argument("--webhook", "-w", help="webhook URL to POST document changes to")
    parser.add_argument(
        "--sqlite",
        "-s",
        nargs="?",
        const=":memory:",
        help="store documents in SQLite (optional path, default in-memory)",
    )
    parser.add_argument("--s3", action="store_true", help="store documents in S3")
    # durability plane (docs/guides/durability.md): per-doc write-ahead
    # log + crash recovery, store retry/quarantine, graceful drain
    parser.add_argument(
        "--wal-dir",
        help="enable the write-ahead log: append every update to a "
        "segmented CRC-framed per-document log under this directory "
        "BEFORE broadcast, and replay the log suffix over the stored "
        "snapshot at load — a kill -9 between debounced stores loses "
        "nothing (docs/guides/durability.md)",
    )
    parser.add_argument(
        "--wal-fsync",
        choices=("tick", "always", "off"),
        default="tick",
        help="WAL durability mode: 'tick' group-commits with one fsync "
        "per doc per event-loop tick (default), 'always' fsyncs every "
        "record, 'off' writes without fsync (OS-decided durability)",
    )
    parser.add_argument(
        "--store-retries",
        type=int,
        default=2,
        help="retries (after the first attempt) for a failing "
        "on_store_document chain, with exponential backoff + jitter; "
        "after exhaustion the doc is quarantined — kept loaded, WAL "
        "retained, periodically re-stored, /healthz degraded — instead "
        "of silently dropping data (default 2)",
    )
    parser.add_argument(
        "--drain-timeout-secs",
        type=float,
        default=20.0,
        help="SIGTERM drain deadline: stop accepting connections, flush "
        "the WAL, store every dirty doc concurrently within this many "
        "seconds, then close clients with 1012 Service Restart; docs "
        "still storing at the deadline are quarantined, never lost "
        "(default 20)",
    )
    parser.add_argument("--s3-bucket", help="S3 bucket")
    parser.add_argument("--s3-region", default="us-east-1", help="S3 region")
    parser.add_argument("--s3-prefix", default="", help="S3 key prefix")
    parser.add_argument("--s3-endpoint", help="S3 endpoint override")
    parser.add_argument(
        "--tpu-merge",
        action="store_true",
        help="enable the TPU batched merge plane extension (shadow mode)",
    )
    parser.add_argument(
        "--tpu-serve",
        action="store_true",
        help="serve sync replies and broadcasts FROM the TPU plane (implies --tpu-merge)",
    )
    parser.add_argument(
        "--tpu-device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the merge plane runs: 'cuda' (default; the card, and "
        "boot fails without one) or 'cpu' (only when asked)",
    )
    parser.add_argument(
        "--tpu-docs",
        type=int,
        default=1024,
        help="merge plane arena rows (sequences), default 1024",
    )
    parser.add_argument(
        "--tpu-capacity",
        type=int,
        default=4096,
        help="merge plane arena capacity per row (units), default 4096",
    )
    parser.add_argument(
        "--tpu-flush-interval",
        type=float,
        default=5.0,
        help="device flush cadence in ms (validation pipeline), default 5",
    )
    parser.add_argument(
        "--tpu-broadcast-interval",
        type=float,
        default=2.0,
        help="broadcast coalescing window in ms (edits within the window "
        "share one frame per doc; idle edits broadcast immediately), "
        "default 2",
    )
    parser.add_argument(
        "--tpu-shards",
        type=int,
        default=1,
        help="doc-partitioned merge planes (serve mode): each shard "
        "flushes its own arena, keeping microbatch latency bounded at "
        "large doc populations; --tpu-docs is the per-shard width. "
        "Default 1 (single plane)",
    )
    # multi-device merge cells (docs/guides/multi-device.md): one full
    # merge cell — arena, device lane, governor, warm grid, residency
    # clock — per chip, with rendezvous doc placement and load-aware
    # rebalancing over the evict-snapshot→hydrate migration rail.
    parser.add_argument(
        "--tpu-devices",
        type=int,
        default=1,
        help="per-device merge cells: 0 = one cell per visible chip, "
        "N > 1 = exactly N cells (wrapping the device roster), 1 = the "
        "classic single-plane layout (default). --tpu-docs/--tpu-capacity "
        "are PER-CELL sizes; mutually exclusive with --tpu-shards "
        "(docs/guides/multi-device.md)",
    )
    parser.add_argument(
        "--tpu-rebalance-interval",
        type=float,
        default=5.0,
        help="seconds between load-aware placement sweeps on the cell "
        "plane (0 disables rebalancing — placement stays pure "
        "rendezvous); default 5",
    )
    parser.add_argument(
        "--tpu-rebalance-ratio",
        type=float,
        default=2.0,
        help="a cell hotter than this multiple of the mean (dispatched "
        "work, lane depth, HBM) sheds docs to its coldest peer via the "
        "evict-snapshot->hydrate migration rail (default 2.0)",
    )
    parser.add_argument(
        "--tpu-migrate-batch",
        type=int,
        default=8,
        help="docs migrated per rebalance sweep — bounds migration "
        "churn under a skewed storm (default 8)",
    )
    parser.add_argument(
        "--tpu-arena",
        choices=("unit", "rle"),
        default="unit",
        help="device arena layout: 'unit' (one slot per UTF-16 unit) or "
        "'rle' (one entry per run — survives churny long-lived docs; "
        "--tpu-capacity then counts entries)",
    )
    # arena residency (docs/guides/tpu-residency.md): slots are a
    # managed cache — idle docs evict to host snapshots, cold docs
    # re-admit through a bounded hydration queue, pressured rows
    # compact on-device instead of retiring to the CPU path forever.
    parser.add_argument(
        "--tpu-evict-idle-secs",
        type=float,
        default=0.0,
        help="evict a doc's arena rows after this many seconds without "
        "an edit (serve mode; 0 disables eviction). Evicted docs serve "
        "from the CPU path and re-enter via batched hydration on their "
        "next edit or load (default 0)",
    )
    parser.add_argument(
        "--tpu-hydrate-batch",
        type=int,
        default=64,
        help="cold/evicted docs admitted back onto the plane per "
        "hydration round — the catch-up storm's concurrency bound "
        "(default 64)",
    )
    parser.add_argument(
        "--tpu-compact-threshold",
        type=float,
        default=0.75,
        help="row occupancy fraction that triggers on-device tombstone "
        "compaction; also enables compact-based recycling of "
        "capacity/overflow-retired docs (serve mode; 0 disables, "
        "default 0.75)",
    )
    # adaptive merge scheduling (docs/guides/tpu-scheduling.md): the
    # device-lane arbiter orders every dispatch by priority class
    # (interactive > catch-up > compaction > canary/warmup) and the
    # arrival-aware governor picks flush cadence + batch count from
    # measured load instead of the fixed timer.
    parser.add_argument(
        "--tpu-scheduler",
        choices=("on", "off"),
        default="on",
        help="adaptive merge scheduling: 'on' (default) runs every "
        "device dispatch through the priority-class lane arbiter and "
        "drives flush cadence from the op-arrival EWMA; 'off' restores "
        "the fixed flush timer with unarbitrated dispatches",
    )
    parser.add_argument(
        "--tpu-drain-watermark",
        type=int,
        default=256,
        help="queued-op depth at which the governor collapses the flush "
        "tick to an immediate full drain (default 256)",
    )
    parser.add_argument(
        "--tpu-flush-stretch",
        type=float,
        default=4.0,
        help="max factor the governor may stretch the flush tick under "
        "sparse arrivals — cheap, since broadcasts build from host "
        "serve logs and never wait on the device flush (default 4)",
    )
    parser.add_argument(
        "--tpu-lane-promote-ms",
        type=float,
        default=250.0,
        help="device-lane starvation guard: a queued background "
        "admission older than this is promoted to the interactive "
        "class so aged work always progresses (default 250)",
    )
    # plane supervisor (docs/guides/tpu-supervisor.md): the TPU runtime
    # is an accelerator the server may acquire, never a boot dependency
    # — a wedged/absent runtime degrades to CPU-merge mode, the server
    # keeps serving, and the plane hot-(re)attaches on recovery.
    parser.add_argument(
        "--tpu-init-timeout",
        type=float,
        default=30.0,
        help="seconds to wait for the plane's init (the kernels' build and "
        "the first launch) before booting in CPU-merge fallback; the plane "
        "hot-attaches if init completes later (default 30)",
    )
    parser.add_argument(
        "--tpu-watchdog-interval",
        type=float,
        default=5.0,
        help="seconds between plane watchdog canary merges; also the "
        "half-open recovery probe cadence (default 5)",
    )
    parser.add_argument(
        "--tpu-breaker-threshold",
        type=int,
        default=3,
        help="consecutive canary failures/overruns that open the circuit "
        "breaker, draining served docs to the CPU path until a recovery "
        "probe passes (default 3; see docs/guides/tpu-supervisor.md)",
    )
    # overload control plane (docs/guides/overload.md): the hysteresis
    # degradation ladder (GREEN -> BROWNOUT-1 -> BROWNOUT-2 -> RED)
    # driven by live load signals, plus per-tenant token-bucket
    # admission at connect/auth and message ingress.
    parser.add_argument(
        "--overload",
        choices=("on", "off"),
        default="on",
        help="overload control plane: 'on' (default) samples load "
        "signals (event-loop lag, send queues, device-lane depth, WAL "
        "commit latency, replication inbox) into a brownout ladder — "
        "park maintenance, stretch awareness, defer catch-up, reject "
        "new work at RED with 503 + Retry-After; 'off' disables all "
        "shedding and admission",
    )
    parser.add_argument(
        "--overload-hold-secs",
        type=float,
        default=2.0,
        help="hysteresis hold: the ladder steps DOWN one rung only "
        "after this many seconds of sustained calm (escalation is "
        "always immediate); prevents rung flapping (default 2)",
    )
    parser.add_argument(
        "--overload-retry-after",
        type=float,
        default=1.0,
        help="Retry-After seconds on 503 rejections (RED state, tenant "
        "quota, and the drain path share the same rejection; default 1)",
    )
    parser.add_argument(
        "--tenant-connect-rate",
        type=float,
        default=0.0,
        help="per-tenant connect/auth admission rate, document channels "
        "per second (token bucket; 0 = unlimited, the default). A "
        "tenant over quota is refused without touching other tenants' "
        "buckets",
    )
    parser.add_argument(
        "--tenant-connect-burst",
        type=float,
        default=8.0,
        help="per-tenant connect bucket burst capacity (default 8)",
    )
    parser.add_argument(
        "--tenant-msg-rate",
        type=float,
        default=0.0,
        help="per-tenant message-ingress admission rate, frames per "
        "second (0 = unlimited, the default); over-quota frames are "
        "counted, and at RED the channel closes 1013 Try Again Later",
    )
    parser.add_argument(
        "--tenant-msg-burst",
        type=float,
        default=256.0,
        help="per-tenant message bucket burst capacity (default 256)",
    )
    # observability (docs/guides/observability.md): Prometheus /metrics,
    # end-to-end update lifecycle tracing with Perfetto export
    # (/debug/trace), on-demand device profiles (/debug/profile) and the
    # per-doc flight recorder (/debug/docs).
    parser.add_argument(
        "--metrics",
        action="store_true",
        help="serve Prometheus metrics at /metrics plus the /debug "
        "endpoints (trace export, profiler capture, per-doc flight "
        "recorder); implied by --trace",
    )
    parser.add_argument(
        "--trace",
        action="store_true",
        help="enable end-to-end update lifecycle tracing: stage spans "
        "(queue-wait/build/upload/device/readback/broadcast) share one "
        "trace id per sampled update, exported as Chrome/Perfetto JSON "
        "at /debug/trace and as hocuspocus_tpu_update_e2e_seconds{stage=} "
        "histograms on /metrics",
    )
    parser.add_argument(
        "--trace-max-spans",
        type=int,
        default=4096,
        help="span ring capacity (oldest spans drop first), default 4096",
    )
    parser.add_argument(
        "--trace-slow-ms",
        type=float,
        default=0.0,
        help="promote spans at/above this duration to structured log "
        "lines and the hocuspocus_tpu_slow_spans_total{site=} counter — "
        "survives ring wrap (0 disables, the default)",
    )
    parser.add_argument(
        "--trace-sample",
        type=int,
        default=1,
        help="trace 1 in N captured updates (default 1 = every update); "
        "raise under load so tracing stays viable at 100k docs",
    )
    parser.add_argument(
        "--profile-hz",
        type=float,
        default=99.0,
        help="sampling rate of the always-on host CPU profiler "
        "(/debug/profile/cpu collapsed stacks, per-frame cost "
        "attribution context for /debug/costs); default 99 Hz, "
        "measured overhead <1%% — 0 disables the sampler",
    )
    # SLO engine (docs/guides/observability.md): multi-window burn
    # rates over the e2e-latency and wire-error-rate objectives, served
    # at /debug/slo and folded into /healthz
    parser.add_argument(
        "--slo-e2e-ms",
        type=float,
        default=50.0,
        help="e2e latency objective: 99%% of traced updates must "
        "complete socket->broadcast within this many ms (default 50, "
        "the BASELINE p99 budget)",
    )
    parser.add_argument(
        "--slo-error-rate",
        type=float,
        default=0.001,
        help="error budget for the wire error-rate objective: the "
        "allowed fraction of inbound messages that may fail (default "
        "0.001 = 99.9%% succeed)",
    )
    parser.add_argument(
        "--slo-fleet-e2e-ms",
        type=float,
        default=250.0,
        help="fleet cross-tier latency objective: 99%% of traced "
        "edge->cell->edge updates must complete within this many ms "
        "(default 250; fed by the hocuspocus_fleet_e2e_seconds "
        "histogram — docs/guides/observability.md fleet view)",
    )
    return parser


# defaults of the flags that tune the lane and the governor: the port
# keeps them as constants until Queue A item 7b (tpu/scheduler.py)
_LANE_DEFAULTS = {
    "tpu_drain_watermark": 256,
    "tpu_flush_stretch": 4.0,
    "tpu_lane_promote_ms": 250.0,
}


def unported_branch(args: argparse.Namespace) -> "str | None":
    """Why this command line asks for something the port does not have
    yet, naming its ROADMAP.md Queue A item, or None."""
    if args.tpu_shards > 1:
        return (
            "--tpu-shards > 1 (a sharded plane) is not ported yet: ROADMAP.md, "
            "Queue A item 7b"
        )
    if args.tpu_scheduler == "off" or any(
        getattr(args, name) != value for name, value in _LANE_DEFAULTS.items()
    ):
        return (
            "--tpu-scheduler off and the lane and governor tuning flags "
            "(--tpu-drain-watermark, --tpu-flush-stretch, --tpu-lane-promote-ms) "
            "are not ported yet: ROADMAP.md, Queue A item 7b"
        )
    return None


async def run(args: argparse.Namespace) -> None:
    if (args.tpu_merge or args.tpu_serve) and args.tpu_devices != 1 and args.tpu_shards > 1:
        print(
            "--tpu-devices and --tpu-shards are mutually exclusive "
            "(per-device cells subsume doc-sharding across devices)",
            file=sys.stderr,
        )
        sys.exit(2)
    unported = unported_branch(args)
    if unported is not None:
        raise NotImplementedError(unported)
    from .extensions import Logger, SQLite, S3, Webhook
    from .server import Configuration, Server

    extensions: list = [Logger()]
    if args.trace:
        from .observability import enable_tracing

        tracer = enable_tracing(max_spans=args.trace_max_spans)
        tracer.slow_ms = args.trace_slow_ms if args.trace_slow_ms > 0 else None
        tracer.sample = max(args.trace_sample, 1)
    if args.metrics or args.trace:
        # /metrics + /debug/{trace,profile,docs,slo}: tracing without
        # the exporter would be write-only, so --trace implies it
        from .observability import Metrics, get_profiler

        # sampler rate must land before Metrics.on_configure calls
        # ensure_started(); 0 keeps the profiler thread off entirely
        get_profiler().configure(hz=args.profile_hz)
        extensions.append(
            Metrics(
                slo_e2e_p99_ms=args.slo_e2e_ms,
                slo_error_rate=args.slo_error_rate,
                slo_fleet_e2e_ms=args.slo_fleet_e2e_ms,
            )
        )
    if args.overload == "on":
        # the process-global degradation ladder + tenant admission
        # (docs/guides/overload.md); priority 990 so it configures
        # right after Metrics lights the wire collector
        from .server.overload import OverloadExtension

        extensions.append(
            OverloadExtension(
                hold_s=args.overload_hold_secs,
                retry_after_s=args.overload_retry_after,
                connect_rate=args.tenant_connect_rate,
                connect_burst=args.tenant_connect_burst,
                message_rate=args.tenant_msg_rate,
                message_burst=args.tenant_msg_burst,
            )
        )
    if args.wal_dir:
        from .storage import Durability

        extensions.append(Durability(wal_dir=args.wal_dir, fsync=args.wal_fsync))
    if args.sqlite is not None:
        extensions.append(SQLite(database=args.sqlite))
    if args.s3:
        if not args.s3_bucket:
            print("--s3 requires --s3-bucket", file=sys.stderr)
            sys.exit(2)
        extensions.append(
            S3(
                bucket=args.s3_bucket,
                region=args.s3_region,
                prefix=args.s3_prefix,
                endpoint=args.s3_endpoint,
            )
        )
    if args.webhook:
        extensions.append(Webhook(url=args.webhook))
    if args.role == "cell":
        from .edge import CellIngressExtension

        extensions.append(
            CellIngressExtension(
                cell_id=args.cell_id or f"cell-{args.port}",
                host_id=args.host_id,
                host=args.relay_redis_host,
                port=args.relay_redis_port,
                prefix=args.relay_prefix,
            )
        )
    if args.tpu_merge or args.tpu_serve:
        # The supervised extension defers the plane's construction and
        # the kernels' builds to a deadline-bounded worker thread; on the
        # card an error there stops serving (tpu/supervisor.py). Without
        # CUDA, --tpu-device cuda raises here, before the server starts.
        from .tpu import SupervisedTpuMergeExtension

        cell_kwargs = (
            {
                "devices": args.tpu_devices,
                "rebalance_interval_s": args.tpu_rebalance_interval,
                "rebalance_ratio": args.tpu_rebalance_ratio,
                "migrate_batch": args.tpu_migrate_batch,
            }
            if args.tpu_devices != 1
            else {}
        )
        extensions.append(
            SupervisedTpuMergeExtension(
                **cell_kwargs,
                init_timeout=args.tpu_init_timeout,
                watchdog_interval=args.tpu_watchdog_interval,
                breaker_threshold=args.tpu_breaker_threshold,
                num_docs=args.tpu_docs,
                capacity=args.tpu_capacity,
                serve=args.tpu_serve,
                flush_interval_ms=args.tpu_flush_interval,
                broadcast_interval_ms=args.tpu_broadcast_interval,
                arena=args.tpu_arena,
                evict_idle_secs=args.tpu_evict_idle_secs,
                hydrate_batch=args.tpu_hydrate_batch,
                compact_threshold=args.tpu_compact_threshold,
                device=args.tpu_device,
            )
        )
    if args.fleet_autoscale:
        if args.tpu_devices == 1 or not (args.tpu_merge or args.tpu_serve):
            print(
                "--fleet-autoscale requires the multi-device cell plane "
                "(--tpu-serve with --tpu-devices != 1)",
                file=sys.stderr,
            )
            sys.exit(2)
        from .fleet import FleetControllerExtension

        extensions.append(
            FleetControllerExtension(
                interval_s=args.fleet_interval,
                warm_spares=args.fleet_warm_spares,
                min_cells=args.fleet_min_cells,
                up_threshold=args.fleet_up,
                down_threshold=args.fleet_down,
                hold_ticks=args.fleet_hold_ticks,
                work_target=args.fleet_work_target,
            )
        )

    configuration = Configuration(
        extensions=extensions,
        quiet=False,
        store_retries=max(args.store_retries, 0),
        drain_timeout_secs=args.drain_timeout_secs,
        # the drain/RED/edge 503 paths share one Retry-After knob even
        # with the overload controller off (three-way wire parity)
        retry_after_s=args.overload_retry_after,
    )
    if args.role == "edge":
        # the stateless front door: no documents, no merge plane — just
        # door auth/admission and the relay fabric. Doc-serving flags
        # (--sqlite/--wal-dir/--tpu-*) are inert here by construction.
        from .edge import EdgeGatewayExtension, EdgeServer

        extensions.append(
            EdgeGatewayExtension(
                edge_id=args.edge_id,
                host_id=args.host_id,
                host=args.relay_redis_host,
                port=args.relay_redis_port,
                prefix=args.relay_prefix,
                relay_queue_limit=args.relay_queue_limit,
            )
        )
        server = EdgeServer(configuration)
    else:
        server = Server(configuration)
    await server.listen(port=args.port, host=args.host)

    stop = asyncio.Event()
    drain_requested = False
    loop = asyncio.get_running_loop()

    def request_stop(graceful: bool) -> None:
        nonlocal drain_requested
        drain_requested = drain_requested or graceful
        stop.set()

    for sig, graceful in ((signal.SIGINT, False), (signal.SIGTERM, True)):
        try:
            loop.add_signal_handler(sig, request_stop, graceful)
        except NotImplementedError:
            pass
    await stop.wait()
    if drain_requested:
        # SIGTERM = orchestrated shutdown: drain first (flush WAL, store
        # dirty docs under the deadline, 1012 the clients), then tear down
        await server.drain(args.drain_timeout_secs)
    await server.destroy()


def main(argv: "list[str] | None" = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = build_parser().parse_args(argv)
    try:
        asyncio.run(run(args))
    except KeyboardInterrupt:
        pass
    except NotImplementedError as error:
        print(f"hocuspocus-tpu-torch: {error}", file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
