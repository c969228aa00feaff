"""Socket-free at-scale load harness for the served merge plane.

The reference's scale story is doc-sharding across instances
(`docs/guides/scalability.md:7-14`), but OS sockets cap any in-process
measurement near 4k docs (fd limits). This harness drives a
config4-shaped population — live served docs with writers, sampled
readers, steady background load, and optional cross-instance Redis
fan-out — through REAL server objects over `InProcessProviderSocket`.

Everything on the path is production code: providers run the full
auth/SyncStep1/2/awareness pipeline, the server runs the full hook
chain, and docs are served by one `TpuMergeExtension` plane per
instance, on the card unless `device="cpu"` is given. Only the network
framing (websocket upgrade + TCP) is absent.

With `edges > 0` the harness boots the split front door instead:
`cells` merge cells (each a server with `CellIngressExtension` and its
plane) and `edges` stateless `EdgeServer`s over one MiniRedis relay bus.

With `devices > 1` each instance is served by per-device merge cells
(`MultiDeviceMergeExtension`, tpu/cells.py) instead of one plane;
with `autoscale=` a `FleetControllerExtension` (fleet/controller.py)
beside each such plane parks and activates its cells.

Not ported yet, and raising NotImplementedError at construction:
sharded planes (`shards > 1`; ROADMAP.md, Queue A item 7b).
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Any, Optional

import numpy as np

from ..aio import await_synced
from ..provider import HocuspocusProvider
from ..provider.inprocess import InProcessProviderSocket
from ..server import Configuration
from ..tpu import TpuMergeExtension


def unported_topology(shards: int = 1) -> "Optional[str]":
    """Why a population cannot run on the port yet, or None when it can."""
    if shards > 1:
        return "sharded planes (shards > 1) are not ported yet: ROADMAP.md, Queue A item 7b"
    return None


class ServedLoadHarness:
    """One measured run of the served-plane topology.

    Parameters:
    - num_docs: live documents (each gets a writer provider).
    - instances: server instances; >1 wires them through Redis
      (mini_redis unless REDIS_HOST targets a real one) and places the
      sampled readers on the SECOND instance so the timed path crosses
      the fan-out, exactly like benchmarks/config4.
    - sampled: docs that get a reader and are latency-timed.
    - edges / cells: edges > 0 boots `edges` stateless EdgeServers and
      `cells` merge cells over one MiniRedis relay bus (the readers on
      edge 1, so the timed path crosses edge -> cell -> edge).
    - shard_rows / capacity / flush_interval_ms: plane layout per
      instance, edge-tier cell or device cell (rows must exceed the
      docs a plane holds). `shards` must be 1.
    - devices / multi_device: devices > 1 serves each instance from that
      many per-device merge cells (tpu/cells.py); multi_device carries
      the rebalancer's tuning (interval, ratio, batch) to the extension.
    - autoscale: FleetControllerExtension tuning; with devices > 1 each
      instance gets a fleet controller over its cells
      (`fleet_controllers`).
    - device: where each instance's plane runs ("cuda" by default;
      "cpu" only when asked).
    - docs_per_socket: provider multiplexing width per in-process socket.
    - seed: RNG seed behind every random choice the harness makes
      (timed-edit sizes, background payload widths); recorded in the
      result dict so any run is reproducible from its artifact.
    """

    def __init__(
        self,
        num_docs: int = 1024,
        instances: int = 1,
        edges: int = 0,
        cells: int = 0,
        sampled: int = 32,
        edits: int = 200,
        shards: int = 1,
        devices: int = 0,
        multi_device: "Optional[dict]" = None,
        shard_rows: Optional[int] = None,
        capacity: int = 1024,
        flush_interval_ms: float = 2.0,
        docs_per_socket: int = 512,
        sync_timeout: float = 600.0,
        background_fraction: int = 16,
        with_metrics: bool = False,
        seed: int = 0,
        overload: "Optional[dict]" = None,
        anti_entropy_s: "Optional[float]" = None,
        replica_watermark: "Optional[int]" = None,
        autoscale: "Optional[dict]" = None,
        device: str = "cuda",
        progress=None,
    ) -> None:
        unported = unported_topology(shards)
        if unported is not None:
            raise NotImplementedError(unported)
        if str(device).startswith("cuda"):
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ServedLoadHarness needs a CUDA device; pass device='cpu' "
                    "to run the planes on the CPU"
                )
        self.num_docs = num_docs
        self.instances = instances
        # edge topology: edges > 0 boots `edges` stateless EdgeServers +
        # `cells` merge-cell servers over one mini_redis relay bus;
        # self.servers then holds the EDGE servers (providers terminate
        # there) and self.extensions the cells' plane extensions
        self.edges = int(edges)
        self.cells = int(cells) if edges else 0
        self.sampled = min(sampled, num_docs)
        self.edits = edits
        self.shards = 1
        # per-device merge cells: devices > 1 serves each instance from
        # that many cells (tpu/cells.py); multi_device carries the
        # rebalancer's tuning (interval, ratio, batch) to the extension
        self.devices = int(devices)
        self.multi_device = dict(multi_device or {})
        partitions = self.devices if self.devices > 1 else 1
        self.shard_rows = shard_rows or max(int(num_docs / partitions * 1.25), 64)
        self.capacity = capacity
        self.flush_interval_ms = flush_interval_ms
        self.docs_per_socket = docs_per_socket
        self.sync_timeout = sync_timeout
        self.background_fraction = background_fraction
        self.device = device
        # hot-doc replication knob: None keeps the gateway default;
        # mega-audience scenarios set a CI-scale watermark so a small
        # join wave grows follower cells
        self.replica_watermark = replica_watermark
        # autoscale: FleetControllerExtension tuning per plane-holding
        # instance (docs/guides/elastic-fleet.md) — only meaningful with
        # devices > 1, where the controller can park/activate cells
        self.autoscale = autoscale
        self.fleet_controllers: list[Any] = []
        # with_metrics: add a Metrics extension per instance (enables
        # the wire telemetry singleton and binds each plane's trace
        # book to the e2e histogram)
        self.with_metrics = with_metrics
        self.metrics: list[Any] = []
        # overload: per-instance OverloadExtension options — the
        # scenario runner's seam for driving the degradation ladder
        # (docs/guides/overload.md). anti_entropy_s tightens the Redis
        # extension's anti-entropy cadence so partition-heal scenarios
        # reconverge inside CI-scale phases.
        self.overload = overload
        self.anti_entropy_s = anti_entropy_s
        # seed: every random choice the harness makes (timed edit sizes,
        # background payload widths) draws from a seeded generator, and
        # the seed is stamped into the result dict — any bench or
        # scenario run is reproducible from its artifact alone. The
        # timed path and the concurrent background task get INDEPENDENT
        # streams: sharing one would interleave draws by event-loop
        # timing, making the recorded seed non-reproducing.
        self.seed = int(seed)
        self.rng = np.random.default_rng([self.seed, 0])
        self._bg_rng = np.random.default_rng([self.seed, 1])
        self._progress = progress or (lambda msg: None)

        self.servers: list[Any] = []  # server.Server (aiohttp, imported when they start)
        self.extensions: list[Any] = []
        self.cell_servers: list[Any] = []
        self.cell_ingresses: list[Any] = []
        self.edge_gateways: list[Any] = []
        self.sockets: list[InProcessProviderSocket] = []
        self.writers: list[HocuspocusProvider] = []
        self.readers: list[HocuspocusProvider] = []
        self._mini_redis = None
        self._bg_len: list[int] = []

    @property
    def mini_redis(self):
        """The in-process MiniRedis backing a multi-instance run (None
        single-instance or against a real REDIS_HOST) — the scenario
        runner's replication-lag injection point."""
        return self._mini_redis

    # -- topology ----------------------------------------------------------

    def _plane_extension(self) -> "tuple[Any, list]":
        """One serve-mode plane extension + its planes, per the layout."""
        if self.devices > 1:
            from ..tpu import MultiDeviceMergeExtension

            ext = MultiDeviceMergeExtension(
                devices=self.devices,
                num_docs=self.shard_rows,
                capacity=self.capacity,
                flush_interval_ms=self.flush_interval_ms,
                serve=True,
                device=self.device,
                **self.multi_device,
            )
            return ext, [cell.plane for cell in ext.cells]
        ext = TpuMergeExtension(
            num_docs=self.shard_rows,
            capacity=self.capacity,
            flush_interval_ms=self.flush_interval_ms,
            serve=True,
            device=self.device,
        )
        return ext, [ext.plane]

    async def _start_edge_topology(self) -> None:
        """The split front door: `cells` merge cells + `edges` stateless
        edge servers over one mini_redis relay bus. self.servers = the
        EDGE servers (writers land on edge 0, readers on edge 1 — the
        timed path crosses edge->cell->edge), self.extensions = the
        cells' plane extensions (merge capacity)."""
        from ..edge import CellIngressExtension, EdgeGatewayExtension, EdgeServer
        from ..net.mini_redis import MiniRedis
        from ..server import Server

        self._mini_redis = await MiniRedis().start()
        host, port = "127.0.0.1", self._mini_redis.port
        for i in range(max(self.cells, 1)):
            plane_ext, planes = self._plane_extension()
            ingress = CellIngressExtension(
                cell_id=self.cell_identifier(i),
                host=host,
                port=port,
                announce_interval_s=0.25,
            )
            extensions: list[Any] = [ingress]
            if self.overload is not None:
                from ..server.overload import OverloadExtension

                extensions.append(OverloadExtension(**self.overload))
            if self.with_metrics:
                from ..observability import Metrics

                metrics = Metrics()
                self.metrics.append(metrics)
                extensions.append(metrics)
            extensions.append(plane_ext)
            if self.autoscale is not None and self.devices > 1:
                from ..fleet import FleetControllerExtension

                fleet_ext = FleetControllerExtension(**self.autoscale)
                self.fleet_controllers.append(fleet_ext)
                extensions.append(fleet_ext)
            server = Server(Configuration(quiet=True, extensions=extensions))
            await server.listen(port=0)
            for plane in planes:
                plane.warmup_compiles()
            self.cell_servers.append(server)
            self.cell_ingresses.append(ingress)
            self.extensions.append(plane_ext)
        for i in range(self.edges):
            gateway_options: "dict[str, Any]" = {
                "edge_id": f"loadgen-edge-{i}",
                "host": host,
                "port": port,
            }
            if self.replica_watermark is not None:
                gateway_options["replica_watermark"] = int(self.replica_watermark)
            gateway_ext = EdgeGatewayExtension(**gateway_options)
            server = EdgeServer(
                Configuration(quiet=True, extensions=[gateway_ext])
            )
            await server.listen(port=0)
            self.servers.append(server)
            self.edge_gateways.append(gateway_ext.gateway)
        # population sync storms must not race discovery: every edge
        # sees every cell before providers connect
        deadline = time.perf_counter() + 10.0
        want = len(self.cell_servers)
        for gateway in self.edge_gateways:
            while len(gateway.router.healthy_cells()) < want:
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"edge {gateway.edge_id} saw "
                        f"{gateway.router.healthy_cells()} of {want} cells"
                    )
                await asyncio.sleep(0.02)

    async def drain_cell(self, index: int) -> dict:
        """Gracefully drain merge cell `index` (the scenario `drain`
        op): the cell announces departure, edges remap its docs and
        re-establish sessions on the survivors — no client-visible
        disconnect beyond the resync exchange."""
        server = self.cell_servers[index]
        return await server.drain(timeout_secs=10.0)

    def cell_identifier(self, index: int) -> str:
        return f"loadgen-cell-{index}"

    def plane_health(self) -> "list[dict]":
        """Plane counters per merge-capacity holder (instances in the
        replicated topology, cells in the edge topology)."""
        return [dict(self._counters(i)) for i in range(len(self.extensions))]

    async def _start_servers(self) -> None:
        from ..server import Server

        if self.edges > 0:
            await self._start_edge_topology()
            return
        redis_cfg = None
        if self.instances > 1:
            host = os.environ.get("REDIS_HOST")
            if host:
                redis_cfg = (host, int(os.environ.get("REDIS_PORT", 6379)))
            else:
                from ..net.mini_redis import MiniRedis

                self._mini_redis = await MiniRedis().start()
                redis_cfg = ("127.0.0.1", self._mini_redis.port)
        for i in range(self.instances):
            ext, planes = self._plane_extension()
            extensions: list[Any] = []
            if redis_cfg is not None:
                from ..extensions import Redis

                redis_ext = Redis(
                    host=redis_cfg[0],
                    port=redis_cfg[1],
                    identifier=self.redis_identifier(i),
                    disconnect_delay=100,
                )
                if self.anti_entropy_s is not None:
                    redis_ext.plane_anti_entropy_seconds = float(
                        self.anti_entropy_s
                    )
                extensions.append(redis_ext)
            if self.overload is not None:
                from ..server.overload import OverloadExtension

                extensions.append(OverloadExtension(**self.overload))
            if self.with_metrics:
                from ..observability import Metrics

                metrics = Metrics()
                self.metrics.append(metrics)
                extensions.append(metrics)
            extensions.append(ext)
            if self.autoscale is not None and self.devices > 1:
                from ..fleet import FleetControllerExtension

                fleet_ext = FleetControllerExtension(**self.autoscale)
                self.fleet_controllers.append(fleet_ext)
                extensions.append(fleet_ext)
            server = Server(Configuration(quiet=True, extensions=extensions))
            await server.listen(port=0)
            for plane in planes:
                # per-device cells of one geometry on one device warm their
                # shapes once (the process-wide warm registry)
                plane.warmup_compiles(shared=self.devices > 1)
            self.servers.append(server)
            self.extensions.append(ext)

    def redis_identifier(self, instance: int) -> str:
        """The identifier instance `instance`'s Redis extension frames
        its publishes with — the mini_redis partition-injection key."""
        return f"loadgen-{instance}"

    def _counters(self, instance: int = 0) -> dict:
        ext = self.extensions[instance]
        return ext.counters if hasattr(ext, "counters") else ext.plane.counters

    async def _connect_writers(self) -> None:
        """Writers for every doc on instance 0, multiplexed over
        in-process sockets, synced chunk by chunk (one chunk's sync
        storm completes before the next connects — the same pacing a
        production rollout's connection ramp gives the server)."""
        server = self.servers[0]
        t0 = time.perf_counter()
        for base in range(0, self.num_docs, self.docs_per_socket):
            socket = InProcessProviderSocket(server)
            self.sockets.append(socket)
            chunk = []
            for d in range(base, min(base + self.docs_per_socket, self.num_docs)):
                p = HocuspocusProvider(name=f"load-{d}", websocket_provider=socket)
                p.attach()
                chunk.append(p)
            self.writers.extend(chunk)
            await await_synced(chunk, self.sync_timeout, f"writer chunk @{base}")
            if base % (self.docs_per_socket * 8) == 0:
                rate = len(self.writers) / (time.perf_counter() - t0)
                self._progress(
                    f"writers {len(self.writers)}/{self.num_docs} ({rate:.0f}/s)"
                )
        self._bg_len = [0] * self.num_docs

    async def _connect_readers(self) -> None:
        # second instance (replicated) or second edge (edge topology):
        # the timed path crosses the fan-out either way
        server = self.servers[1 if len(self.servers) > 1 else 0]
        socket = InProcessProviderSocket(server)
        self.sockets.append(socket)
        for d in range(self.sampled):
            p = HocuspocusProvider(name=f"load-{d}", websocket_provider=socket)
            p.attach()
            self.readers.append(p)
        await await_synced(self.readers, self.sync_timeout, "readers")

    # -- measurement -------------------------------------------------------

    async def timed_edit(
        self,
        doc: int,
        size: int,
        timeout_s: float = 30.0,
        raise_on_timeout: bool = True,
    ) -> "Optional[float]":
        """Writer inserts `size` units into sampled doc `doc`; returns
        seconds until the reader's doc shows the grown text (None on
        timeout when not raising). Event-driven: woken by reader doc
        updates. Shared by the bench edit loop and the scenario runner —
        the straggler-safe measurement logic must exist exactly once.

        The target is the WRITER's post-insert length: after a swallowed
        straggler, a reader-relative target (+size over current reader
        length) would be satisfied by the straggler's late bytes and
        record a bogus ~0 latency; the writer high-water mark requires
        THIS edit to have landed."""
        wtext = self.writers[doc].document.get_text("body")
        rdoc = self.readers[doc].document
        rtext = rdoc.get_text("body")
        expected = len(wtext) + size
        wake = asyncio.Event()
        handler = lambda *args: wake.set()  # noqa: E731
        rdoc.on("update", handler)
        try:
            t0 = time.perf_counter()
            wtext.insert(len(wtext), "x" * size)
            while len(rtext) < expected:
                if time.perf_counter() - t0 > timeout_s:
                    if raise_on_timeout:
                        raise TimeoutError(
                            f"edit on doc {doc} never observed by reader"
                        )
                    return None
                wake.clear()
                try:
                    await asyncio.wait_for(wake.wait(), timeout=0.25)
                except asyncio.TimeoutError:
                    pass
            return time.perf_counter() - t0
        finally:
            rdoc.off("update", handler)

    async def _one_edit(self, i: int) -> float:
        """One bench-loop edit: rng-sized insert on the i-th sampled doc."""
        return await self.timed_edit(
            i % self.sampled, int(self.rng.integers(8, 25))
        )

    async def _background_load(self, stop: asyncio.Event) -> None:
        """Steady inserts across ~1/background_fraction of the
        non-sampled population per tick, so flushes run at real batch
        width during the timed samples."""
        tick = 0
        n = self.background_fraction
        while not stop.is_set():
            for d in range(self.sampled + tick % n, self.num_docs, n):
                width = int(self._bg_rng.integers(4, 13))
                self.writers[d].document.get_text("body").insert(
                    self._bg_len[d], "y" * width
                )
                self._bg_len[d] += width
                await asyncio.sleep(0)
                if stop.is_set():
                    return
            tick += 1
            await asyncio.sleep(0.01)

    async def run(self, budget_s: float = 600.0) -> dict:
        """Build the topology, measure, tear down; returns the metrics
        dict (config4-shaped: served p99 + plane health)."""
        t_start = time.perf_counter()
        try:
            self._progress(
                f"starting {self.instances} instance(s), "
                f"{self.shards}x{self.shard_rows}x{self.capacity} planes"
            )
            await self._start_servers()
            await self._connect_writers()
            await self._connect_readers()
            self._progress("population synced; warming sampled docs")

            for i in range(self.sampled):
                await self._one_edit(i)

            stop = asyncio.Event()
            load_task = asyncio.ensure_future(self._background_load(stop))
            lat: list[float] = []
            stragglers = 0
            try:
                deadline = t_start + budget_s * 0.8
                for i in range(self.edits):
                    try:
                        lat.append(await self._one_edit(i))
                    except TimeoutError:
                        # one straggler must not discard the whole run's
                        # samples (a 100k-doc pass costs ~20 min); give
                        # up only when stragglers dominate
                        stragglers += 1
                        if stragglers > 3 or not lat:
                            raise
                    if time.perf_counter() > deadline and len(lat) >= 50:
                        break
            finally:
                stop.set()
                await load_task

            counters = [dict(self._counters(i)) for i in range(self.instances)]
            if counters[0]["plane_broadcasts"] <= 0:
                raise RuntimeError(f"plane never served: {counters[0]}")
            lat_ms = np.array(lat) * 1000
            return {
                "metric": "served_merge_to_broadcast_p99_ms",
                "value": round(float(np.percentile(lat_ms, 99)), 2),
                "unit": "ms",
                "extra": {
                    "docs": self.num_docs,
                    "seed": self.seed,
                    "instances": self.instances,
                    "cross_instance": self.instances > 1,
                    "shards": self.shards,
                    "shard_rows": self.shard_rows,
                    "capacity": self.capacity,
                    "sampled_docs": self.sampled,
                    "samples": len(lat),
                    "straggler_timeouts": stragglers,
                    "p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
                    "served_docs": [
                        self.extensions[i].served_docs()
                        if hasattr(self.extensions[i], "served_docs")
                        else len(self.extensions[i]._docs)
                        for i in range(self.instances)
                    ],
                    "plane_health": counters,
                    "transport": "in-process",
                    "setup_s": round(time.perf_counter() - t_start, 1),
                },
            }
        finally:
            await self._teardown()

    async def _teardown(self) -> None:
        for p in self.writers + self.readers:
            p.destroy()
        for socket in self.sockets:
            socket.destroy()
        # let the destroy-close tasks run before the servers go away
        await asyncio.sleep(0)
        for server in self.servers:
            await server.destroy()
        for server in self.cell_servers:
            await server.destroy()
        if self._mini_redis is not None:
            await self._mini_redis.stop()


async def run_served_load(**kwargs) -> dict:
    """Convenience wrapper: build + run a ServedLoadHarness."""
    budget_s = kwargs.pop("budget_s", 600.0)
    return await ServedLoadHarness(**kwargs).run(budget_s=budget_s)
