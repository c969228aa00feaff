"""Redis fan-out between two served planes, on the CPU.

Two port `Hocuspocus` cores share one port `MiniRedis`; each runs the
port's `Redis` extension beside a serve-mode `TpuMergeExtension` (or the
supervised one) with `device="cpu"`. Clients are the port's providers on
in-process sockets. Twins of tests/extensions/test_redis.py's plane
tests, the `is_capturing` repair, and a cross-package run: the same
seeded mixed stream through the JAX package's two-instance topology and
the port's must converge every doc to the same encoded state.

The arenas are not compared flush by flush here: which instance's
window frames land first on the other follows the event loop's timing,
so two runs of one stream integrate the same ops in different batches.
Only the converged documents are held equal.
"""

import asyncio
import time

import numpy as np
import pytest

from hocuspocus_tpu_torch.aio import await_synced
from hocuspocus_tpu_torch.extensions import Redis
from hocuspocus_tpu_torch.net.mini_redis import MiniRedis
from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
from hocuspocus_tpu_torch.server.types import Payload
from hocuspocus_tpu_torch.tpu import SupervisedTpuMergeExtension, TpuMergeExtension
from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

from tests.test_torch_server import _assert, until

DEADLINE_S = 30.0


class Instance:
    """One port server core with `extensions`, its providers on in-process
    sockets; the listen hook fired (the supervisor and warm grid start
    there)."""

    def __init__(self, *extensions) -> None:
        self.core = Hocuspocus(Configuration(quiet=True, extensions=list(extensions)))
        self.providers = []

    async def start(self) -> "Instance":
        await self.core.ensure_configured()
        await self.core.hooks("on_listen", Payload(instance=self.core, port=None))
        return self

    def provider(self, name: str) -> HocuspocusProvider:
        provider = HocuspocusProvider(
            name=name, websocket_provider=InProcessProviderSocket(self.core)
        )
        provider.attach()
        self.providers.append(provider)
        return provider

    async def stop(self) -> None:
        for provider in self.providers:
            provider.destroy()
            provider.websocket_provider.destroy()
        await self.core.hooks("on_destroy", Payload(instance=self.core))


def _plane_ext(kind: str, arena: str = "unit", **kwargs):
    kwargs = {"num_docs": 16, "capacity": 512, "flush_interval_ms": 1, **kwargs}
    if kind == "supervised":
        return SupervisedTpuMergeExtension(
            serve=True, device="cpu", arena=arena, watchdog_interval=0.5, **kwargs
        )
    return TpuMergeExtension(serve=True, device="cpu", arena=arena, **kwargs)


def _runtime(ext):
    """The TpuMergeExtension that serves (the supervised one's runtime)."""
    return ext.runtime if isinstance(ext, SupervisedTpuMergeExtension) else ext


async def _ready(ext) -> None:
    if isinstance(ext, SupervisedTpuMergeExtension):
        await until(lambda: _assert(ext.supervisor.state == "ready", ext.supervisor.snapshot()))


# -- step 0: the is_capturing repair ------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "supervised"])
async def test_lane_demote_window_propagates_per_op_across_instances(kind):
    """A first Map op demotes a lane doc off the text lane; until the
    rebuild lands the doc's updates ride the per-update CPU fan-out, so
    the extension must say it is not capturing them. Redis then
    propagates each change at once instead of at the anti-entropy rate
    (set to 60 s here, so only the per-op path can meet the deadline).
    `coalesce=False` is the per-op publish mode in which the extension's
    answer decides propagation."""
    reset_device_lane()
    redis = await MiniRedis().start()
    ext_a, ext_b = _plane_ext(kind), _plane_ext(kind)
    redis_a = Redis(port=redis.port, identifier="cap-a", disconnect_delay=100, coalesce=False)
    redis_b = Redis(port=redis.port, identifier="cap-b", disconnect_delay=100, coalesce=False)
    for ext in (redis_a, redis_b):
        ext.plane_anti_entropy_seconds = 60.0
    a = await Instance(redis_a, ext_a).start()
    b = await Instance(redis_b, ext_b).start()
    try:
        await _ready(ext_a)
        await _ready(ext_b)
        pa, pb = a.provider("cap-doc"), b.provider("cap-doc")
        await await_synced([pa, pb], timeout=DEADLINE_S)
        plane_a = _runtime(ext_a)
        await until(lambda: _assert(plane_a.is_served("cap-doc")))
        # the first change of the doc spends its anti-entropy exchange
        pa.document.get_text("t").insert(0, "lane;")
        await until(lambda: _assert(pb.document.get_text("t").to_string() == "lane;"))

        # hold the in-place rebuild until released, so the demote window
        # stays open while the edits arrive (the rebuild otherwise lands
        # within a tick and the window's length follows the loop's timing)
        gate = asyncio.Event()
        rebuild = plane_a._rebuild_lane_doc

        async def gated_rebuild(document):
            await gate.wait()
            await rebuild(document)

        plane_a._rebuild_lane_doc = gated_rebuild
        demotes = plane_a.plane.counters["docs_retired_lane_demote"]
        pa.document.get_map("meta").set("kind", "mixed")  # demotes the lane doc
        text = pa.document.get_text("t")
        for i in range(5):
            text.insert(len(text), f"op{i};")
        expected = text.to_string()
        await until(
            lambda: _assert(pb.document.get_text("t").to_string() == expected),
            timeout=10.0,
        )
        assert pb.document.get_map("meta").get("kind") == "mixed"
        assert plane_a.plane.counters["docs_retired_lane_demote"] == demotes + 1
        assert not plane_a.is_capturing("cap-doc")
        gate.set()
        # the rebuild lands: the doc rides plane windows again
        await until(lambda: _assert(plane_a.is_capturing("cap-doc")))
        doc = plane_a.plane.docs["cap-doc"]
        assert not doc.retired
        # the window's SyncStep1s were answered by the CPU document
        # (counted); after the rebuild the plane serves again
        fallbacks = plane_a.plane.counters["cpu_fallbacks"]
        text.insert(0, "after;")
        await until(
            lambda: _assert(pb.document.get_text("t").to_string() == text.to_string())
        )
        assert plane_a.plane.counters["cpu_fallbacks"] == fallbacks
        assert plane_a.plane.counters["docs_retired_unsupported"] == 0
    finally:
        await a.stop()
        await b.stop()
        await redis.stop()


# -- twins of tests/extensions/test_redis.py:182 and :228 ----------------------


@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_merge_plane_mirrors_across_instances(arena):
    """Both instances shadow the same doc on their own plane (no serve);
    an edit on A converges on B's plane through the Redis fan-out."""
    reset_device_lane()
    redis = await MiniRedis().start()
    ext_a = TpuMergeExtension(num_docs=4, capacity=512, device="cpu", arena=arena)
    ext_b = TpuMergeExtension(num_docs=4, capacity=512, device="cpu", arena=arena)
    a = await Instance(Redis(port=redis.port, identifier="tpu-a", disconnect_delay=100), ext_a).start()
    b = await Instance(Redis(port=redis.port, identifier="tpu-b", disconnect_delay=100), ext_b).start()
    try:
        pa, pb = a.provider("shared-doc"), b.provider("shared-doc")
        await await_synced([pa, pb], timeout=DEADLINE_S)
        pa.document.get_text("t").insert(0, "from instance A: hello!")
        pb.document.get_text("t").insert(0, "B says: ")

        def converged():
            ext_a.plane.flush()
            ext_b.plane.flush()
            text_a, text_b = ext_a.plane.text("shared-doc"), ext_b.plane.text("shared-doc")
            cpu = pa.document.get_text("t").to_string()
            assert text_a is not None and text_a == text_b == cpu
            assert "hello" in text_a and "B says" in text_a

        await until(converged)
    finally:
        await a.stop()
        await b.stop()
        await redis.stop()


@pytest.mark.parametrize("kind", ["plain", "supervised"])
@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_serve_mode_with_redis_fanout_production_topology(arena, kind):
    """Serve-mode planes on both instances with Redis fan-out between
    them: text from A, Map and Array from B converge while both docs
    stay plane-served; sustained traffic rides the window frames with
    only anti-entropy-level sync serves; a late joiner on B syncs from
    B's plane."""
    reset_device_lane()
    redis = await MiniRedis().start()
    ext_a, ext_b = _plane_ext(kind, arena), _plane_ext(kind, arena)
    a = await Instance(Redis(port=redis.port, identifier="serve-a", disconnect_delay=100), ext_a).start()
    b = await Instance(Redis(port=redis.port, identifier="serve-b", disconnect_delay=100), ext_b).start()
    try:
        await _ready(ext_a)
        await _ready(ext_b)
        plane_a, plane_b = _runtime(ext_a), _runtime(ext_b)
        pa, pb = a.provider("prod-doc"), b.provider("prod-doc")
        await await_synced([pa, pb], timeout=DEADLINE_S)
        pa.document.get_text("t").insert(0, "cross-instance")
        pb.document.get_map("meta").set("owner", "b")
        pb.document.get_array("tags").insert(0, [1, "two"])

        def converged():
            assert pb.document.get_text("t").to_string() == "cross-instance"
            assert pa.document.get_map("meta").get("owner") == "b"
            assert pa.document.get_array("tags").to_json() == [1, "two"]

        await until(converged)
        assert plane_a.is_served("prod-doc") and plane_b.is_served("prod-doc")
        for plane in (plane_a, plane_b):
            assert plane.plane.counters["docs_retired_unsupported"] == 0
        assert plane_a.plane.counters["plane_broadcasts"] >= 1
        # B's first local ops were Map/Array: they demoted its lane doc;
        # its broadcasts ride the plane again once the rebuild lands
        await until(lambda: _assert(plane_b.is_capturing("prod-doc")))
        pb.document.get_map("meta").set("post-rebuild", True)
        await until(lambda: _assert(plane_b.plane.counters["plane_broadcasts"] >= 1))

        serves = plane_b.plane.counters["sync_serves"]
        fallbacks = (plane_a.plane.counters["cpu_fallbacks"], plane_b.plane.counters["cpu_fallbacks"])
        text_a = pa.document.get_text("t")
        for i in range(30):
            text_a.insert(0, f"w{i};")
            await asyncio.sleep(0.01)
        await until(
            lambda: _assert(pb.document.get_text("t").to_string() == text_a.to_string())
        )
        assert plane_b.plane.counters["sync_serves"] - serves <= 10
        assert (plane_a.plane.counters["cpu_fallbacks"], plane_b.plane.counters["cpu_fallbacks"]) == fallbacks

        serves = plane_b.plane.counters["sync_serves"]
        pc = b.provider("prod-doc")
        await await_synced([pc], timeout=DEADLINE_S)
        assert pc.document.get_text("t").to_string() == text_a.to_string()
        assert pc.document.get_map("meta").get("owner") == "b"
        assert plane_b.plane.counters["sync_serves"] > serves
    finally:
        await a.stop()
        await b.stop()
        await redis.stop()


# -- the same seeded stream through the JAX topology and the port's -----------


def _cross_stream(seed: int, docs: int = 8, rounds: int = 3):
    """Per doc, 4 seeded editors (JAX package's CRDT, fixed client ids):
    2 feed instance a, 2 feed instance b. Returns [(instance, doc,
    update)] and each doc's reference (every editor's updates merged)."""
    from tests.test_torch_server_parity import _editors

    rng = np.random.default_rng(seed)
    groups = _editors(rng)[:docs]
    stream = []
    for step in range(rounds):
        for i, group in enumerate(groups):
            for j, (doc, box) in enumerate(group):
                for _ in range(int(rng.integers(1, 3))):
                    _mixed_edit(rng, doc, step)
                for update in box:
                    stream.append(("a" if j < 2 else "b", f"mix-{i}", update))
                box.clear()
    return stream


def _mixed_edit(rng, doc, step: int) -> None:
    """A third each: a Y.Text insert, a Y.Map set over 7 keys, a Y.Array
    push (BASELINE config 4's mix)."""
    kind = int(rng.integers(0, 3))
    if kind == 0:
        text = doc.get_text("t")
        text.insert(int(rng.integers(0, len(text) + 1)), f"w{step}")
    elif kind == 1:
        doc.get_map("m").set(f"k{int(rng.integers(0, 7))}", int(rng.integers(0, 1000)))
    else:
        doc.get_array("a").push([int(rng.integers(0, 1000))])


async def _run_topology(package: str, stream, arena: str) -> dict:
    if package == "jax":
        from hocuspocus_tpu.crdt import apply_update, encode_state_as_update
        from hocuspocus_tpu.extensions import Redis as RedisExt
        from hocuspocus_tpu.net.mini_redis import MiniRedis as Mini
        from hocuspocus_tpu.server import Configuration as Config
        from hocuspocus_tpu.server import Hocuspocus as Core
        from hocuspocus_tpu.server.types import Payload as payload_cls
        from hocuspocus_tpu.tpu import TpuMergeExtension as Ext

        make_ext = lambda: Ext(
            num_docs=16, capacity=512, flush_interval_ms=1, serve=True, arena=arena, native_lane=False
        )
    else:
        from hocuspocus_tpu_torch.crdt import apply_update, encode_state_as_update
        from hocuspocus_tpu_torch.extensions import Redis as RedisExt
        from hocuspocus_tpu_torch.net.mini_redis import MiniRedis as Mini
        from hocuspocus_tpu_torch.server import Configuration as Config
        from hocuspocus_tpu_torch.server import Hocuspocus as Core
        from hocuspocus_tpu_torch.server.types import Payload as payload_cls
        from hocuspocus_tpu_torch.tpu import TpuMergeExtension as Ext

        make_ext = lambda: Ext(
            num_docs=16,
            capacity=512,
            flush_interval_ms=1,
            serve=True,
            arena=arena,
            native_lane=False,
            device="cpu",
        )
    reset_device_lane()
    redis = await Mini().start()
    exts = {"a": make_ext(), "b": make_ext()}
    cores = {
        side: Core(Config(quiet=True, extensions=[RedisExt(port=redis.port, identifier=f"x-{side}", disconnect_delay=100), ext]))
        for side, ext in exts.items()
    }
    names = sorted({name for _, name, _ in stream})
    directs = {}
    try:
        for side, core in cores.items():
            await core.ensure_configured()
            for name in names:
                directs[side, name] = await core.open_direct_connection(name)
        for side, name, update in stream:
            # as a provider's update message lands (a direct connection's
            # transact would also run the store chain after every update)
            apply_update(cores[side].documents[name], update, "editor")
            await asyncio.sleep(0)
        reference = {}
        for _side, name, update in stream:
            reference.setdefault(name, []).append(update)

        def svs(side):
            return {n: dict(cores[side].documents[n].store.get_state_vector()) for n in names}

        from hocuspocus_tpu_torch.crdt import Doc as PortDoc, apply_update as port_apply

        want = {}
        for name, updates in reference.items():
            doc = PortDoc()
            for u in updates:
                port_apply(doc, u)
            want[name] = dict(doc.store.get_state_vector())
        started = time.monotonic()
        deadline = started + DEADLINE_S
        while not (svs("a") == want and svs("b") == want):
            assert time.monotonic() < deadline, "the instances never converged"
            await asyncio.sleep(0.02)
        out = {}
        for name in names:
            docs = [cores[side].documents[name] for side in ("a", "b")]
            out[name] = [
                (d.get_text("t").to_string(), d.get_map("m").to_json(), d.get_array("a").to_json())
                for d in docs
            ]
            assert out[name][0] == out[name][1]
            encoded = [encode_state_as_update(d) for d in docs]
            assert encoded[0] == encoded[1]
            out[name].append(encoded[0])
        counters = [
            (ext.plane.counters["cpu_fallbacks"], ext.plane.counters["docs_retired_unsupported"])
            for ext in exts.values()
        ]
        served = all(name in ext._docs for ext in exts.values() for name in names)
        converge_s = time.monotonic() - started
        return {"docs": out, "counters": counters, "served": served, "converge_s": converge_s}
    finally:
        for core in cores.values():
            await core.hooks("on_destroy", payload_cls(instance=core))
        await redis.stop()


@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_same_stream_converges_equally_through_both_packages(arena):
    """Mixed docs from their first op, on the Python host path: the text
    lane would demote each doc at its first Map op, and a peer's sync
    answered inside that window comes from the CPU document, counted as
    a fallback whose count follows timing."""
    stream = _cross_stream(13)
    results = {package: await _run_topology(package, stream, arena) for package in ("jax", "port")}
    assert results["port"]["docs"] == results["jax"]["docs"]
    assert results["port"]["served"] and results["jax"]["served"]
    assert results["port"]["counters"] == [(0, 0), (0, 0)]


# -- the subscriber queue's bound (mini-redis) against one burst ------------------


async def _burst_through_redis(package: str, num_docs: int, chunk: int) -> dict:
    """`num_docs` docs with a writer each on instance `a` (no plane), and
    `b` subscribed to every doc's channel through a reader of its own;
    then one edit a writer, `chunk` of them before the loop may run the
    subscribers' pumps, each chunk observed on `b` before the next (when
    there is more than one). Returns mini-redis's counters, the deepest
    any subscriber queue got, and how many of `b`'s readers hold their
    writer's edit."""
    if package == "jax":
        from hocuspocus_tpu.extensions import Redis as PkgRedis
        from hocuspocus_tpu.net.mini_redis import MiniRedis as PkgMiniRedis
        from hocuspocus_tpu.provider import HocuspocusProvider as PkgProvider
        from hocuspocus_tpu.provider import InProcessProviderSocket as PkgSocket
        from hocuspocus_tpu.server import Configuration as PkgConfiguration
        from hocuspocus_tpu.server import Hocuspocus as PkgHocuspocus
        from hocuspocus_tpu.server.types import Payload as PkgPayload
    else:
        PkgRedis, PkgMiniRedis, PkgProvider, PkgSocket = (
            Redis, MiniRedis, HocuspocusProvider, InProcessProviderSocket
        )
        PkgConfiguration, PkgHocuspocus, PkgPayload = Configuration, Hocuspocus, Payload
    redis = await PkgMiniRedis().start()
    peak = {"depth": 0}
    enqueue = redis._enqueue

    def measured(writer, message):
        queue = redis._sub_queues.get(writer)
        if queue is not None:
            peak["depth"] = max(peak["depth"], queue.qsize() + 1)
        return enqueue(writer, message)

    redis._enqueue = measured
    cores = {}
    for side in ("a", "b"):
        core = PkgHocuspocus(PkgConfiguration(
            quiet=True, extensions=[PkgRedis(port=redis.port, identifier=f"burst-{side}")]
        ))
        await core.ensure_configured()
        await core.hooks("on_listen", PkgPayload(instance=core, port=None))
        cores[side] = core
    providers = {side: [] for side in cores}
    try:
        for side in ("a", "b"):
            for d in range(num_docs):
                provider = PkgProvider(name=f"burst-{d}", websocket_provider=PkgSocket(cores[side]))
                provider.attach()
                providers[side].append(provider)
            await until(lambda s=side: _assert(all(p.synced for p in providers[s])))
        before = dict(redis.counters)

        def observed(docs) -> int:
            return sum(
                providers["b"][d].document.get_text("t").to_string() == f"w{d};" for d in docs
            )

        for base in range(0, num_docs, chunk):
            docs = range(base, min(base + chunk, num_docs))
            for d in docs:
                providers["a"][d].document.get_text("t").insert(0, f"w{d};")
            if chunk < num_docs:
                # paced: the next chunk waits until this one was observed
                deadline = time.monotonic() + DEADLINE_S
                while observed(docs) < len(docs) and time.monotonic() < deadline:
                    await asyncio.sleep(0.01)
        # the burst ends in a drop or with every edit observed
        deadline = time.monotonic() + DEADLINE_S
        while (
            redis.counters["dropped_slow"] == before["dropped_slow"]
            and observed(range(num_docs)) < num_docs
            and time.monotonic() < deadline
        ):
            await asyncio.sleep(0.01)
        counters = {k: v - before[k] for k, v in redis.counters.items()}
        return {
            "counters": counters,
            "peak_depth": peak["depth"],
            "limit": redis.subscriber_queue_limit,
            "observed": observed(range(num_docs)),
        }
    finally:
        for provider in providers["a"] + providers["b"]:
            provider.destroy()
            provider.websocket_provider.destroy()
        for core in cores.values():
            await core.hooks("on_destroy", PkgPayload(instance=core))
        await redis.stop()


async def test_a_burst_past_the_subscriber_queue_drops_the_subscriber_in_both_packages():
    """Why 1,018 joins at once could lose sync frames: every frame for an
    instance rides ONE mini-redis subscriber connection, whose queue holds
    1,024 frames (a real Redis's pubsub output-buffer limit plays that
    part). A burst of one frame a doc for 1,024 docs, published before the
    pump may run (a join wave's SyncStep2s while a flush holds the loop),
    overflows it, and mini-redis drops the frame and disconnects the
    subscriber; nothing resends what it dropped. The JAX package's
    mini-redis and Redis extension are the same code and drop the same
    frames. Paced 64 at a time, each chunk observed before the next, as
    loadgen joins, the queue stays far below its bound and every frame
    arrives."""
    burst = {package: await _burst_through_redis(package, 1024, 1024) for package in ("jax", "port")}
    for package, out in burst.items():
        assert out["peak_depth"] == out["limit"] + 1, (package, out)
        assert out["counters"]["dropped_slow"] > 0, (package, out)
        assert out["counters"]["slow_disconnects"] > 0, (package, out)
    paced = await _burst_through_redis("port", 1024, 64)
    assert paced["counters"]["dropped_slow"] == paced["counters"]["slow_disconnects"] == 0, paced
    assert paced["peak_depth"] < paced["limit"] // 2, paced
    assert paced["observed"] == 1024, paced
