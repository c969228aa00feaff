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
