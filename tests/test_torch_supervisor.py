"""The port's plane supervisor (tpu/supervisor.py) and degradation rails.

Twins of tests/tpu/test_supervisor.py (all but the sharded runtime, which
waits for the port of the JAX package's sharding), of the rails in
tests/tpu/test_chaos_rails.py and tests/tpu/test_degradation_rails.py that
need neither Redis nor storage, run on the CPU (`device="cpu"`). The wedge
is injected through the plane's `_step_fn` / `_sparse_step_fn` /
`_append_step_fn` seams, as the JAX tests do. Clients are the port's
providers on in-process sockets, except where a test needs HTTP or a
restart on one port. Every wait polls with a deadline.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from hocuspocus_tpu.crdt import Doc as JaxDoc
from hocuspocus_tpu.crdt import encode_state_as_update as jax_encode
from hocuspocus_tpu.tpu.merge_plane import MergePlane as JaxPlane
from hocuspocus_tpu_torch.crdt import YXmlElement, YXmlText
from hocuspocus_tpu_torch.observability.flight_recorder import get_flight_recorder
from hocuspocus_tpu_torch.provider import HocuspocusProvider
from hocuspocus_tpu_torch.server import Configuration
from hocuspocus_tpu_torch.server.types import Payload
from hocuspocus_tpu_torch.tpu import MergePlane, SupervisedTpuMergeExtension, TpuMergeExtension
from hocuspocus_tpu_torch.tpu.scheduler import (
    CLASS_BACKGROUND,
    CLASS_CANARY,
    CLASS_CATCHUP,
    CLASS_INTERACTIVE,
    DeviceLane,
    LaneDeferred,
    reset_device_lane,
)
from hocuspocus_tpu_torch.tpu.supervisor import (
    BREAKER_CLOSED,
    BREAKER_OPEN,
    STATE_BROKEN,
    STATE_DEGRADED,
    STATE_INITIALIZING,
    STATE_READY,
    CircuitBreaker,
)
from tests.test_torch_plane import assert_planes_equal
from tests.test_torch_server import Served, _assert, _served_ext, until


def _fast_ext(**overrides) -> SupervisedTpuMergeExtension:
    """A supervised serve-mode extension on the CPU, at test cadence."""
    kwargs = dict(
        serve=True,
        device="cpu",
        num_docs=8,
        capacity=512,
        flush_interval_ms=1,
        init_timeout=60.0,
        watchdog_interval=0.1,
        breaker_threshold=2,
        canary_deadline=0.25,
    )
    kwargs.update(overrides)
    reset_device_lane()
    return SupervisedTpuMergeExtension(**kwargs)


class Supervised(Served):
    """Served with the listen hook fired: the supervisor starts there."""

    async def __aenter__(self) -> "Supervised":
        await super().__aenter__()
        await self.core.hooks("on_listen", Payload(instance=self.core, port=None))
        return self


class _WedgeableStep:
    """Pass-through step seams until wedge(): wedged steps block on the
    gate, then run the real step (a hung device that later completes the
    launch). `entered` latches once a dispatch is blocked, its caller
    holding the flush lock. recover() in the test's finally: a blocked
    executor thread outliving the test would hang the loop's teardown."""

    def __init__(self, plane) -> None:
        self.real = plane._step_fn
        self.real_sparse = plane._sparse_step_fn
        self.real_append = plane._append_step_fn
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.wedged = False
        plane._step_fn = lambda: self._wrap(self.real())
        plane._sparse_step_fn = lambda: self._wrap(self.real_sparse())
        plane._append_step_fn = lambda: self._wrap(self.real_append())

    def _wrap(self, step):
        if not self.wedged:
            return step

        def blocked(state, *args):
            self.entered.set()
            self.gate.wait()
            return step(state, *args)

        return blocked

    def wedge(self) -> None:
        self.wedged = True
        self.gate.clear()

    def recover(self) -> None:
        self.wedged = False
        self.gate.set()


def _ready_and_served(ext, name):
    return lambda: _assert(
        ext.supervisor.state == STATE_READY and ext.runtime.is_served(name),
        ext.supervisor.snapshot(),
    )


def _text(provider) -> str:
    return provider.document.get_text("t").to_string()


# -- breaker, init, missing CUDA -------------------------------------------------


def test_circuit_breaker_state_machine():
    breaker = CircuitBreaker(threshold=3)
    assert breaker.state == BREAKER_CLOSED
    assert not breaker.record_failure()
    assert not breaker.record_failure()
    assert breaker.record_failure(), "the threshold-th consecutive failure trips"
    assert breaker.state == BREAKER_OPEN
    assert breaker.try_half_open()
    assert not breaker.record_failure()
    assert breaker.state == BREAKER_OPEN
    assert breaker.try_half_open()
    assert breaker.record_success()
    assert breaker.state == BREAKER_CLOSED and breaker.consecutive_failures == 0
    assert not breaker.record_failure()
    assert breaker.transitions["closed->open"] == 1
    assert breaker.transitions["half_open->closed"] == 1
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=0)


def test_missing_cuda_raises_at_construction():
    """Without `device`, the supervised and the residency-enabled
    extensions want the card and raise where there is none, before any
    worker thread starts: no CPU plane is built in the card's place."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")
    threads = threading.active_count()
    for kwargs in ({}, {"device": "cuda"}, {"compact_threshold": 0.75, "evict_idle_secs": 5.0}):
        with pytest.raises(RuntimeError, match="CUDA"):
            SupervisedTpuMergeExtension(serve=True, **kwargs)
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuMergeExtension(serve=True, compact_threshold=0.75, evict_idle_secs=5.0)
    assert threading.active_count() == threads
    assert SupervisedTpuMergeExtension(serve=True, device="cpu").runtime is None


async def test_wedged_init_boots_and_serves_within_deadline():
    gate = threading.Event()

    def wedged_factory():
        gate.wait()
        raise AssertionError("never reached")

    reset_device_lane()
    ext = SupervisedTpuMergeExtension(
        runtime_factory=wedged_factory, init_timeout=0.5, watchdog_interval=0.05
    )
    try:
        async with Supervised(ext) as served:
            a, b = served.provider("wedged-init"), served.provider("wedged-init")
            assert ext.supervisor.state == STATE_INITIALIZING
            await served.synced(a, b)
            a.document.get_text("t").insert(0, "cpu serves")
            await until(lambda: _assert(_text(b) == "cpu serves"))
            await until(lambda: _assert(ext.supervisor.state == STATE_DEGRADED))
            assert ext.supervisor.counters["init_timeouts"] == 1
            health = ext.health_status()
            assert health["degraded"] and health["init"]["pending"]
    finally:
        gate.set()


async def test_teardown_waits_for_a_running_init_thread():
    """A `--role cell --tpu-serve` process SIGTERMed while its plane was
    still being built exited -6: the init worker is a daemon thread, and
    an interpreter that finalizes under it while it runs torch's C++
    aborts ("terminate called without an active exception"). Teardown
    now waits for the worker, at most the init deadline."""

    def slow_factory():
        time.sleep(1.0)

    reset_device_lane()
    ext = SupervisedTpuMergeExtension(
        runtime_factory=slow_factory, init_timeout=10.0, watchdog_interval=0.05
    )
    async with Supervised(ext):
        assert ext.supervisor._init_thread.is_alive()
    assert not ext.supervisor._init_thread.is_alive()


async def test_late_init_hot_attaches_live_documents():
    gate = threading.Event()

    def late_factory():
        gate.wait()
        return TpuMergeExtension(
            serve=True, num_docs=8, capacity=512, flush_interval_ms=1, device="cpu"
        )

    reset_device_lane()
    ext = SupervisedTpuMergeExtension(
        runtime_factory=late_factory, init_timeout=0.2, watchdog_interval=0.05
    )
    try:
        async with Supervised(ext) as served:
            a, b = served.provider("late-doc"), served.provider("late-doc")
            await served.synced(a, b)
            a.document.get_text("t").insert(0, "before;")
            await until(lambda: _assert(_text(b) == "before;"))
            await until(lambda: _assert(ext.supervisor.state == STATE_DEGRADED))
            gate.set()
            await until(_ready_and_served(ext, "late-doc"))
            broadcasts = ext.plane.counters["plane_broadcasts"]
            a.document.get_text("t").insert(0, "plane;")
            await until(lambda: _assert(_text(b) == "plane;before;"))
            await until(lambda: _assert(ext.plane.counters["plane_broadcasts"] > broadcasts))
            c = served.provider("late-doc")
            await served.synced(c)
            await until(lambda: _assert(_text(c) == "plane;before;"))
            assert ext.supervisor.transitions.get("degraded->ready") == 1
    finally:
        gate.set()


async def test_failed_init_is_broken_but_server_serves():
    def dead_factory():
        raise RuntimeError("no CUDA device (injected)")

    reset_device_lane()
    ext = SupervisedTpuMergeExtension(
        runtime_factory=dead_factory, init_timeout=5.0, watchdog_interval=0.05
    )
    async with Supervised(ext) as served:
        a, b = served.provider("broken-doc"), served.provider("broken-doc")
        await until(lambda: _assert(ext.supervisor.state == STATE_BROKEN))
        assert ext.supervisor.counters["init_failures"] == 1
        await served.synced(a, b)
        a.document.get_text("t").insert(0, "still serving")
        await until(lambda: _assert(_text(b) == "still serving"))
        assert ext.runtime is None
        health = ext.health_status()
        assert health["state"] == "broken" and health["degraded"]
        assert not health["init"]["pending"]


async def _refused(served, name: str) -> None:
    """A fresh provider of `name` is refused (permission denied) and never
    syncs: the server has stopped serving."""
    reasons = []
    c = served.provider(name)
    c.on("authentication_failed", reasons.append)
    await until(lambda: _assert(reasons, "the server still admits connections"))
    assert not c.synced


async def test_card_init_error_stops_serving_instead_of_the_cpu(monkeypatch):
    """A card runtime whose kernel does not build (an injected failure of
    `MergePlane.load_kernels` in the default factory, no `device`) stops
    serving: BROKEN with the error as `fault`, every connection closed and
    new ones refused. No document goes on from the CPU document."""
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    gate = threading.Event()
    real_extension = mp.TpuMergeExtension

    def failing_build(self):
        gate.wait()
        raise RuntimeError("nvcc: kernel build failed (injected)")

    # the factory builds what it builds for the card; only the plane's
    # tensors stay on the CPU, which is all this machine has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mp, "TpuMergeExtension", lambda **kw: real_extension(**{**kw, "device": "cpu"}))
    monkeypatch.setattr(mp.MergePlane, "load_kernels", failing_build)
    reset_device_lane()
    ext = SupervisedTpuMergeExtension(
        serve=True, num_docs=8, capacity=512, init_timeout=5.0, watchdog_interval=0.05
    )
    assert ext.supervisor.on_card
    try:
        async with Supervised(ext) as served:
            a = served.provider("card-doc")
            await served.synced(a)  # before the plane attaches
            document = served.core.documents["card-doc"]
            gate.set()
            await until(lambda: _assert(ext.supervisor.state == STATE_BROKEN))
            assert isinstance(ext.supervisor.fault, RuntimeError)
            assert ext.supervisor.counters["card_faults"] == 1
            health = ext.health_status()
            assert health["degraded"] and "injected" in health["fault"]
            await until(lambda: _assert(document.get_connections_count() == 0))
            await _refused(served, "card-doc")
            await _refused(served, "other-doc")
    finally:
        gate.set()


async def test_card_canary_error_stops_serving_instead_of_degrading():
    """On the card a canary that raises (a kernel launch that fails) is a
    fault, not a canary verdict: the breaker stays closed, no served doc
    moves to the CPU document, the supervisor goes BROKEN with the error
    and the server refuses connections. A CPU plane's canary error counts
    as a failure (the JAX package's breaker)."""
    for on_card in (False, True):
        ext = _fast_ext()
        ext.supervisor.on_card = on_card
        async with Supervised(ext) as served:
            a = served.provider("canary-doc")
            await served.synced(a)
            await until(_ready_and_served(ext, "canary-doc"))

            def failing_canary():
                raise RuntimeError("integrate kernel launch failed (injected)")

            ext.plane.canary_probe = failing_canary
            if not on_card:
                await until(lambda: _assert(ext.supervisor.state == STATE_DEGRADED))
                assert ext.supervisor.counters["canary_errors"] >= 2
                assert ext.supervisor.counters["canary_failures"] >= 2
                assert ext.supervisor.fault is None
                continue
            fallbacks = ext.plane.counters["cpu_fallbacks"]
            await until(lambda: _assert(ext.supervisor.state == STATE_BROKEN))
            assert "injected" in str(ext.supervisor.fault)
            assert ext.supervisor.counters["canary_errors"] == 1
            assert ext.supervisor.counters["canary_failures"] == 0
            assert ext.supervisor.counters["degrades"] == 0
            assert not ext.supervisor.breaker.transitions
            assert ext.plane.counters["cpu_fallbacks"] == fallbacks
            assert ext.runtime.is_served("canary-doc"), "no doc degrades to the CPU"
            await _refused(served, "canary-doc")


# -- the watchdog ----------------------------------------------------------------


async def test_canary_probe_is_a_noop_integrate_on_the_plane():
    """The canary launches the sparse step at (K_max, 1) with only padding
    columns: it counts one dispatch and leaves the arena bit-identical to
    the JAX plane's after the same traffic and the same probe."""
    for arena in ("unit", "rle"):
        jax_plane = JaxPlane(num_docs=8, capacity=256, arena=arena)
        plane = MergePlane(num_docs=8, capacity=256, arena=arena, device="cpu")
        lane = plane.lane = DeviceLane()
        ref = JaxDoc()
        ref.get_text("t").insert(0, "canary traffic")
        for p in (jax_plane, plane):
            p.register("doc")
            p.enqueue_update("doc", jax_encode(ref), presync=True)
            p.flush()
        bypass = lane.counters["dispatches_bypass"]
        assert jax_plane.canary_probe() >= 0.0
        assert plane.canary_probe() >= 0.0
        assert lane.counters["dispatches_bypass"] == bypass + 1, "the canary's dispatch is counted"
        assert plane.compile_watch.first_launches + plane.compile_watch.repeat_launches >= 1
        assert_planes_equal(jax_plane, plane)
        assert plane.text("doc") == "canary traffic"


async def test_midflight_wedge_trips_breaker_and_drains_to_cpu():
    ext = _fast_ext()
    wedge = None
    try:
        async with Supervised(ext) as served:
            a, b = served.provider("wedge-doc"), served.provider("wedge-doc")
            await served.synced(a, b)
            await until(_ready_and_served(ext, "wedge-doc"))
            a.document.get_text("t").insert(0, "pre;")
            await until(lambda: _assert(_text(b) == "pre;"))
            wedge = _WedgeableStep(ext.plane)
            wedge.wedge()
            a.document.get_text("t").insert(0, "mid;")
            await until(lambda: _assert(ext.supervisor.state == STATE_DEGRADED))
            assert ext.supervisor.breaker.state == BREAKER_OPEN
            assert ext.plane.counters["cpu_fallbacks"] >= 1
            assert ext.supervisor.counters["degrades"] == 1
            joiners = [served.provider("wedge-doc") for _ in range(2)]
            await served.synced(*joiners)
            for c in joiners:
                await until(lambda c=c: _assert(_text(c) == "mid;pre;"))
            b.document.get_text("t").insert(0, "cpu;")
            await until(lambda: _assert(_text(a) == "cpu;mid;pre;"))
            assert ext.health_status()["degraded"]
            wedge.recover()
    finally:
        if wedge is not None:
            wedge.recover()


async def test_flapping_wedge_recover_wedge_is_accounted():
    ext = _fast_ext()
    wedge = None
    try:
        async with Supervised(ext) as served:
            a, b = served.provider("flap-doc"), served.provider("flap-doc")
            await served.synced(a, b)
            await until(_ready_and_served(ext, "flap-doc"))
            wedge = _WedgeableStep(ext.plane)
            expected = ""
            for cycle in range(2):
                wedge.wedge()
                await until(lambda: _assert(ext.supervisor.state == STATE_DEGRADED))
                expected = f"down{cycle};" + expected
                a.document.get_text("t").insert(0, f"down{cycle};")
                await until(lambda: _assert(_text(b) == expected))
                wedge.recover()
                await until(_ready_and_served(ext, "flap-doc"))
                expected = f"up{cycle};" + expected
                a.document.get_text("t").insert(0, f"up{cycle};")
                await until(lambda: _assert(_text(b) == expected))
            transitions = ext.supervisor.transitions
            assert transitions.get("ready->degraded") == 2, transitions
            assert transitions.get("degraded->ready") == 2, transitions
            assert ext.supervisor.counters["degrades"] == 2
            assert ext.supervisor.counters["attaches"] == 3  # first attach + two recoveries
            moves = ext.supervisor.breaker.transitions
            assert moves.get("closed->open") == 2 and moves.get("half_open->closed") == 2
            c = served.provider("flap-doc")
            await served.synced(c)
            await until(lambda: _assert(_text(c) == expected))
    finally:
        if wedge is not None:
            wedge.recover()


async def test_breaker_open_parks_lane_classes_and_resume_restores():
    lane = DeviceLane()
    ext = _fast_ext(lane=lane)
    wedge = None
    try:
        async with Supervised(ext) as served:
            a, b = served.provider("lane-park-doc"), served.provider("lane-park-doc")
            await served.synced(a, b)
            await until(_ready_and_served(ext, "lane-park-doc"))
            a.document.get_text("t").insert(0, "pre;")
            await until(lambda: _assert(_text(b) == "pre;"))
            wedge = _WedgeableStep(ext.plane)
            wedge.wedge()
            a.document.get_text("t").insert(0, "mid;")
            await until(lambda: _assert(ext.supervisor.state == STATE_DEGRADED))
            assert lane.paused, "an open breaker parks the device lane"
            deferrals = lane.counters["deferrals"]
            for cls in (CLASS_INTERACTIVE, CLASS_CATCHUP, CLASS_BACKGROUND):
                with pytest.raises(LaneDeferred) as deferred:
                    await lane.admit(cls, site="test")
                assert deferred.value.reason == "parked"
            assert lane.counters["deferrals"] >= deferrals + 3
            b.document.get_text("t").insert(0, "cpu;")
            await until(lambda: _assert(_text(a) == "cpu;mid;pre;"))
            wedge.recover()
            await until(
                lambda: _assert(
                    ext.supervisor.state == STATE_READY and not lane.paused,
                    ext.supervisor.snapshot(),
                )
            )
            assert lane.class_admissions[CLASS_CANARY] > 0, "the canary rode the lane"
            ticket = await lane.admit(CLASS_INTERACTIVE, site="test")
            ticket.release()
            a.document.get_text("t").insert(0, "back;")
            await until(lambda: _assert(_text(b) == "back;cpu;mid;pre;"))
            events = [e["event"] for e in get_flight_recorder().events("__plane__")]
            assert "supervisor.transition" in events
    finally:
        if wedge is not None:
            wedge.recover()
    assert not lane.paused, "teardown never leaves the lane parked"


async def test_abort_pending_resolves_stranded_sync_waiters():
    ext = _fast_ext()
    wedge = None
    try:
        async with Supervised(ext) as served:
            a = served.provider("strand-doc")
            await served.synced(a)
            await until(_ready_and_served(ext, "strand-doc"))
            serving = ext.runtime.serving
            wedge = _WedgeableStep(ext.plane)
            wedge.wedge()
            a.document.get_text("t").insert(0, "content")
            await until(lambda: _assert(wedge.entered.is_set()))
            document = served.core.documents["strand-doc"]
            waiter = asyncio.ensure_future(serving.batched_sync("strand-doc", document, None))
            await asyncio.sleep(0.05)
            assert not waiter.done() or waiter.result() is None
            serving.paused = True
            serving.abort_pending()
            assert await asyncio.wait_for(waiter, 5) is None, "a stranded waiter degrades to CPU"
            assert await serving.batched_sync("strand-doc", document, None) is None
            assert serving.encode_state_as_update("strand-doc", document) is None
            wedge.recover()
    finally:
        if wedge is not None:
            wedge.recover()


async def test_healthz_endpoint_reports_plane_state():
    import json

    import aiohttp

    from hocuspocus_tpu_torch.server import Server

    ext = _fast_ext()
    server = Server(Configuration(quiet=True, extensions=[ext]))
    await server.listen(port=0)
    wedge = None
    try:
        await until(lambda: _assert(ext.supervisor.state == STATE_READY))
        async with aiohttp.ClientSession() as session:
            async with session.get(f"{server.http_url}/healthz") as response:
                assert response.status == 200
                body = json.loads(await response.text())
        assert body["status"] == "ok"
        plane = body["extensions"]["SupervisedTpuMergeExtension"]
        assert plane["state"] == "ready" and plane["serving_from_plane"] and not plane["degraded"]
        wedge = _WedgeableStep(ext.plane)
        wedge.wedge()
        # a probe blocks on the wedged step (no doc traffic needed)
        await until(lambda: _assert(ext.supervisor.state == STATE_DEGRADED))
        async with aiohttp.ClientSession() as session:
            async with session.get(f"{server.http_url}/healthz") as response:
                assert response.status == 200
                body = json.loads(await response.text())
        assert body["status"] == "degraded"
        assert body["extensions"]["SupervisedTpuMergeExtension"]["breaker"]["state"] == "open"
        wedge.recover()
    finally:
        if wedge is not None:
            wedge.recover()
        await server.destroy()


async def test_supervised_default_deployment_serves_and_compacts():
    """The JAX CLI's defaults (compaction at 0.75, hydration batches of
    64, eviction on): a churning doc retires on capacity and comes back by
    compaction, an idle doc evicts and hydrates, all through the
    supervised runtime, with no breaker trip."""
    ext = _fast_ext(
        capacity=256, compact_threshold=0.75, hydrate_batch=64, evict_idle_secs=0.4,
        native_lane=False, watchdog_interval=0.2, canary_deadline=None,
    )
    async with Supervised(ext) as served:
        a, b = served.provider("churn"), served.provider("churn")
        await served.synced(a, b)
        await until(_ready_and_served(ext, "churn"))
        runtime = ext.runtime
        assert runtime.residency is not None and runtime.residency.compact_threshold == 0.75
        t = a.document.get_text("t")
        for i in range(12):
            t.insert(len(t), f"{i:02d}" + "x" * 28)
            t.delete(0, min(len(t), 25))
            await until(lambda: _assert(_text(b) == t.to_string()))
        counters = ext.plane.counters
        assert counters["docs_retired_capacity"] + counters["docs_retired_overflow"] >= 1
        await until(lambda: _assert(ext.plane.counters["docs_compacted"] >= 1))
        await until(lambda: _assert(runtime.residency.is_evicted("churn")))
        t.insert(0, "back;")
        await until(lambda: _assert(_text(b) == t.to_string()))
        await until(lambda: _assert(runtime.is_served("churn") and ext.plane.is_supported("churn")))
        ext.plane.flush()
        assert ext.plane.text("churn") == t.to_string()
        assert ext.supervisor.breaker.transitions == {}
        assert ext.supervisor.counters["canary_probes"] >= 1
        assert not ext.health_status()["degraded"]


# -- rails (twins of the chaos and degradation rails) ----------------------------


async def test_device_fault_mid_flush_degrades_all_without_loss():
    ext = _served_ext(num_docs=8, capacity=512, compact_threshold=0.75)
    async with Served(ext) as served:
        pairs = []
        for d in range(3):
            a, b = served.provider(f"chaos-{d}"), served.provider(f"chaos-{d}")
            pairs.append((a, b))
            await served.synced(a, b)
        for i, (a, _b) in enumerate(pairs):
            a.document.get_text("t").insert(0, f"pre{i};")
        await until(lambda: _assert(all(_text(b) == f"pre{i};" for i, (_a, b) in enumerate(pairs))))
        assert len(ext._docs) == 3
        fallbacks = ext.plane.counters["cpu_fallbacks"]

        def dead_step_factory():
            def dead_step(state, *args):
                raise RuntimeError("DEVICE_FAULT (injected)")

            return dead_step

        ext.plane._step_fn = ext.plane._sparse_step_fn = ext.plane._append_step_fn = dead_step_factory
        for i, (a, _b) in enumerate(pairs):
            a.document.get_text("t").insert(0, f"mid{i};")
        await until(lambda: _assert(len(ext._docs) == 0))
        assert ext.plane.counters["cpu_fallbacks"] - fallbacks == 3
        assert ext.plane.counters["docs_retired_fallback"] >= 3
        await until(
            lambda: _assert(all(_text(b) == f"mid{i};pre{i};" for i, (_a, b) in enumerate(pairs)))
        )
        for i, (_a, b) in enumerate(pairs):
            b.document.get_text("t").insert(0, f"post{i};")
        await until(
            lambda: _assert(
                all(_text(a) == f"post{i};mid{i};pre{i};" for i, (a, _b) in enumerate(pairs))
            )
        )
        c = served.provider("chaos-0")
        await served.synced(c)
        await until(lambda: _assert(_text(c) == "post0;mid0;pre0;"))


@pytest.mark.parametrize("compact_threshold", [0.0, 0.75])
async def test_recycle_storm_concurrent_with_catchup_storm(compact_threshold):
    ext = _served_ext(
        num_docs=16, capacity=24, native_lane=False, arena="rle",
        compact_threshold=compact_threshold,
    )
    async with Served(ext) as served:
        n_docs = 4
        writers = [served.provider(f"storm-{d}") for d in range(n_docs)]
        await served.synced(*writers)
        joiners = []

        def exhausted() -> int:
            c = ext.plane.counters
            return c["docs_retired_overflow"] + c["docs_retired_capacity"]

        def reclaimed() -> int:
            return ext.plane.counters["docs_recycled"] + ext.plane.counters["docs_compacted"]

        async def churn(d: int) -> None:
            text = writers[d].document.get_text("t")
            i = 0
            while exhausted() == 0 and i < 100:
                burst = f"d{d}burst{i};"
                base = len(text.to_string())
                text.insert(base, burst)
                text.delete(base, len(burst))
                i += 1
                await asyncio.sleep(0.02)

        async def join_wave(d: int, count: int) -> None:
            for _ in range(count):
                joiners.append((d, served.provider(f"storm-{d}")))
                await asyncio.sleep(0.05)

        await asyncio.gather(*[churn(d) for d in range(n_docs)], *[join_wave(d, 4) for d in range(n_docs)])
        assert exhausted() >= 1, ext.plane.counters
        deadline = time.monotonic() + 30
        while not reclaimed():
            assert time.monotonic() < deadline, ext.plane.counters
            for d in range(n_docs):
                writers[d].document.get_text("t").insert(0, "z")
            await asyncio.sleep(0.5)

        def all_converged():
            for d, c in joiners:
                assert _text(c) == _text(writers[d]), f"a joiner of storm-{d} diverged"

        await until(all_converged)
        for d in range(n_docs):
            writers[d].document.get_text("t").insert(0, "after-storm;")
        await until(all_converged)


async def test_wedged_runtime_server_still_accepts_and_syncs():
    gate = threading.Event()
    init_timeout = 2.0
    reset_device_lane()
    ext = SupervisedTpuMergeExtension(
        runtime_factory=gate.wait, init_timeout=init_timeout, watchdog_interval=0.1
    )
    started = time.monotonic()
    try:
        async with Supervised(ext) as served:
            a, b = served.provider("verdict-doc"), served.provider("verdict-doc")
            await served.synced(a, b)
            assert time.monotonic() - started < init_timeout, "sync within the init deadline"
            a.document.get_text("t").insert(0, "availability first")
            await until(lambda: _assert(_text(b) == "availability first"))
            await until(lambda: _assert(ext.supervisor.state == "degraded"))
            assert ext.health_status()["degraded"]
    finally:
        gate.set()


async def test_plane_full_degrades_newcomers_only():
    ext = _served_ext(num_docs=2, capacity=1024)
    async with Served(ext) as served:
        providers = []
        for d in range(2):
            a, b = served.provider(f"full-{d}"), served.provider(f"full-{d}")
            providers += [a, b]
            await served.synced(a, b)
            a.document.get_text("t").insert(0, f"doc {d}")
        c1, c2 = served.provider("full-2"), served.provider("full-2")
        await served.synced(c1, c2)
        c1.document.get_text("t").insert(0, "cpu-served")
        await until(lambda: _assert(_text(c2) == "cpu-served"))
        assert "full-2" not in ext._docs
        assert "full-0" in ext._docs and "full-1" in ext._docs
        providers[0].document.get_text("t").insert(0, "more ")
        await until(lambda: _assert(_text(providers[1]) == "more doc 0"))


@pytest.mark.parametrize("compact_threshold", [0.0, 0.75])
async def test_concurrent_editors_converge_across_recycles(compact_threshold):
    import random

    ext = _served_ext(num_docs=48, capacity=512, native_lane=False, compact_threshold=compact_threshold)
    async with Served(ext) as served:
        a, b = served.provider("race"), served.provider("race")
        await served.synced(a, b)
        rng = random.Random(7)
        for wave in range(16):
            for who, p in (("a", a), ("b", b)):
                frag = p.document.get_xml_fragment("x")
                el = YXmlElement("paragraph")
                frag.push([el])
                t = YXmlText()
                el.push([t])
                t.insert(0, f"{who}{wave:02d} " * rng.randint(4, 10))
                while len(frag) > 2:
                    frag.delete(0, 1)
            await asyncio.sleep(0.03)

        def converged():
            fa, fb = a.document.get_xml_fragment("x"), b.document.get_xml_fragment("x")
            fs = served.core.documents["race"].get_xml_fragment("x")
            assert len(fa) == len(fb) == len(fs)
            assert fa.to_string() == fb.to_string() == fs.to_string()

        await until(converged)
        await until(lambda: _assert(ext.plane.counters["docs_recycled"] >= 1))
        c = served.provider("race")
        await served.synced(c)
        await until(
            lambda: _assert(
                c.document.get_xml_fragment("x").to_string()
                == a.document.get_xml_fragment("x").to_string()
            )
        )


async def test_offline_edits_merge_through_plane_on_reconnect():
    from hocuspocus_tpu_torch.server import Server

    server = Server(Configuration(quiet=True, extensions=[_served_ext(compact_threshold=0.75)]))
    await server.listen(port=0)
    port = server.port
    provider = HocuspocusProvider(name="offline", url=server.web_socket_url)
    server2 = None
    try:
        await until(lambda: _assert(provider.synced))
        provider.document.get_text("t").insert(0, "before restart")
        await until(
            lambda: _assert(server.documents["offline"].get_text("t").to_string() == "before restart")
        )
        await server.destroy()
        ext2 = _served_ext(compact_threshold=0.75)
        server2 = Server(Configuration(quiet=True, extensions=[ext2]))
        await server2.listen(port=port)
        provider.document.get_text("t").insert(0, "offline! ")
        await until(lambda: _assert(provider.synced))
        await until(
            lambda: _assert(
                server2.documents["offline"].get_text("t").to_string() == "offline! before restart"
            )
        )
        assert "offline" in ext2._docs
        joiner = HocuspocusProvider(name="offline", url=server2.web_socket_url)
        try:
            await until(lambda: _assert(joiner.synced))
            await until(lambda: _assert(_text(joiner) == "offline! before restart"))
            assert ext2.plane.counters["sync_serves"] >= 1
            assert ext2.plane.counters["cpu_fallbacks"] == 0
        finally:
            joiner.destroy()
    finally:
        provider.destroy()
        if server2 is not None:
            await server2.destroy()


@pytest.mark.parametrize("compact_threshold", [0.0, 0.75])
async def test_capacity_recycle_reclaims_rows_for_subtree_churn(compact_threshold):
    ext = _served_ext(num_docs=16, capacity=512, native_lane=False, compact_threshold=compact_threshold)
    async with Served(ext) as served:
        a, b = served.provider("churny"), served.provider("churny")
        await served.synced(a, b)
        frag = a.document.get_xml_fragment("x")
        for wave in range(12):
            el = YXmlElement("paragraph")
            frag.push([el])
            t = YXmlText()
            el.push([t])
            t.insert(0, f"wave {wave:02d} " * 12)
            if len(frag) > 2:
                frag.delete(0, 1)
            await asyncio.sleep(0.05)
        await until(lambda: _assert(ext.plane.counters["docs_recycled"] >= 1))
        await until(lambda: _assert("churny" in ext._docs))
        frag2 = b.document.get_xml_fragment("x")
        await until(lambda: _assert(len(frag2) == len(frag) and len(frag) >= 2))
        serves = ext.plane.counters["sync_serves"]
        c = served.provider("churny")
        await served.synced(c)
        await until(lambda: _assert(len(c.document.get_xml_fragment("x")) == len(frag)))
        assert ext.plane.counters["sync_serves"] > serves


@pytest.mark.parametrize("compact_threshold", [0.0, 0.75])
async def test_capacity_overflow_degrades_without_data_loss(compact_threshold):
    """Pure growth past the row: with compaction on, the attempt finds no
    tombstones to reclaim and declines, so the doc degrades exactly as
    without it."""
    ext = _served_ext(num_docs=4, capacity=96, compact_threshold=compact_threshold)
    async with Served(ext) as served:
        a, b = served.provider("grower"), served.provider("grower")
        await served.synced(a, b)
        text = a.document.get_text("t")
        expected = ""
        for i in range(10):
            chunk = f"chunk-{i:02d}-aaaaaaaaaaaa;"
            text.insert(len(expected), chunk)
            expected += chunk
            await asyncio.sleep(0.02)
        await until(lambda: _assert(_text(b) == expected))
        assert ext.plane.counters["docs_retired_capacity"] >= 1
        assert ext.plane.counters["cpu_fallbacks"] >= 1
        await until(lambda: _assert("grower" not in ext._docs))
        b.document.get_text("t").insert(0, ">> ")
        await until(lambda: _assert(_text(a) == ">> " + expected))
        c = served.provider("grower")
        await served.synced(c)
        await until(lambda: _assert(_text(c) == ">> " + expected))
        assert ext.plane.counters["docs_compacted"] == 0


def test_supervised_extension_refuses_sharding():
    with pytest.raises(NotImplementedError, match="item 7b"):
        SupervisedTpuMergeExtension(serve=True, device="cpu", shards=2)
    with pytest.raises(ValueError, match="not both"):
        SupervisedTpuMergeExtension(serve=True, device="cpu", devices=4, shards=2)
    assert np.isfinite(SupervisedTpuMergeExtension(device="cpu").supervisor.canary_deadline)


# -- the lane's park and starvation guard (twins of tests/tpu/test_scheduler.py) ---


async def test_lane_starvation_guard_promotes_aged_background():
    lane = DeviceLane(promote_after_s=0.02)
    holder = await lane.admit(CLASS_INTERACTIVE)
    order = []

    async def wait_for(cls, tag):
        ticket = await lane.admit(cls, site=tag)
        order.append(tag)
        ticket.release()

    aged = asyncio.ensure_future(wait_for(CLASS_BACKGROUND, "aged-bg"))
    await asyncio.sleep(0.05)  # the background waiter ages past the guard
    fresh = asyncio.ensure_future(wait_for(CLASS_INTERACTIVE, "fresh-live"))
    await asyncio.sleep(0)
    holder.release()
    await asyncio.gather(aged, fresh)
    # promoted to the interactive class with its ORIGINAL sequence number
    assert order == ["aged-bg", "fresh-live"]
    assert lane.counters["starved_promotions"] == 1
    events = [e["event"] for e in get_flight_recorder().events("__plane__")]
    assert "lane_starved_promoted" in events


async def test_lane_pause_parks_and_resume_restores():
    lane = DeviceLane()
    holder = await lane.admit(CLASS_INTERACTIVE)
    queued = asyncio.ensure_future(lane.admit(CLASS_CATCHUP, site="queued"))
    await asyncio.sleep(0)
    lane.pause()
    with pytest.raises(LaneDeferred) as deferred:
        await queued
    assert deferred.value.reason == "parked"
    for cls in (CLASS_INTERACTIVE, CLASS_CATCHUP, CLASS_BACKGROUND):
        with pytest.raises(LaneDeferred):
            await lane.admit(cls)
    assert lane.counters["deferrals"] == 4
    holder.release()
    probe = await lane.admit(CLASS_CANARY, ignore_pause=True)
    probe.release()
    lane.resume()
    ticket = await lane.admit(CLASS_INTERACTIVE)
    ticket.release()
    assert lane.counters["admissions"] == 3
    assert lane.snapshot()["paused"] is False
