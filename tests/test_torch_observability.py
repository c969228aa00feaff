"""The port's observability plane (`hocuspocus_tpu_torch/observability/`)
against the JAX package's, on the CPU.

The same seeded operations, with an injected clock where a module takes
one, go through both packages: the Prometheus registry renders byte for
byte; SLO burn rates, the `/debug/slo` rollup, the fleet digest,
`stamp_header` and the fleet view agree; the sampling profiler folds one
synthetic frame set into the same collapsed stacks; the device watch
feeds the same metric families; and `/metrics` of a served, supervised
plane lists every plane, supervisor and WAL family the JAX package lists
for the same traffic, with equal values where they are counts. State
tolerance 0 (equal bytes and values) except the sampling profiler's live
sample counts, compared as a set of stacks.
"""

import importlib
import itertools
import json
import time
from collections import namedtuple
from types import SimpleNamespace

import numpy as np
import pytest

from hocuspocus_tpu import crdt as jax_crdt
from hocuspocus_tpu import observability as jax_obs
from hocuspocus_tpu.observability import device_watch as jax_device_watch
from hocuspocus_tpu.observability import extension as jax_extension
from hocuspocus_tpu.observability import fleet as jax_fleet
from hocuspocus_tpu.observability import metrics as jax_metrics
from hocuspocus_tpu.observability import profiler as jax_profiler
from hocuspocus_tpu.observability import slo as jax_slo
from hocuspocus_tpu_torch import crdt as port_crdt
from hocuspocus_tpu_torch import observability as obs
from hocuspocus_tpu_torch.observability import device_watch, extension, fleet, metrics, profiler, slo

PACKAGES = {
    "jax": SimpleNamespace(
        metrics=jax_metrics, slo=jax_slo, fleet=jax_fleet, profiler=jax_profiler,
        extension=jax_extension, obs=jax_obs, crdt=jax_crdt,
    ),
    "port": SimpleNamespace(
        metrics=metrics, slo=slo, fleet=fleet, profiler=profiler,
        extension=extension, obs=obs, crdt=port_crdt,
    ),
}


class FakeClock:
    """time.monotonic / time.time / time.perf_counter stand-in."""

    def __init__(self, start: float = 1_800_000_000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


# -- the registry ---------------------------------------------------------------


def _registry_ops(pkg, seed):
    """One seeded sequence of metric operations on a fresh registry."""
    rng = np.random.default_rng(seed)
    reg = pkg.metrics.MetricsRegistry()
    counter = reg.counter("demo_events_total", "Events by kind")
    gauge = reg.gauge("demo_level", "A level, by shard")
    live = reg.gauge("demo_live", "A live value", fn=lambda: 42.5)
    hist = reg.histogram("demo_seconds", "Durations, by stage")
    plain = reg.counter("demo_plain_total", "Unlabelled")
    for _ in range(200):
        kind = int(rng.integers(0, 5))
        label = ["a", "b", 'q"uote', "back\\slash", "new\nline"][int(rng.integers(0, 5))]
        if kind == 0:
            counter.inc(float(rng.integers(1, 4)), kind=label)
        elif kind == 1:
            gauge.set(float(rng.normal()), shard=label)
        elif kind == 2:
            hist.observe(float(rng.exponential(0.05)), stage=label)
        elif kind == 3:
            plain.inc()
        else:
            gauge.inc(0.5, shard=label)
    assert live.value() == 42.5
    return reg.expose()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_renders_byte_identical(seed):
    assert _registry_ops(PACKAGES["port"], seed) == _registry_ops(PACKAGES["jax"], seed)


# -- SLO engine -----------------------------------------------------------------------


def _slo_run(pkg, seed):
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    hist = pkg.metrics.Histogram("demo_e2e_seconds", "e2e")
    total = pkg.metrics.Counter("demo_in_total", "in")
    errors = pkg.metrics.Counter("demo_err_total", "err")
    state = {"open": False}
    engine = pkg.slo.SloEngine(sample_interval_s=15.0, clock=clock)
    engine.add(pkg.slo.latency_slo("latency", hist, threshold_s=0.05, objective=0.99))
    engine.add(pkg.slo.counter_ratio_slo("errors", total, errors, objective=0.999, description="d"))
    engine.add(pkg.slo.fraction_slo("open", lambda: state["open"], objective=0.99, description="o"))
    engine.sample()
    statuses = []
    for step in range(300):
        for _ in range(int(rng.integers(0, 20))):
            hist.observe(float(rng.exponential(0.03)), stage="total")
        total.inc(float(rng.integers(1, 50)))
        if rng.random() < 0.3:
            errors.inc(float(rng.integers(1, 5)))
        state["open"] = bool(rng.random() < 0.2)
        clock.advance(float(rng.uniform(1.0, 30.0)))
        engine.maybe_sample()
        if step % 25 == 0:
            statuses.append(engine.status())
            statuses.append({w: engine.burn_rate("latency", w) for w in ("5m", "1h")})
    reg = pkg.metrics.MetricsRegistry()
    for metric in engine.metrics():
        reg.register(metric)
    return statuses, engine.status(), reg.expose()


@pytest.mark.parametrize("seed", [3, 4])
def test_slo_burn_rates_and_rollups_are_equal(seed):
    assert _slo_run(PACKAGES["port"], seed) == _slo_run(PACKAGES["jax"], seed)


async def _debug_slo(pkg, seed):
    """/debug/slo of a fresh Metrics after one seeded event sequence."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    m = pkg.extension.Metrics(slo_e2e_p99_ms=50, slo_error_rate=0.001, slo_fleet_e2e_ms=250)
    m.slo._clock = clock
    m.slo.sample()
    wire_in0 = m.wire.messages_in
    for _ in range(40):
        for _ in range(int(rng.integers(1, 10))):
            m.update_e2e.observe(float(rng.exponential(0.04)), stage="total")
        m.fleet.e2e_histogram.observe(float(rng.exponential(0.1)), stage="total")
        clock.advance(16.0)
        m.slo.maybe_sample()
    assert wire_in0 is m.wire.messages_in
    # the wire counters are process-wide and carry earlier tests' traffic:
    # their SLO reads the windows' deltas, which start at 0 here
    from chip_smoke import scrape

    status, body = await scrape(m, "/debug/slo")
    assert status == 200
    payload = json.loads(body)
    # the stamped header (wall clock, this process's fleet identity) and
    # the overload ladder's own status are each package's process state
    for key in ("generated_utc", "role", "node_id"):
        assert payload.pop(key)
    overload = payload.pop("overload")
    return payload, sorted(overload)


async def test_debug_slo_json_is_equal():
    ours, theirs = await _debug_slo(PACKAGES["port"], 8), await _debug_slo(PACKAGES["jax"], 8)
    assert ours == theirs
    assert set(ours[0]["slos"]) == {"update_e2e_latency", "wire_error_rate", "fleet_e2e_latency"}
    assert ours[0]["samples"] > 1


# -- the fleet view ----------------------------------------------------------------------


def _fleet_run(pkg, monkeypatch):
    clock = FakeClock()
    fake_time = SimpleNamespace(
        time=clock, monotonic=clock, perf_counter=clock, gmtime=time.gmtime, strftime=time.strftime,
    )
    monkeypatch.setattr(pkg.fleet, "time", fake_time)
    monkeypatch.setattr(pkg.fleet, "_BOOT", "boot0")
    monkeypatch.setattr(pkg.fleet, "_digest_seq", itertools.count(1))
    monkeypatch.setattr(pkg.fleet, "_pid", lambda: 4242)
    # the process-wide collectors a digest reads, alike in both packages
    overload = SimpleNamespace(enabled=True, rung=1)
    wire = SimpleNamespace(enabled=True, queue_depth_total=lambda: 7, inbox_depth_total=lambda: 3)
    ledger = SimpleNamespace(enabled=True, headroom_frames_per_s=lambda: 1234.56)
    package = pkg.fleet.__name__.split(".")[0]
    server_overload = importlib.import_module(f"{package}.server.overload")
    wire_mod = importlib.import_module(f"{package}.observability.wire")
    costs_mod = importlib.import_module(f"{package}.observability.costs")
    monkeypatch.setattr(server_overload, "get_overload_controller", lambda: overload)
    monkeypatch.setattr(wire_mod, "get_wire_telemetry", lambda: wire)
    monkeypatch.setattr(costs_mod, "get_cost_ledger", lambda: ledger)
    view = pkg.fleet.FleetView().enable()
    monkeypatch.setattr(pkg.fleet, "_fleet_view", view, raising=False)
    monkeypatch.setattr(pkg.fleet, "get_fleet_view", lambda: view)
    view.set_identity("monolith", "node-a", force=True)
    out = []
    for i in range(12):
        digest = pkg.fleet.build_digest(
            role=["edge", "cell", "monolith"][i % 3],
            node_id=f"node-{i % 4}",
            interval_s=15.0,
            extra={"epoch": i // 5, "cells": {"c0": {"docs": i}}} if i % 3 == 1 else None,
        )
        out.append(digest)
        out.append(view.ingest(digest))
        clock.advance(7.0)
        out.append(view.status())
    out.append(pkg.fleet.stamp_header({"payload": 1}))
    out.append(pkg.fleet.stamp_header({"role": "kept"}))
    view.refresh_gauges()
    reg = pkg.metrics.MetricsRegistry()
    for metric in view.metrics():
        reg.register(metric)
    out.append(reg.expose())
    return out


def test_fleet_digest_view_and_stamp_header_are_equal(monkeypatch):
    ours = _fleet_run(PACKAGES["port"], monkeypatch)
    monkeypatch.undo()
    theirs = _fleet_run(PACKAGES["jax"], monkeypatch)
    assert ours == theirs
    assert ours[-3]["node_id"] == "node-a" and ours[-2]["role"] == "kept"


# -- the sampling profiler ----------------------------------------------------------


Code = namedtuple("Code", "co_filename co_name")  # hashable, as code objects are


def _frames(seed):
    """Synthetic thread stacks: {tid: leaf frame}, frames with f_code,
    f_back and f_lasti as the interpreter's."""
    rng = np.random.default_rng(seed)
    files = ["/srv/app/server.py", "/usr/lib/python3.12/asyncio/base_events.py",
             "<frozen importlib._bootstrap>", "/srv/app/my plane.py", "flush.pyc"]
    funcs = ["run", "_run_once", "flush", "<lambda>", "handle update"]
    codes = [Code(f, n) for f in files for n in funcs]
    out = {}
    for tid in range(1, 6):
        frame = None
        for depth in range(int(rng.integers(1, 80))):
            frame = SimpleNamespace(
                f_code=codes[int(rng.integers(0, len(codes)))], f_back=frame, f_lasti=depth
            )
        out[tid] = frame
    return out


def _profile(pkg, monkeypatch, seeds):
    prof = pkg.profiler.SamplingProfiler(hz=0)
    threads = [
        SimpleNamespace(ident=1, name="MainThread"),
        SimpleNamespace(ident=2, name="ThreadPoolExecutor-0_3"),
        SimpleNamespace(ident=3, name="Thread-5 (_do_shutdown)"),
        SimpleNamespace(ident=4, name="flush_12"),
    ]
    import threading

    fake_threading = SimpleNamespace(
        get_ident=lambda: 99, enumerate=lambda: threads, Thread=threading.Thread,
        Lock=threading.Lock, Event=threading.Event,
    )
    monkeypatch.setattr(pkg.profiler, "threading", fake_threading)
    folded = []
    for seed in seeds:
        frames = _frames(seed)
        monkeypatch.setattr(pkg.profiler, "sys", SimpleNamespace(_current_frames=lambda f=frames: f))
        assert prof._sample_once() == len(frames)
        burst: dict = {}
        prof._sample_once(into=burst)
        folded.append(burst)
    stats = prof.stats()
    stats.pop("overhead_fraction")
    return prof.collapsed(), prof.top_stacks(8), folded, stats


def test_profiler_folds_synthetic_frames_into_identical_stacks(monkeypatch):
    seeds = [0, 1, 0, 2, 1, 1]
    ours = _profile(PACKAGES["port"], monkeypatch, seeds)
    monkeypatch.undo()
    theirs = _profile(PACKAGES["jax"], monkeypatch, seeds)
    assert ours == theirs
    for pkg in PACKAGES.values():
        assert pkg.profiler._thread_label("ThreadPoolExecutor-0_3") == "ThreadPoolExecutor-N_N"
        assert pkg.profiler._module_label("<frozen importlib._bootstrap>") == "importlib._bootstrap"


def test_live_profiler_samples_are_the_same_set_of_stacks():
    """Both packages' samplers on this process for a moment: the sample
    counts are live, so only the folded stacks' shape is compared."""
    import threading

    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(range(1000))

    worker = threading.Thread(target=busy, name="busy_1")
    worker.start()
    roots = []
    try:
        for pkg in (PACKAGES["port"], PACKAGES["jax"]):
            prof = pkg.profiler.SamplingProfiler(hz=200).start()
            time.sleep(0.3)
            prof.stop()
            stacks = {line.rpartition(" ")[0] for line in prof.collapsed().splitlines()}
            roots.append({stack.split(";")[0] for stack in stacks})
            assert prof.stats()["samples"] > 0
    finally:
        stop.set()
        worker.join()
    assert "busy_N" in roots[0] and "busy_N" in roots[1]


# -- the device watch ---------------------------------------------------------------


def test_device_watch_feeds_the_jax_compile_families():
    from hocuspocus_tpu_torch.tpu import MergePlane

    ours = {m.name for m in device_watch.compile_metrics()}
    assert ours == {m.name for m in jax_device_watch.compile_metrics()}
    before = dict(device_watch.compile_metrics()[1]._values)
    plane = MergePlane(num_docs=4, capacity=64, device="cpu")
    plane.warmup_compiles()
    watch = plane.compile_watch
    assert isinstance(watch, obs.CompileTracker) and watch.warmed
    grid = {plane._warm_site(entry) for entry in plane.warmup_shapes() + plane.warmup_aux_shapes()}
    assert watch.first_launches == watch.fresh_compiles == len(grid)
    plane.canary_probe()
    assert watch.repeat_launches == 1 and watch.unwarmed_launches == 0
    after = device_watch.compile_metrics()[1]._values
    fresh = {
        key: value - before.get(key, 0.0)
        for key, value in after.items()
        if value > before.get(key, 0.0)
    }
    compiles = {(dict(k)["site"], dict(k)["shape"]) for k in fresh if dict(k)["kind"] == "compile"}
    assert compiles == {(site, device_watch.shape_label(shape)) for site, shape in grid}
    # a launch at a shape the grid missed is a storm candidate, as in JAX
    for tracker in (device_watch.CompileTracker(storm_threshold=2), jax_device_watch.CompileTracker(storm_threshold=2)):
        tracker.mark_warmed()
        kinds = [tracker.observe("integrate_sparse", (k, 1), 0.001) for k in (1, 1, 2, 3)]
        assert kinds == ["compile", "hit", "compile", "compile"]
        assert tracker.snapshot()["storms"] >= 1
    state = plane.state
    assert device_watch.tensor_nbytes(state) == plane.memory_stats()["arena_bytes"]
    assert device_watch.tensor_nbytes({"a": np.zeros(3, np.int32), "b": [b"x", None]}) == 12


# -- Metrics beside the supervised served plane ---------------------------------------


def _served_pkg(name):
    if name == "jax":
        from hocuspocus_tpu.server import Configuration, Hocuspocus
        from hocuspocus_tpu.server.types import Payload
        from hocuspocus_tpu.storage import Durability
        from hocuspocus_tpu.tpu import SupervisedTpuMergeExtension

        extra = {}
    else:
        from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
        from hocuspocus_tpu_torch.server.types import Payload
        from hocuspocus_tpu_torch.storage import Durability
        from hocuspocus_tpu_torch.tpu import SupervisedTpuMergeExtension

        extra = {"device": "cpu"}
    return SimpleNamespace(
        Configuration=Configuration, Hocuspocus=Hocuspocus, Payload=Payload,
        Durability=Durability, Supervised=SupervisedTpuMergeExtension, extra=extra,
        pkg=PACKAGES[name],
    )


class _MeteredSide:
    """One package's core with Metrics, Durability and the supervised
    plane (no timers: broadcasts and flushes are explicit)."""

    def __init__(self, name, wal_dir) -> None:
        self.p = p = _served_pkg(name)
        self.metrics = p.pkg.extension.Metrics()
        self.durability = p.Durability(wal_dir=wal_dir)
        self.ext = p.Supervised(
            num_docs=8, capacity=256, serve=True, governor=False, flush_interval_ms=1e6,
            init_timeout=60.0, watchdog_interval=3600.0, **p.extra,
        )
        self.core = p.Hocuspocus(
            p.Configuration(quiet=True, extensions=[self.metrics, self.durability, self.ext],
                            debounce=60_000, max_debounce=60_000)
        )
        self.directs = {}

    async def open(self, names) -> None:
        import asyncio

        await self.core.ensure_configured()
        await self.core.hooks(
            "on_listen", self.p.Payload(instance=self.core, configuration=self.core.configuration, port=None)
        )
        for _ in range(6000):
            if self.ext.supervisor.state == "ready":
                break
            await asyncio.sleep(0.01)
        assert self.ext.supervisor.state == "ready"
        self.runtime = self.ext.runtime
        for _ in range(12000):
            if self.runtime.plane.compile_watch.snapshot()["warmed"]:
                break
            await asyncio.sleep(0.005)
        assert self.runtime.plane.compile_watch.snapshot()["warmed"]
        self.runtime._schedule_broadcast = lambda: None
        for name in names:
            self.directs[name] = await self.core.open_direct_connection(name)

    async def feed(self, name, update) -> None:
        apply_update = self.p.pkg.crdt.apply_update
        await self.directs[name].transact(lambda doc: apply_update(doc, update, "metered"))

    async def settle(self) -> None:
        import asyncio

        self.runtime._broadcast_served()
        await self.runtime._flush_now(max_batches=None, final=True)
        while self.runtime._flush_tasks:
            await asyncio.gather(*list(self.runtime._flush_tasks))
        await self.durability.wal.flush()

    async def scrape(self) -> dict:
        from chip_smoke import parse_prometheus, scrape

        status, text = await scrape(self.metrics, "/metrics")
        assert status == 200
        return parse_prometheus(text, "/metrics")

    async def close(self) -> None:
        for direct in self.directs.values():
            await direct.disconnect()
        await self.core.hooks("on_destroy", self.p.Payload(instance=self.core))
        # Metrics started the package's sampler at configure: stop it, so
        # later tests of this worker run without it
        self.p.pkg.profiler.get_profiler().stop()


FAMILIES = ("hocuspocus_tpu_plane_", "hocuspocus_tpu_supervisor_", "hocuspocus_wal_",
            "hocuspocus_tpu_compile_", "hocuspocus_tpu_slo_", "hocuspocus_profile_",
            "hocuspocus_fleet_")


def _families(series) -> set:
    return {name for name, _labels in series if name.startswith(FAMILIES)}


async def test_metrics_of_a_served_plane_lists_every_jax_family(tmp_path):
    from tests.test_torch_parity_isolation import resolve_jax_codec
    from tests.test_torch_server_parity import _editors, _round

    resolve_jax_codec()
    rng = np.random.default_rng(17)
    names = [f"doc-{i}" for i in range(4)]
    sides = [_MeteredSide("jax", str(tmp_path / "jax")), _MeteredSide("port", str(tmp_path / "port"))]
    try:
        for side in sides:
            await side.open(names)
        groups = _editors(rng)[: len(names)]
        for step in range(3):
            for name, group in zip(names, groups):
                for update in _round(rng, group, step, plain=True):
                    for side in sides:
                        await side.feed(name, update)
            for side in sides:
                await side.settle()
        theirs, ours = [await side.scrape() for side in sides]
        missing = _families(theirs) - _families(ours)
        assert not missing, sorted(missing)
        # counts are equal: the plane's counters, its rows, the WAL's
        # records and the supervisor's state and transitions
        counts = [
            f"hocuspocus_tpu_plane_{key.removeprefix('plane_')}"
            for key in sides[1].runtime.plane.counters
        ] + [
            "hocuspocus_tpu_plane_arena_rows_in_use", "hocuspocus_tpu_plane_ops_integrated",
            "hocuspocus_tpu_plane_slots_free", "hocuspocus_tpu_plane_slots_live",
            "hocuspocus_tpu_plane_slots_retired", "hocuspocus_wal_appended_records",
            "hocuspocus_wal_appended_bytes", "hocuspocus_wal_checkpoints",
            "hocuspocus_wal_append_errors", "hocuspocus_tpu_supervisor_state",
            "hocuspocus_tpu_supervisor_breaker_state", "hocuspocus_tpu_supervisor_attaches",
            "hocuspocus_tpu_supervisor_degrades", "hocuspocus_tpu_supervisor_init_failures",
        ]
        for metric in counts:
            assert ours[metric, ()] == theirs[metric, ()], metric
        assert ours["hocuspocus_tpu_plane_broadcasts", ()] > 0
        assert ours["hocuspocus_wal_appended_records", ()] > 0
        assert ours["hocuspocus_tpu_supervisor_state", ()] == 1.0
        transition = ("hocuspocus_tpu_supervisor_transitions_total",
                      (("from_state", "initializing"), ("to_state", "ready")))
        assert ours[transition] == theirs[transition] == 1.0
    finally:
        for side in sides:
            await side.close()


def _supervisor_lines(name) -> list:
    """Drive one package's supervisor through its states under
    `Metrics._bind_supervisor_metrics`: the supervisor series after each
    step, and the registry's text after a runtime attaches."""
    p = _served_pkg(name)
    m = p.pkg.extension.Metrics()
    ext = p.Supervised(num_docs=4, capacity=64, serve=True, runtime_factory=lambda: None)
    sup = ext.supervisor
    m._bind_supervisor_metrics(sup)
    lines = []

    def scrape():
        text = m.registry.expose()
        lines.append([line for line in text.splitlines() if "supervisor" in line and not line.startswith("#")])

    scrape()
    sup._set_state("ready")
    scrape()
    sup.breaker.record_failure()
    sup.breaker._move("open")
    sup.breaker._move("half_open")
    sup._set_state("degraded")
    for fn in sup.on_canary:
        fn(0.004)
    scrape()
    sup.breaker.record_success()
    sup._set_state("ready")
    scrape()
    if name == "jax":
        from hocuspocus_tpu.tpu import TpuMergeExtension

        runtime = TpuMergeExtension(num_docs=4, capacity=64, serve=True)
    else:
        from hocuspocus_tpu_torch.tpu import TpuMergeExtension

        runtime = TpuMergeExtension(num_docs=4, capacity=64, serve=True, device="cpu")
    for fn in sup.on_attach:
        fn(runtime)
    return lines, m.registry.expose()


def test_supervisor_codes_and_hooks_read_through_the_metrics_binding():
    """`Metrics._bind_supervisor_metrics` over each package's supervisor:
    the state and breaker codes, both transition counters, the canary
    histogram and the plane gauges bound at attach read alike. The port
    counts two things more: canaries that raised, and card faults (a
    card error stops serving)."""
    theirs, their_text = _supervisor_lines("jax")
    ours, text = _supervisor_lines("port")
    extra = {"hocuspocus_tpu_supervisor_card_faults 0", "hocuspocus_tpu_supervisor_canary_errors 0"}
    assert [[line for line in step if line not in extra] for step in ours] == theirs
    assert all(extra <= set(step) for step in ours)
    last = ours[-1]
    assert "hocuspocus_tpu_supervisor_state 1" in last
    assert "hocuspocus_tpu_supervisor_breaker_state 0" in last
    assert 'hocuspocus_tpu_supervisor_breaker_transitions_total{from_state="open",to_state="half_open"} 1' in last
    assert 'hocuspocus_tpu_supervisor_transitions_total{from_state="degraded",to_state="ready"} 1' in last
    assert "hocuspocus_tpu_supervisor_canary_seconds_count 1" in last
    for exposition in (text, their_text):
        assert "hocuspocus_tpu_plane_arena_rows_in_use 0" in exposition
        assert "hocuspocus_tpu_plane_cpu_fallbacks 0" in exposition
