"""The port's loadgen package against the JAX package's.

Every scenario of the library compiles to the same canonical JSON in both
packages (bytes for bytes, two seeds). The single-plane runs of
tests/tpu/test_loadgen.py and tests/tpu/test_scenarios.py go through both
packages' harness and runner, the port's planes on the CPU
(`device="cpu"`); what a run's schedule fixes (verdicts, phase names,
measured op counts, served docs, sample counts, the ladder's path) must be
equal, while latencies are each package's own. `/debug/loadgen` answers
from the port's Metrics as from the JAX package's. The edge populations
run through the split front door; the sharded and multi-device ones,
not ported yet, raise NotImplementedError naming ROADMAP.md, Queue A
item 7. The twins that run both packages are plain tests over
`asyncio.run`: two runs can outlast the 60 s that tests/conftest.py gives
one coroutine test when the suite runs in parallel.
"""

import asyncio
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import hocuspocus_tpu.loadgen as jax_loadgen
import hocuspocus_tpu.loadgen.scenario as jax_scenario
import hocuspocus_tpu.loadgen.scenarios as jax_scenarios
import hocuspocus_tpu.loadgen.timeline as jax_timeline
import hocuspocus_tpu.observability as jax_observability
import hocuspocus_tpu.server.overload as jax_overload
import hocuspocus_tpu.server.types as jax_types
import hocuspocus_tpu_torch.loadgen as port_loadgen
import hocuspocus_tpu_torch.loadgen.scenario as port_scenario
import hocuspocus_tpu_torch.loadgen.scenarios as port_scenarios
import hocuspocus_tpu_torch.loadgen.timeline as port_timeline
import hocuspocus_tpu_torch.observability as port_observability
import hocuspocus_tpu_torch.server.overload as port_overload
import hocuspocus_tpu_torch.server.types as port_types
from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

ROOT = Path(__file__).resolve().parent.parent

PACKAGES = {
    "jax": types.SimpleNamespace(
        loadgen=jax_loadgen, scenario=jax_scenario, scenarios=jax_scenarios,
        timeline=jax_timeline, observability=jax_observability, overload=jax_overload,
        types=jax_types, plane={},
    ),
    "port": types.SimpleNamespace(
        loadgen=port_loadgen, scenario=port_scenario, scenarios=port_scenarios,
        timeline=port_timeline, observability=port_observability, overload=port_overload,
        types=port_types, plane={"device": "cpu"},
    ),
}

# scenarios whose population the port runs: one plane per instance
SINGLE_PLANE = ("smoke", "replication_lag", "overload_storm", "partition_heal", "wire_saturation")
UNPORTED = {
    "diurnal": "item 7", "flash_crowd": "item 7", "reconnect_herd": "item 7",
    "mega_doc": "item 7", "storm": "item 7", "multi_device_storm": "item 7",
    "diurnal_autoscale": "item 7",
}
# the split front door: edges in front of merge cells (tests/test_torch_edge.py)
EDGE = ("edge_fanout", "edge_handoff", "mega_audience")


# -- the schedule compilers ---------------------------------------------------


def test_the_library_names_the_same_scenarios_and_suite():
    assert list(port_scenarios.SCENARIOS) == list(jax_scenarios.SCENARIOS)
    assert list(port_loadgen.BENCH_SUITE) == list(jax_loadgen.BENCH_SUITE)
    assert set(SINGLE_PLANE) | set(EDGE) | set(UNPORTED) == set(port_scenarios.SCENARIOS)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(jax_scenarios.SCENARIOS))
def test_compiled_schedule_is_byte_identical(name, seed):
    jax_schedule = jax_loadgen.get_scenario(name).compile(seed)
    port_schedule = port_loadgen.get_scenario(name).compile(seed)
    assert port_schedule.canonical_bytes() == jax_schedule.canonical_bytes()
    assert port_schedule.to_json() == jax_schedule.to_json()
    assert port_schedule.schedule_hash == jax_schedule.schedule_hash


def test_schedule_compile_is_deterministic():
    """Twin of the JAX test of the same name: for every scenario the same
    seed compiles to the same bytes, another seed to another hash, ops
    carry declared phase names in time order, in both packages alike."""
    rows = {}
    for name, pkg in PACKAGES.items():
        seen = []
        for scenario in pkg.scenarios.SCENARIOS:
            first = pkg.loadgen.get_scenario(scenario).compile(seed=7)
            second = pkg.loadgen.get_scenario(scenario).compile(seed=7)
            other = pkg.loadgen.get_scenario(scenario).compile(seed=8)
            assert first.canonical_bytes() == second.canonical_bytes(), scenario
            assert first.schedule_hash != other.schedule_hash and first.ops, scenario
            assert {op.phase for op in first.ops} <= {p["name"] for p in first.phases}, scenario
            assert [op.at_ms for op in first.ops] == sorted(op.at_ms for op in first.ops), scenario
            seen.append((scenario, first.schedule_hash, other.schedule_hash))
        rows[name] = seen
    assert rows["port"] == rows["jax"]


def test_schedule_ops_stay_phase_monotonic_at_boundaries():
    """Twin of the JAX test of the same name: boundary ops clamp into
    their phase, in declared phase order, the same in both packages."""
    rows = {}
    for name, pkg in PACKAGES.items():
        def boundary_gen(rng, scenario, phase, pkg=pkg):
            return [
                pkg.scenario.OpEvent(phase.duration_ms, phase.name, "edit", doc=0, size=8),
                pkg.scenario.OpEvent(0, phase.name, "edit", doc=0, size=8),
            ]

        scenario = pkg.scenario.Scenario(
            name="boundary",
            num_docs=2,
            phases=[
                pkg.scenario.PhaseSpec("zz_first", 100, boundary_gen),
                pkg.scenario.PhaseSpec("aa_second", 100, boundary_gen),
            ],
        )
        schedule = scenario.compile(seed=0)
        seen = [op.phase for op in schedule.ops]
        assert seen == sorted(seen, key=["zz_first", "aa_second"].index)
        for op in schedule.ops:
            assert (0 <= op.at_ms < 100) if op.phase == "zz_first" else (100 <= op.at_ms < 200)
        rows[name] = (schedule.canonical_bytes(), [op.row() for op in schedule.ops])
    assert rows["port"] == rows["jax"]


def test_recorded_schedule_replays_across_packages():
    """A schedule recorded by one package replays byte-identically in
    the other, and tampering shows in either's hash."""
    recorded = jax_loadgen.get_scenario("flash_crowd").compile(seed=3).to_json()
    replayed = port_loadgen.Schedule.from_json(recorded)
    assert replayed.to_json() == recorded
    back = jax_loadgen.Schedule.from_json(port_loadgen.get_scenario("flash_crowd").compile(3).to_json())
    assert back.schedule_hash == replayed.schedule_hash
    tampered = json.loads(recorded)
    tampered["ops"][0][0] += 1
    tampered = json.dumps(tampered)
    assert (
        port_loadgen.Schedule.from_json(tampered).schedule_hash
        == jax_loadgen.Schedule.from_json(tampered).schedule_hash
        != replayed.schedule_hash
    )


# -- the not-ported populations -----------------------------------------------


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_scenario_raises_naming_its_queue_a_item(name):
    schedule = port_loadgen.get_scenario(name).compile(0)
    with pytest.raises(NotImplementedError, match=f"Queue A {UNPORTED[name]}"):
        port_loadgen.ScenarioRunner(schedule, device="cpu")


def test_sharded_harness_and_extensions_raise_naming_item_7():
    from hocuspocus_tpu_torch.tpu import MultiDeviceMergeExtension, ShardedTpuMergeExtension

    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        port_loadgen.ServedLoadHarness(num_docs=8, shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        port_loadgen.ServedLoadHarness(num_docs=8, devices=2, device="cpu")
    for cls in (ShardedTpuMergeExtension, MultiDeviceMergeExtension):
        with pytest.raises(NotImplementedError, match="Queue A item 7"):
            cls(shards=2, num_docs=8, serve=True)


def test_the_edge_harness_runs_like_the_jax_packages():
    """`edges=2` boots the split front door in both packages' harness: two
    stateless edges in front of two merge cells (the port's planes on the
    CPU), writers on edge 0 and readers on edge 1; every timed edit is
    observed through the other edge, and the counts a run's parameters fix
    are equal."""
    runs = {}
    for package, harness_cls, extra in (
        ("jax", jax_loadgen.ServedLoadHarness, {}),
        ("port", port_loadgen.ServedLoadHarness, {"device": "cpu"}),
    ):
        harness = harness_cls(num_docs=8, edges=2, cells=2, sampled=4, edits=6,
                              shard_rows=64, capacity=512, seed=3, **extra)
        result = asyncio.run(harness.run(budget_s=120.0))
        assert len(harness.cell_servers) == 2 and len(harness.edge_gateways) == 2, package
        assert len(harness.servers) == 2 and len(harness.extensions) == 2, package
        runs[package] = result["extra"]
    for key in ("docs", "sampled_docs", "samples", "straggler_timeouts"):
        assert runs["port"][key] == runs["jax"][key], key
    assert runs["port"]["samples"] == 6
    assert [h["cpu_fallbacks"] for h in runs["port"]["plane_health"]] == [0]


def test_the_harness_runs_on_the_card_unless_asked_for_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-c",
         "from hocuspocus_tpu_torch.loadgen import ServedLoadHarness\n"
         "try:\n    ServedLoadHarness(num_docs=8)\n"
         "except RuntimeError as error:\n    print('RAISED', error)\n"
         "print('CPU', ServedLoadHarness(num_docs=8, device='cpu').device)"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "RAISED ServedLoadHarness needs a CUDA device" in proc.stdout
    assert "CPU cpu" in proc.stdout


# -- twins of tests/tpu/test_loadgen.py (one plane a instance) ----------------

HARNESS_RUNS = {
    "single_instance": dict(
        num_docs=96, sampled=8, edits=12, shard_rows=128, capacity=512, docs_per_socket=48,
        sync_timeout=60, budget_s=120,
    ),
    "cross_instance_redis": dict(
        num_docs=24, instances=2, sampled=4, edits=8, shard_rows=32, capacity=512,
        docs_per_socket=24, sync_timeout=60, budget_s=120,
    ),
    "population_beyond_fd_budget": dict(
        num_docs=1024, sampled=8, edits=10, shard_rows=1280, capacity=256,
        docs_per_socket=256, sync_timeout=300, budget_s=300,
    ),
}


def _harness_view(result) -> dict:
    extra = result["extra"]
    return {
        "metric": result["metric"],
        "unit": result["unit"],
        "keys": sorted(extra),
        **{k: extra[k] for k in ("docs", "seed", "instances", "cross_instance", "shards",
                                 "shard_rows", "capacity", "sampled_docs", "samples",
                                 "straggler_timeouts", "served_docs", "transport")},
        "cpu_fallbacks": [health["cpu_fallbacks"] for health in extra["plane_health"]],
        "broadcasting": [health["plane_broadcasts"] > 0 for health in extra["plane_health"]],
    }


@pytest.mark.parametrize("run", list(HARNESS_RUNS))
def test_served_load_harness_matches_the_jax_package(run):
    views = {}
    for name, pkg in PACKAGES.items():
        reset_device_lane()
        result = asyncio.run(pkg.loadgen.run_served_load(shards=1, **HARNESS_RUNS[run], **pkg.plane))
        assert result["value"] > 0
        views[name] = _harness_view(result)
    assert views["port"] == views["jax"]
    view = views["port"]
    assert view["samples"] == HARNESS_RUNS[run]["edits"] and view["seed"] == 0
    assert view["cpu_fallbacks"] == [0] * view["instances"] and view["broadcasting"][0]
    assert view["served_docs"][0] == view["docs"]
    if view["cross_instance"]:
        assert view["served_docs"][1] >= 4


# -- twins of the single-plane tests of tests/tpu/test_scenarios.py -----------


def _runner(pkg, schedule, **kwargs):
    reset_device_lane()
    return pkg.loadgen.ScenarioRunner(schedule, **kwargs, **pkg.plane)


def _run_view(result) -> dict:
    return {
        "metric": result["metric"],
        "scenario": result["scenario"],
        "seed": result["seed"],
        "schedule_hash": result["schedule_hash"],
        "verdict": result["verdict"],
        "targets": sorted(result["slo"]["targets"]),
        "windows": sorted(result["slo"]["windows"]),
        "phases": [(p["name"], p["measured_ops"]) for p in result["phases"]],
        "ops_total": result["extra"]["ops_total"],
        "cpu_fallbacks": [h["cpu_fallbacks"] for h in result["extra"]["plane_health"]],
    }


def test_smoke_scenario_slo_verdict_and_phase_ordering():
    views = {}
    for name, pkg in PACKAGES.items():
        from_recorder = __import__(
            f"{pkg.observability.__name__}.flight_recorder", fromlist=["get_flight_recorder"]
        ).get_flight_recorder()
        before = len(from_recorder.events("__loadgen__"))
        schedule = pkg.loadgen.get_scenario("smoke").compile(seed=7)
        result = asyncio.run(_runner(pkg, schedule, time_scale=4.0).run())
        assert result["verdict"] == ("fail" if result["slo"]["breached_targets"] else "pass")
        assert set(result["slo"]["windows"]) == {"burst", "run"}
        for phase in result["phases"]:
            assert phase["measured_ops"] > 0 and phase["latency_p99_ms"] is not None
        events = from_recorder.events("__loadgen__")[before:]
        kinds = [event["event"] for event in events]
        assert kinds[0] == "run_start" and kinds[-1] == "run_end"
        status = pkg.loadgen.get_loadgen_timeline().status()
        assert status["active"] is False
        assert status["last_run"]["schedule_hash"] == result["schedule_hash"]
        assert [p["state"] for p in status["last_run"]["phases"]] == ["done"] * 3
        views[name] = _run_view(result), [e["phase"] for e in events if e["event"] == "phase_start"]
    assert views["port"] == views["jax"]
    view, phase_starts = views["port"]
    assert view["verdict"] == "pass" and phase_starts == ["warm", "burst", "cool"]
    assert view["phases"][0][0] == "warm" and view["cpu_fallbacks"] == [0]


def test_impossible_slo_latches_fail_verdict():
    views = {}
    for name, pkg in PACKAGES.items():
        scenario = pkg.scenario.Scenario(
            name="impossible", num_docs=4, sampled=4, shards=1, capacity=256,
            shard_rows=16, docs_per_socket=4,
            phases=[pkg.scenario.PhaseSpec(
                "overload", 1500, pkg.scenarios._edit_gen(20.0),
                slo_e2e_ms=0.5, slo_objective=0.95,
            )],
        )
        result = asyncio.run(_runner(pkg, scenario.compile(seed=1)).run())
        burns = result["slo"]["max_burn_rates"]["overload:latency"]
        assert burns["burst"] >= result["slo"]["alert_burn_rate"]
        assert burns["run"] >= result["slo"]["alert_burn_rate"]
        views[name] = _run_view(result), result["slo"]["breached_targets"], result["value"]
    assert views["port"] == views["jax"]
    view, breached, value = views["port"]
    assert view["verdict"] == "fail" and value == 0.0 and "overload:latency" in breached


def test_overload_storm_sheds_and_recovers_hysteresis_clean():
    """At the schedule's own pace (the JAX test compresses it 3x): the
    ladder walks back to GREEN only while its sampler gets the loop, and
    a 400 ms recovery phase is too short for that when the suite runs in
    parallel."""
    views = {}
    for name, pkg in PACKAGES.items():
        schedule = pkg.loadgen.get_scenario("overload_storm", hold_s=0.05).compile(seed=7)
        result = asyncio.run(_runner(pkg, schedule, time_scale=1.0).run())
        storm = next(p for p in result["phases"] if p["name"] == "storm")
        overload = result["extra"]["overload"]
        path = [(t["from_rung"], t["to_rung"]) for t in overload["transitions"]]
        controller = pkg.overload.get_overload_controller()
        views[name] = {
            "verdict": result["verdict"],
            "storm_failed": storm["failed_ops"] > 0,
            "connects_rejected": overload["shed"].get("connects_rejected", 0) > 0,
            "path": path,
            "cold_after": (controller.enabled, controller.rung),
        }
    assert views["port"] == views["jax"]
    assert views["port"] == {
        "verdict": "pass", "storm_failed": True, "connects_rejected": True,
        "path": [("green", "red"), ("red", "brownout2"), ("brownout2", "brownout1"),
                 ("brownout1", "green")],
        "cold_after": (False, 0),
    }


def test_replication_lag_scenario_crosses_instances():
    views = {}
    for name, pkg in PACKAGES.items():
        schedule = pkg.loadgen.get_scenario("replication_lag").compile(seed=7)
        result = asyncio.run(_runner(pkg, schedule, time_scale=2.0).run())
        views[name] = _run_view(result), result["extra"]["mini_redis"]["dropped_partition"]
    assert views["port"] == views["jax"]
    view, _dropped = views["port"]
    assert [p for p, _n in view["phases"]] == ["healthy", "lagged", "recovered"]
    assert view["cpu_fallbacks"] == [0, 0]


def test_partition_heal_scenario_converges_byte_identically():
    """The port on its own: the JAX package's run of this scenario fails
    alone on the reference tree (its partition dropped no publish in two
    of three runs, and one breached healthy:latency; ROADMAP.md Queue C),
    so the twin holds the port to the reference test's assertions rather
    than to the reference's result."""
    schedule = port_loadgen.get_scenario("partition_heal").compile(seed=7)
    result = asyncio.run(_runner(PACKAGES["port"], schedule, time_scale=3.0).run())
    assert result["verdict"] == "pass", result["slo"]["breached_targets"]
    convergence = result["extra"]["convergence"]
    assert convergence["converged"] is True and convergence["diverged"] == []
    assert convergence["docs_checked"] == schedule.population["sampled"]
    assert result["extra"]["mini_redis"]["dropped_partition"] > 0
    healed = next(p for p in result["phases"] if p["name"] == "healed")
    assert healed["measured_ops"] > 0 and healed["failed_ops"] == 0
    partitioned = next(p for p in result["phases"] if p["name"] == "partitioned")
    assert partitioned["measured_ops"] == 0


# -- /debug/loadgen -----------------------------------------------------------

_CLOCK_KEYS = {"ts", "started_ts", "started_utc", "ended_ts", "started_s", "ended_s",
               "elapsed_s", "generated_utc", "node_id"}


def _strip_clock(value):
    if isinstance(value, dict):
        return {k: _strip_clock(v) for k, v in value.items() if k not in _CLOCK_KEYS}
    if isinstance(value, list):
        return [_strip_clock(v) for v in value]
    return value


async def _debug_loadgen(pkg) -> tuple:
    """Drive the package's process-global timeline through a finished run
    and a live one, then GET /debug/loadgen through its Metrics."""
    from types import SimpleNamespace

    timeline = pkg.loadgen.get_loadgen_timeline()
    timeline.clear()
    try:
        phases = [{"name": "warm", "planned_ms": 800}, {"name": "burst", "planned_ms": 800}]
        timeline.begin_run("smoke", 7, "abc", phases, time_scale=4.0, ops_total=3)
        timeline.phase_start("warm")
        timeline.op_done("warm", "edit", True, latency_ms=1.25)
        timeline.op_done("warm", "edit", False)
        timeline.note_breach("warm", "warm:latency")
        timeline.phase_end("warm", latency_p50_ms=1.25, latency_p99_ms=1.25)
        timeline.end_run("fail")
        timeline.begin_run("smoke", 8, "def", phases, time_scale=1.0, ops_total=1)
        timeline.phase_start("burst")
        metrics = pkg.observability.Metrics()
        request = SimpleNamespace(rel_url=SimpleNamespace(path="/debug/loadgen", query={}))
        try:
            await metrics.on_request(pkg.types.Payload(request=request))
        except Exception as served:
            response = served.response
        return response.status, json.loads(response.body.decode("utf-8"))
    finally:
        timeline.clear()


def test_debug_loadgen_is_served_as_by_the_jax_package():
    seen = {name: asyncio.run(_debug_loadgen(pkg)) for name, pkg in PACKAGES.items()}
    status, body = seen["port"]
    assert status == seen["jax"][0] == 200
    assert {"active", "run", "last_run", "events", "generated_utc", "role", "node_id"} <= set(body)
    assert set(body) == set(seen["jax"][1])
    assert _strip_clock(body) == _strip_clock(seen["jax"][1])
    assert body["active"] is True and body["last_run"]["verdict"] == "fail"


# -- the command line ---------------------------------------------------------


def _loadgen_cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "hocuspocus_tpu_torch.loadgen", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
    )


def test_loadgen_cli_runs_smoke_on_the_cpu_when_asked_and_raises_without_cuda(tmp_path):
    proc = _loadgen_cli("--scenario", "smoke", "--seed", "7", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    artifact = json.loads(proc.stdout.strip().splitlines()[-1])
    assert artifact["verdict"] == "pass"
    assert artifact["schedule_hash"] == jax_loadgen.get_scenario("smoke").compile(7).schedule_hash
    # the card by default: without CUDA the run errors (exit code 2)
    proc = _loadgen_cli("--scenario", "smoke", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2
    assert "needs a CUDA device" in json.loads(proc.stdout.strip().splitlines()[-1])["error"]
    # a sharded scenario names its item; --record compiles without running
    proc = _loadgen_cli("--scenario", "diurnal", "--device", "cpu")
    assert proc.returncode == 2 and "Queue A item 7" in proc.stdout
    recorded = tmp_path / "diurnal.schedule.json"
    proc = _loadgen_cli("--scenario", "diurnal", "--record", str(recorded))
    assert proc.returncode == 0
    assert recorded.read_text() == jax_loadgen.get_scenario("diurnal").compile(0).to_json()
