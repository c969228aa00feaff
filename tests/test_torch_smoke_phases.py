"""chip_smoke.py's supervised, compaction, cluster, edge, per-device
cells, fleet autoscaler, Tiptap, CLI and loadgen phases, rehearsed on the CPU.

The phases run on the card at 1,024 docs; here the same functions run at
a few docs on the CPU (`device="cpu"`), so their own checks and numbers
are exercised before any card run: the supervised deployment reaches
READY, evicts every doc and hydrates each back in the catch-up storm; the
compaction stream retires every row and compact-and-replay brings each
back (or, on the unit arena, declines where the rebuild would not
decode), card-side plane and twin equal element for element; the CLI
in a process of its own serves, drains and replays its WAL; the
scenario runner's acknowledged edits are all observed across instances.
"""

import asyncio
import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arena,durable", [("unit", True), ("rle", True), ("unit", False)])
def test_supervised_server_phase_on_the_cpu(arena, durable):
    smoke = _smoke()
    _ext, out = asyncio.run(
        smoke.run_supervised_server(
            np.random.default_rng(7), arena, 8, 1024, 3, 1, evict_idle_secs=0.5, device="cpu",
            device_profile_secs=0.2 if arena == "unit" else None, durable=durable,
        )
    )
    assert out["supervisor"]["state"] == "ready"
    assert out["evicted"] == 8 and out["storm_hydrated"] >= 8
    assert out["storm_rounds"] >= 1 and max(out["storm_round_docs"]) <= 64
    assert out["join_wave"]["n"] == 8
    assert out["cpu_fallbacks_by_cause"]["other"] == 0
    assert not out["health_degraded"] and out["canary_max_abs_err"] == 0
    # the CLI's --metrics --wal-dir deployment: every doc checkpointed at
    # its eviction and replayed from the WAL to its served state (the
    # phase checks each), both scrapes held to the books; without the WAL
    # (the A/B's third side) no WAL series is scraped
    quiet, joins = out["scrapes"]["quiet"], out["scrapes"]["joins"]
    if durable:
        assert out["wal_checkpoints"] == 8 and out["wal"]["docs"] == 8
        # the log a crash would leave before the teardown rebuilds every doc too
        assert out["wal_acked"]["docs"] == 8 and out["wal_acked"]["records"] >= 8
        assert out["wal"]["records"] >= 8 and out["wal"]["bytes_on_disk"] > 0
        assert out["wal_stats"]["appended_records"] >= out["edits_sent"] >= 8
        assert quiet["wal_appended_records"] <= joins["wal_appended_records"]
    else:
        assert out["wal"] is None and out["wal_checkpoints"] is None and out["wal_acked"] is None
        assert quiet["wal_appended_records"] is None and quiet["series"] > 0
    assert out["profiler_stats"]["samples"] > 0
    for window in ("traffic", "storm_and_joins"):
        profile = out["profiles"][window]
        assert profile["flush_N"]["samples"] > 0 and profile["gc2"]["n"] >= 0
        assert all(0 < row["share"] <= 1 for row in profile["flush_N"]["top"])
    if arena == "unit":
        # on the CPU the capture records host ops only
        assert out["device_profile"]["activities"] == ["CPU"] and out["device_profile"]["kernels"] == []
        assert out["device_profile"]["device_events"] == 0
        [attempt] = out["device_profile"]["attempts"]  # one capture on the CPU
        assert attempt["device_events"] == 0 and not attempt["names_kernel"]
        assert not attempt["trace_file_names_kernel"] and attempt["probe_launches"] == 0
        began, ended = attempt["probe_s"]  # a quarter of the 0.2 s window in
        assert 0.04 < began <= ended
    else:
        assert out["device_profile"] is None


def test_prometheus_parser_refuses_what_is_not_exposition_text():
    smoke = _smoke()
    text = '# HELP a x\n# TYPE a counter\na{kind="compile",site="s"} 2\nb 1.5\n'
    assert smoke.parse_prometheus(text, "t") == {
        ("a", (("kind", "compile"), ("site", "s"))): 2.0,
        ("b", ()): 1.5,
    }
    with pytest.raises(smoke.SmokeFailure):
        smoke.parse_prometheus("a b c\n", "t")
    with pytest.raises(smoke.SmokeFailure):
        smoke.parse_prometheus("a 1\na 2\n", "t")


def test_profile_tops_splits_threads_and_shares():
    smoke = _smoke()
    collapsed = "MainThread;a;b 3\nMainThread;a;c 1\nflush_N;w 4\nother;x 9"
    tops = smoke.profile_tops(collapsed)
    assert tops["MainThread"]["samples"] == 4
    assert tops["MainThread"]["top"][0] == {"share": 0.75, "samples": 3, "stack": "MainThread;a;b"}
    assert tops["flush_N"]["top"] == [{"share": 1.0, "samples": 4, "stack": "flush_N;w"}]


@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_compact_plane_phase_on_the_cpu(arena):
    smoke = _smoke()
    twin = smoke.COMPACT_TWINS[arena]
    out = asyncio.run(
        smoke.run_compact_plane(np.random.default_rng(3), arena, 4, 2048, device="cpu", twin=twin)
    )
    # a unit row whose rebuild would not decode is declined and stays retired
    declined = out["declined_undecodable"]
    assert declined == 0 or arena == "unit"
    assert out["docs_retired_at_least_once"] == 4 and out["retired_now"] == declined
    assert out["compactions"] == out["recycles"] == 4 - declined
    assert out["max_abs_err"] == 0
    assert out["arena_checks"] >= out["rounds"] + (out["compactions"] > 0)
    assert out["compact_launches"] >= 4 - declined and out["compact_bound_by"] == "bytes"


def test_compact_bound_reads_and_writes_each_routed_row_once():
    smoke = _smoke()
    from hocuspocus_tpu_torch.tpu import MergePlane

    for arena, per_lane, scalars in (("unit", 17, 5), ("rle", 21, 9)):
        plane = MergePlane(num_docs=4, capacity=256, arena=arena, device="cpu")
        ms, by, work = smoke.compact_bound(plane, 3)
        assert work["bytes"] == 2 * 3 * (per_lane * 256 + scalars) + 8 * 3
        assert by == "bytes" and ms == work["bytes"] / smoke.HBM_BYTES_PER_S * 1e3


def test_cluster_server_phase_on_the_cpu():
    """BASELINE config 4's two-instance Redis topology at 8 docs: every doc
    settles off the text lane on both instances, converges, is served by
    both planes with no CPU fallback, and anti-entropy stays in its rate."""
    smoke = _smoke()
    out = asyncio.run(smoke.run_cluster_server(np.random.default_rng(7), 8, 1024, device="cpu"))
    assert out["settle_lane_docs"] == {"a": 0, "b": 0}
    assert out["served_docs"] == {"a": 8, "b": 8}
    for side in ("a", "b"):
        counters = out["counters"][side]
        assert counters["cpu_fallbacks"] == 0 and counters["docs_retired_unsupported"] == 0
        assert counters["plane_broadcasts"] > 0
        assert out["anti_entropy"]["max_per_doc"][side] <= out["anti_entropy"]["limit_per_doc"]
    assert sum(out["edits"].values()) == 8 * 4 * smoke.CLUSTER_ROUNDS
    assert out["edit_observe_cross"]["n"] == out["edit_observe_same"]["n"] == 8 * 4 * smoke.CLUSTER_ROUNDS
    assert out["join_waves"][0]["n"] == 8 and out["join_waves"][0]["sync_serves"] >= 8
    assert out["replication"]["a"]["update_frames_published"] > 0
    assert out["replication"]["b"]["frames_received"] > 0
    # on the CPU the plain version integrates; only the card's kernel counts
    assert out["integrate_launches"] == {
        "integrate_op_slots_fast": 0, "integrate_op_slots_sparse_fast": 0,
    }


def test_edge_server_phase_on_the_cpu():
    """The edge phase at 16 docs on CPU planes: every reader converges to
    its writer through the other edge in every round, a hot doc's
    audience grows a follower bootstrapped through the owner's
    replica_snapshot, the owner drains under traffic and every doc
    re-establishes on the survivor, whose served bytes rebuild each one;
    no client sees a disconnect, nothing overflows, nothing falls back."""
    smoke = _smoke()
    out = asyncio.run(
        smoke.run_edge_server(np.random.default_rng(7), 16, 1024, device="cpu", rows=64,
                              hot_readers=16, watermark=4)
    )
    assert out["edit_observe_across_edges"]["n"] == 3 * 16
    assert out["join_synced_writers"]["n"] == out["join_synced_readers"]["n"] == 16
    hot = out["hot_doc"]
    # the owner's plane served the bootstrap; nothing fell back
    assert hot["replica_serves"][hot["owner"]]["snapshot"] == 1
    assert hot["replica_serves"][hot["follower"]] == {"snapshot": 0, "catchup": 0}
    assert hot["cpu_fallbacks"] == {hot["owner"]: 0, hot["follower"]: 0}
    assert hot["owner_replicas"]["bootstraps"] >= 1 and hot["follower_replicas"]["ticks_in"] >= 1
    assert hot["edit_observe"]["n"] == 16
    assert out["drain"]["cell"] == hot["owner"] and out["survivor"] == hot["follower"]
    assert out["drain"]["docs"] >= 1 and out["rebuilt"] == 16
    assert out["served_docs"][out["survivor"]] == 16
    assert not out["client_closes"]
    for edge, counters in out["gateways"].items():
        assert counters["relay_overflows"] == 0 and counters["handoffs"] >= 1, (edge, counters)
    for cell, counters in out["counters"].items():
        assert counters["cpu_fallbacks"] == 0 and out["ops_integrated"][cell] > 0, cell
    assert out["redis"]["slow_disconnects"] == out["redis"]["dropped_slow"] == 0
    # on the CPU the plain version integrates; only the card's kernel counts
    assert out["cell_launches"] == {cell: 0 for cell in out["counters"]}
    assert out["launches_outside_flush"] == 0
    assert all(out["k1_ops"][cell] > 0 for cell in out["counters"]), out["k1_ops"]


def test_multi_device_server_phase_on_the_cpu():
    """The per-device cells' phase at 32 docs on four CPU cells, through
    the phase's own gates (check_multi_device): every doc byte-identical
    across its editors, its joiner and the server after each round and
    rebuilt from its cell's served bytes; K1 ops on every cell, every
    dispatch in its cell's lane; docs migrated in the skew round; the
    late cell's breaker opened and closed alone, its docs back on it;
    every CPU fallback the late cell's; the /metrics gauges equal to the
    books. On the CPU the plain version integrates: no launch counted."""
    smoke = _smoke()
    out = asyncio.run(
        smoke.run_multi_device_server(np.random.default_rng(7), 32, 4096, device="cpu", rows=64, chunk=16)
    )
    assert smoke.check_multi_device(out, 32, smoke.MULTI_CUTS, on_card=False) == 0
    assert out["join_synced_editors"]["n"] == 64 and out["join_synced_joiners"]["n"] == 32
    assert set(out["edit_observe"]) == {"round 1", "skew", "late cell", "last round"}
    assert out["migrations"]["in_skew_round"] >= 1 and out["migrations"]["seconds"]["n"] >= 1
    late = out["late_cell"]
    assert late["docs"] > 0 and late["placed_docs_served"] > 0 and late["degrade_seconds"] > 0
    assert out["cpu_fallbacks"]["late_cell"] >= late["docs"]
    assert out["cpu_fallbacks"]["migration_snapshots"] == 0 and not out["cpu_fallbacks"].get("mega_capacity")
    assert out["rebuilt"] == 32 and sum(out["served_by_cell"].values()) == 32
    assert out["phase_offsets_ms"] == [0.0, 1.25, 2.5, 3.75]
    assert out["cell_launches"] == {str(i): 0 for i in range(4)} and out["launches_outside_flush"] == 0


def test_fleet_server_phase_on_the_cpu():
    """The fleet autoscaler's phase at 32 docs on four CPU cells (64 rows
    each: the full phase's occupancy of a quarter on two cells), the day's
    rates, the fresh sessions and the work target scaled down, the
    controller's tick loop running from listen, through the phase's own
    gates (check_fleet): two warm spares parked at boot with no doc placed
    on them and no parked cell holding a doc, a scale-up in ramp_up or
    peak, a scale-down by night that migrated docs under the edits and
    whose cell ends parked, empty, its lane admitting only canaries, no
    decision off GREEN, K1 ops on every cell active in the peak, every doc
    (the fresh sessions' too) converged after each phase and rebuilt from
    its cell, no fallback outside a migration, /debug/fleet and the
    autoscale families equal to the controller's status. On the CPU the
    plain version integrates: no launch counted."""
    smoke = _smoke()
    out = asyncio.run(smoke.run_fleet_server(
        np.random.default_rng(7), 32, 1024, device="cpu", rows=64, chunk=16, peak_rate=128.0,
        work_target=150.0, phase_s=4.0, night_max_s=30.0, fresh_rate=2.0,
    ))
    assert smoke.check_fleet(out, 32, smoke.FLEET_CUTS, on_card=False) == 0
    assert [p["phase"] for p in out["phases"]] == [name for name, _share in smoke.FLEET_DIURNAL]
    opened = sum(p["docs_opened"] for p in out["phases"])
    assert opened > 0 and out["docs_total"] == 32 + opened
    assert out["join_synced_editors"]["n"] == 64 and out["join_synced_fresh"]["n"] == 2 * opened
    assert out["join_synced_joiners"]["n"] == out["docs_total"]
    assert set(out["edit_observe"]) == {name for name, _share in smoke.FLEET_DIURNAL}
    assert out["timeline"][0]["action"] == "boot" and out["timeline"][0]["active"] == [0, 1]
    assert out["footprint_ratio"] is not None and out["footprint_ratio"] < 1.0
    assert out["cell_launches"] == {str(i): 0 for i in range(4)} and out["launches_outside_flush"] == 0


def test_tiptap_server_phase_on_the_cpu(monkeypatch):
    """BASELINE configs 3 and 1 at 4 docs: every doc loads the receiver's
    Tiptap JSON through the webhook, readers follow the bursts, History
    restores its checkpoints, the change payloads carry the served docs,
    and every doc reloads from SQLite to the same served bytes."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "TIPTAP_CHECKPOINTS", 4)
    out = asyncio.run(
        smoke.run_tiptap_server(np.random.default_rng(7), 4, 4096, device="cpu", webhook_debounce_ms=200)
    )
    assert out["served_docs"] == 4
    assert out["counters"]["cpu_fallbacks"] == 0 and out["counters"]["docs_retired_unsupported"] == 0
    assert out["webhook"]["bad_signatures"] == 0 and out["webhook"]["posts"]["create"] == 8
    assert out["webhook"]["posts"]["change"] >= 4
    assert out["history"] == {"checkpoints": 4, "restores": smoke.TIPTAP_RESTORES}
    assert out["sqlite"]["rows"] == 4 and out["sqlite"]["stores"] >= 4
    assert out["edit_observe_burst"]["n"] == 4 * smoke.TIPTAP_ROUNDS
    assert out["load_synced_webhook"]["n"] == out["reload_synced_sqlite"]["n"] == 4
    assert out["logger_lines"]["Loaded"] == 8


def test_cli_server_phase_on_the_cpu():
    """The CLI's phase at 8 docs, its plane on the CPU and narrowed: the
    CLI process serves every doc byte-identically to its two editors and
    a joiner, /metrics counts every edit integrated, SIGTERM drains with
    exit code 0 inside --drain-timeout-secs, and a second process on the
    same WAL serves every doc back byte for byte (the phase checks each)."""
    smoke = _smoke()
    out = asyncio.run(
        smoke.run_cli_server(
            np.random.default_rng(7), 8, device="cpu", profile_secs=0.3,
            extra_args=("--tpu-docs", "16", "--tpu-capacity", "512"),
        )
    )
    assert out["edits"] == out["ops_integrated"] == 16
    assert out["edit_observe"]["n"] == out["inserts"] == 16
    assert out["join_synced"]["n"] == 8 and out["replay"]["docs"] == 8
    assert out["drain_seconds"] <= smoke.CLI_DRAIN_TIMEOUT_S
    assert out["k1_launches"]["first"] > 0 and out["plane_counters"]["cpu_fallbacks"] == 0
    gc = out["server_profile"]["gc"]
    assert set(gc) == {"gen0", "gen1", "gen2"} and out["server_gc2_share"] == gc["gen2"]["share"]
    assert out["server_profile"]["device_events"] == 0  # a CPU plane launches no kernel


def test_loadgen_phase_on_the_cpu():
    """The scenario runner's phase at 8 docs on the CPU: smoke passes, and
    every acknowledged edit of replication_lag is observed on the other
    instance (the runner's added check), on every doc: the 6 sampled ones'
    readers and a fresh reader on the other instance for the 2 others.
    The edge scenarios at their defaults pass, writers and readers
    converged through the two edges, and edge_handoff's drain hands off;
    multi_device_storm passes on eight CPU cells and migrates docs."""
    smoke = _smoke()
    out = asyncio.run(smoke.run_loadgen(8, device="cpu"))
    assert out["smoke"]["verdict"] == "pass" and out["smoke"]["acked"]["writers"] == 6
    assert out["smoke"]["acked"]["docs_observed"] == 4  # one instance: its 4 sampled readers
    lag = out["replication_lag"]
    assert lag["docs"] == 8 and lag["acked"] == {"writers": 8, "docs_observed": 8,
                                                 "fresh_readers": 2,
                                                 "wait_s": lag["acked"]["wait_s"]}
    assert len(lag["k1_ops"]) == len(lag["append_ops"]) == 2 and sum(lag["append_ops"]) > 0
    assert [phase["name"] for phase in lag["phases"]] == ["healthy", "lagged", "recovered"]
    assert lag["cpu_fallbacks"] == [0, 0] and lag["mini_redis"]["delivered"] > 0
    for name in smoke.LOADGEN_EDGE_SCENARIOS:
        edge = out[name]
        assert edge["verdict"] == "pass" and edge["convergence"]["converged"], edge
        assert edge["acked"]["docs_observed"] == edge["docs"], edge
        assert edge["cpu_fallbacks"] == [0, 0], edge
        assert edge["k1_launches_are"].startswith("the cells' warm grid") == (not any(edge["k1_ops"])), edge
        assert not any(c["relay_overflows"] for c in edge["edge"].values()), edge
    assert sum(c["handoffs"] for c in out["edge_handoff"]["edge"].values()) >= 1
    # per-device cells: 2 instances of 4, docs migrated, every doc observed
    storm = out["multi_device_storm"]
    assert storm["verdict"] == "pass" and storm["convergence"]["converged"], storm
    assert storm["docs_migrated"] >= 1 and storm["acked"]["docs_observed"] == storm["docs"] == 24
    assert [m["devices"] for m in storm["multi_device"].values()] == [4, 4]
    # three cell planes behind the edges, reported by the phase
    audience = out["mega_audience"]
    assert audience["verdict"] == "pass" and audience["convergence"]["converged"], audience
    # the fleet controller over four cells: parked back down by night
    diurnal = out["diurnal_autoscale"]
    assert diurnal["verdict"] == "pass" and diurnal["convergence"]["converged"], diurnal
    assert diurnal["autoscale"]["steady_footprint_ratio"] <= diurnal["autoscale"]["max_ratio"] == 0.6
    assert diurnal["acked"]["docs_observed"] == 8 and diurnal["convergence"]["docs_checked"] == 24
    assert any(d["action"] == "scale_down" for d in diurnal["autoscale"]["decisions"]), diurnal


def test_loadgen_phase_holds_the_jax_packages_schedule_hashes():
    from hocuspocus_tpu.loadgen import get_scenario

    smoke = _smoke()
    for (name, docs), expected in smoke.LOADGEN_HASHES.items():
        scenario = get_scenario(name) if docs is None else get_scenario(name, num_docs=docs)
        assert scenario.compile(smoke.LOADGEN_SEED).schedule_hash == expected, name


def _full_run_line(capsys) -> dict:
    import json

    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("supervised_server_full: ")]
    assert len(lines) == 1
    return json.loads(lines[0].split(": ", 1)[1])


@pytest.mark.parametrize("outcome", ["passed", "failed", "cut"])
def test_the_reported_full_supervised_run_never_fails_the_smoke(monkeypatch, capsys, outcome):
    """supervised_server_full runs the unit supervised phase at 1,024
    driven docs in a child process and reports how it ended, whatever
    that was: here the child is stood in for by its output (a pass, a
    breaker trip, a run cut at the budget's end), and the phase returns
    each time with the child's numbers on its line."""
    import json
    import subprocess
    import time

    smoke = _smoke()
    child_line = {"seconds": 120.5, "supervisor": {"state": "ready"}, "wal_acked": {"docs": 1024},
                  "wal": {"docs": 1024}, "canary_latency": {"n": 20}}
    stdout = "native_build: {}\nsupervised_server: " + json.dumps(child_line) + "\n"
    calls = []

    def run(command, **kwargs):
        calls.append((command, kwargs))
        if outcome == "cut":
            raise subprocess.TimeoutExpired(command, kwargs["timeout"], output=stdout)
        code = 0 if outcome == "passed" else 1
        stderr = "" if code == 0 else "chip_smoke: FAILED: supervised_server: the breaker tripped\n"
        return subprocess.CompletedProcess(command, code, stdout, stderr)

    monkeypatch.setattr(smoke.subprocess, "run", run)
    smoke.phase_supervised_full(7, time.perf_counter())
    line = _full_run_line(capsys)
    [(command, kwargs)] = calls
    assert command[-2:] == ["--supervised-docs", "1024"] and "--seed" in command
    assert 0 < kwargs["timeout"] <= smoke.SMOKE_CLOCK_S
    assert line["ran"] and line["driven"] == 1024 and line["ok"] == (outcome == "passed")
    assert line["line"]["wal_acked"] == {"docs": 1024} and line["line"]["supervisor"] == {"state": "ready"}
    if outcome == "passed":
        assert line["exit_code"] == 0 and line["failure"] is None
    elif outcome == "failed":
        assert line["exit_code"] == 1 and "the breaker tripped" in line["failure"]
    else:
        assert line["exit_code"] is None and line["failure"].startswith("cut at")


def test_the_reported_full_supervised_run_waits_for_the_budget(monkeypatch, capsys):
    """With less than SUPERVISED_FULL_MIN_S of the smoke's budget left the
    full run does not start, and its line says so."""
    import time

    smoke = _smoke()
    monkeypatch.setattr(smoke.subprocess, "run", lambda *a, **k: pytest.fail("the run started"))
    smoke.phase_supervised_full(7, time.perf_counter() - smoke.SMOKE_CLOCK_S + 10)
    line = _full_run_line(capsys)
    assert not line["ran"] and "needed" in line["reason"]
