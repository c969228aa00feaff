"""chip_smoke.py's supervised and compaction phases, rehearsed on the CPU.

The phases run on the card at 1,024 docs; here the same functions run at
a few docs on the CPU (`device="cpu"`), so their own checks and numbers
are exercised before any card run: the supervised deployment reaches
READY, evicts every doc and hydrates each back in the catch-up storm; the
compaction stream retires every row and compact-and-replay brings each
back (or, on the unit arena, declines where the rebuild would not
decode), card-side plane and twin equal element for element.
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
        assert out["wal"]["records"] >= 8 and out["wal"]["bytes_on_disk"] > 0
        assert out["wal_stats"]["appended_records"] >= out["edits_sent"] >= 8
        assert quiet["wal_appended_records"] <= joins["wal_appended_records"]
    else:
        assert out["wal"] is None and out["wal_checkpoints"] is None
        assert quiet["wal_appended_records"] is None and quiet["series"] > 0
    assert out["profiler_stats"]["samples"] > 0
    for window in ("traffic", "storm_and_joins"):
        profile = out["profiles"][window]
        assert profile["flush_N"]["samples"] > 0 and profile["gc2"]["n"] >= 0
        assert all(0 < row["share"] <= 1 for row in profile["flush_N"]["top"])
    if arena == "unit":
        # on the CPU the capture records host ops only
        assert out["device_profile"]["activities"] == ["CPU"] and out["device_profile"]["kernels"] == []
        assert out["device_profile"]["device_events"] == [0]
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
