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


def test_supervised_server_phase_on_the_cpu():
    smoke = _smoke()
    _ext, out = asyncio.run(
        smoke.run_supervised_server(
            np.random.default_rng(7), "rle", 8, 1024, 3, 1, evict_idle_secs=0.5, device="cpu"
        )
    )
    assert out["supervisor"]["state"] == "ready"
    assert out["evicted"] == 8 and out["storm_hydrated"] >= 8
    assert out["storm_rounds"] >= 1 and max(out["storm_round_docs"]) <= 64
    assert out["join_wave"]["n"] == 8
    assert out["cpu_fallbacks_by_cause"]["other"] == 0
    assert not out["health_degraded"] and out["canary_max_abs_err"] == 0


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
