"""chip_smoke.py's kernel bound counts the operations each op kind makes
in the integrate kernel's passes, over the units its row holds."""

import importlib.util
from pathlib import Path

import numpy as np
import torch

from hocuspocus_tpu_torch.tpu.kernels import OpBatch

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_integrate_bound_counts_each_op_kind_over_occupied_units():
    smoke = _smoke()
    # one row holding 4 units: an insert of 2 that applies, a delete, an
    # insert dropped for a missing origin, and a noop
    kind = torch.tensor([[1], [2], [1], [0]], dtype=torch.int32)
    run = torch.tensor([[2], [1], [3], [0]], dtype=torch.int32)
    zeros = torch.zeros_like(kind)
    ops = OpBatch(kind, zeros, zeros, run, zeros, zeros, zeros, zeros)
    lengths = torch.tensor([[4], [6], [6], [6]], dtype=torch.int32)
    _ms, by, need = smoke.integrate_bound(ops, lengths, torch.tensor([6], dtype=torch.int32))
    insert = smoke.OPS_ORIGINS + smoke.OPS_CONFLICT + smoke.OPS_SKIPPED + smoke.OPS_BUMP
    assert need["int32_ops"] == (
        4 * insert + 2 * smoke.OPS_FILL + 6 * smoke.OPS_DELETE + 6 * smoke.OPS_ORIGINS
    )
    assert need["bytes"] == 17 * (4 + 6) + 8 * 4 * 4 + 4 + 10
    assert by in ("bytes", "operations")


def test_random_ops_stream_is_causal():
    """Inserts take each client's next clock; deletes stay inside the ids
    the client has already made."""
    smoke = _smoke()
    rng = np.random.default_rng(5)
    next_clock = np.zeros((2, 8), np.int64)
    made = np.zeros((2, 8), np.int64)
    kind, client, clock, run, *_ = smoke.random_ops(rng, next_clock, 12)
    for k in range(12):
        for d in range(8):
            ci = int(np.flatnonzero(smoke.CLIENTS == client[k, d])[0])
            if kind[k, d] == 1:
                assert clock[k, d] == made[ci, d]
                made[ci, d] += run[k, d]
            elif kind[k, d] == 2:
                assert 0 <= clock[k, d] and clock[k, d] + run[k, d] <= made[ci, d]
    np.testing.assert_array_equal(made, next_clock)


def test_rle_bound_counts_each_op_kind_over_occupied_entries():
    smoke = _smoke()
    # one row of 16 entries holding 4: an insert that adds 2 entries, a
    # delete that fits and splits twice, an insert dropped for a missing
    # origin, a noop, and a delete that does not fit (15 + 2 > 16)
    kind = torch.tensor([[1], [2], [1], [0], [2]], dtype=torch.int32)
    zeros = torch.zeros_like(kind)
    ops = OpBatch(kind, zeros, zeros, zeros, zeros, zeros, zeros, zeros)
    runs = torch.tensor([[4], [6], [8], [8], [15]], dtype=torch.int32)
    _ms, by, need = smoke.rle_bound(ops, runs, torch.tensor([15], dtype=torch.int32), 16)
    assert need["int32_ops"] == (
        4 * smoke.OPS_RLE_INSERT
        + 6 * 2 * smoke.OPS_RLE_BOUND
        + 8 * smoke.OPS_RLE_COVER
        + 8 * smoke.OPS_RLE_ORIGINS
    )
    assert need["bytes"] == 21 * (4 + 15) + 8 * 4 * 5 + 4 + 18
    assert by in ("bytes", "operations")
