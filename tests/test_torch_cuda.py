"""The Hopper integrate kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so on a machine
without JAX they run with the suite's conftest left out:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_ops
from hocuspocus_tpu_torch.tpu import integrate as ti
from hocuspocus_tpu_torch.tpu import kernels as tk

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the integrate kernel has no CPU mode")
    return torch.device("cuda")


def assert_same(gpu_state, cpu_state):
    for name, g, c in zip(tk.DocState._fields, gpu_state, cpu_state):
        assert torch.equal(g.cpu(), c), name


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [256, 20_000])  # shared-memory row, global-memory row
def test_dense_kernel_matches_plain_version(cuda, capacity):
    rng = np.random.default_rng(31)
    num_docs, num_slots = 48, 12
    next_clock = np.zeros((2, num_docs), np.int64)
    state_g = tk.make_empty_state(num_docs, capacity, cuda)
    state_c = tk.make_empty_state(num_docs, capacity, CPU)
    before = ti.integrate_op_slots_fast.launches
    for _ in range(3):
        fields = random_ops(rng, next_clock, num_slots)
        _, count_g = ti.integrate_op_slots_fast(state_g, tk.ops_from_numpy(fields, cuda))
        _, count_c = ti.integrate_op_slots_fast(state_c, tk.ops_from_numpy(fields, CPU))
        assert int(count_g) == int(count_c)
    torch.cuda.synchronize()
    assert ti.integrate_op_slots_fast.launches - before == 3
    assert_same(state_g, state_c)


@pytest.mark.cuda
def test_sparse_kernel_routes_rows_and_skips_padding(cuda):
    rng = np.random.default_rng(5)
    num_docs, capacity, busy, pad, num_slots = 64, 512, 20, 12, 8
    cols = np.sort(rng.choice(num_docs, size=busy, replace=False)).astype(np.int32)
    next_clock = np.zeros((2, busy), np.int64)
    state_g = tk.make_empty_state(num_docs, capacity, cuda)
    state_c = tk.make_empty_state(num_docs, capacity, CPU)
    slots = np.full(busy + pad, num_docs, np.int32)
    slots[:busy] = cols
    for _ in range(3):
        live = random_ops(rng, next_clock, num_slots)
        fields = []
        for value, default in zip(live, (0, 0, 0, 0, 0xFFFFFFFF, 0, 0xFFFFFFFF, 0)):
            full = np.full((num_slots, busy + pad), default, value.dtype)
            full[:, :busy] = value
            fields.append(full)
        ti.integrate_op_slots_sparse_fast(
            state_g, tk.ops_from_numpy(fields, cuda), torch.from_numpy(slots).to(cuda)
        )
        ti.integrate_op_slots_sparse_fast(
            state_c, tk.ops_from_numpy(fields, CPU), torch.from_numpy(slots)
        )
    torch.cuda.synchronize()
    assert_same(state_g, state_c)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_tensors(cuda):
    state = tk.make_empty_state(4, 64, cuda)
    ops = tk.ops_from_numpy(random_ops(np.random.default_rng(1), np.zeros((2, 4), np.int64), 2), cuda)
    with pytest.raises(ValueError, match="slots"):
        ti.integrate_rows_cuda(state, ops, torch.arange(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        bad = tk.OpBatch(*(f.t().contiguous().t() for f in ops))
        ti.integrate_rows_cuda(state, bad, torch.arange(4, dtype=torch.int32, device=cuda))
