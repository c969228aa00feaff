"""The Hopper integrate kernels (K1, unit arena; K2, run-length arena)
against their plain PyTorch versions, on the card.

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
from hocuspocus_tpu_torch.tpu import kernels_rle as tr

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


# -- K2: the run-length arena ---------------------------------------------------


def assert_same_rle(gpu_state, cpu_state):
    for name, g, c in zip(tr.RleState._fields, gpu_state, cpu_state):
        assert torch.equal(g.cpu(), c), name


def padded_ops(live, width):
    fields = []
    for value, default in zip(live, (0, 0, 0, 0, 0xFFFFFFFF, 0, 0xFFFFFFFF, 0)):
        full = np.full((value.shape[0], width), default, value.dtype)
        full[:, : value.shape[1]] = value
        fields.append(full)
    return fields


@pytest.mark.cuda
@pytest.mark.parametrize("entries", [256, 12_000])  # shared-memory row, global-memory row
def test_rle_dense_kernel_matches_plain_version(cuda, entries):
    rng = np.random.default_rng(37)
    num_docs, num_slots = 48, 12
    next_clock = np.zeros((2, num_docs), np.int64)
    state_g = tr.make_empty_rle_state(num_docs, entries, cuda)
    state_c = tr.make_empty_rle_state(num_docs, entries, CPU)
    before = ti.integrate_op_slots_rle_fast.launches
    for _ in range(4):
        fields = random_ops(rng, next_clock, num_slots)
        _, count_g = ti.integrate_op_slots_rle_fast(state_g, tk.ops_from_numpy(fields, cuda))
        _, count_c = ti.integrate_op_slots_rle_fast(state_c, tk.ops_from_numpy(fields, CPU))
        assert int(count_g) == int(count_c)
    torch.cuda.synchronize()
    assert ti.integrate_op_slots_rle_fast.launches - before == 4
    assert int(state_c.num_runs.max()) > 32  # splits happened
    assert_same_rle(state_g, state_c)


@pytest.mark.cuda
def test_rle_kernel_overflows_at_tight_capacity_like_plain_version(cuda):
    rng = np.random.default_rng(2)
    num_docs, entries, num_slots = 32, 16, 8
    next_clock = np.zeros((2, num_docs), np.int64)
    state_g = tr.make_empty_rle_state(num_docs, entries, cuda)
    state_c = tr.make_empty_rle_state(num_docs, entries, CPU)
    for _ in range(3):
        fields = random_ops(rng, next_clock, num_slots)
        ti.integrate_op_slots_rle_fast(state_g, tk.ops_from_numpy(fields, cuda))
        ti.integrate_op_slots_rle_fast(state_c, tk.ops_from_numpy(fields, CPU))
    torch.cuda.synchronize()
    assert bool(state_c.overflow.any())
    assert_same_rle(state_g, state_c)


@pytest.mark.cuda
def test_rle_sparse_kernel_routes_rows_and_skips_padding(cuda):
    rng = np.random.default_rng(6)
    num_docs, entries, busy, pad, num_slots = 64, 512, 20, 12, 8
    cols = np.sort(rng.choice(num_docs, size=busy, replace=False)).astype(np.int32)
    next_clock = np.zeros((2, busy), np.int64)
    state_g = tr.make_empty_rle_state(num_docs, entries, cuda)
    state_c = tr.make_empty_rle_state(num_docs, entries, CPU)
    slots = np.full(busy + pad, num_docs, np.int32)
    slots[:busy] = cols
    slots[-1] = -1  # a negative slot is padding too
    before = ti.integrate_op_slots_rle_sparse_fast.launches
    for _ in range(3):
        fields = padded_ops(random_ops(rng, next_clock, num_slots), busy + pad)
        ti.integrate_op_slots_rle_sparse_fast(
            state_g, tk.ops_from_numpy(fields, cuda), torch.from_numpy(slots).to(cuda)
        )
        ti.integrate_op_slots_rle_sparse_fast(
            state_c, tk.ops_from_numpy(fields, CPU), torch.from_numpy(slots)
        )
    torch.cuda.synchronize()
    assert ti.integrate_op_slots_rle_sparse_fast.launches - before == 3
    assert_same_rle(state_g, state_c)
    unrouted = np.setdiff1d(np.arange(num_docs), cols)
    assert int(state_g.num_runs[torch.from_numpy(unrouted).to(cuda)].abs().sum()) == 0


@pytest.mark.cuda
def test_rle_kernel_wrapper_refuses_bad_tensors(cuda):
    state = tr.make_empty_rle_state(4, 64, cuda)
    ops = tk.ops_from_numpy(random_ops(np.random.default_rng(1), np.zeros((2, 4), np.int64), 2), cuda)
    slots = torch.arange(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="slots"):
        ti.integrate_rle_rows_cuda(state, ops, slots.long())
    with pytest.raises(ValueError, match="run_deleted"):
        ti.integrate_rle_rows_cuda(state._replace(run_deleted=state.run_deleted.int()), ops, slots)
    with pytest.raises(ValueError, match="num_runs"):
        ti.integrate_rle_rows_cuda(state._replace(num_runs=state.num_runs[:3].clone()), ops, slots)
    with pytest.raises(ValueError, match="run_len"):
        ti.integrate_rle_rows_cuda(state._replace(run_len=state.run_len.cpu()), ops, slots)
    with pytest.raises(ValueError, match="contiguous"):
        ti.integrate_rle_rows_cuda(
            state._replace(run_rank=state.run_rank.t().contiguous().t()), ops, slots
        )
    with pytest.raises(ValueError, match="contiguous"):
        bad = tk.OpBatch(*(f.t().contiguous().t() for f in ops))
        ti.integrate_rle_rows_cuda(state, bad, slots)


@pytest.mark.cuda
@pytest.mark.parametrize("entries", [64, 12_000])
def test_rle_kernel_matches_plain_version_when_ids_repeat(cuda, entries):
    """Random ops with no causal order: ids repeat, runs may be empty or
    negative, origins may be missing, unknown kinds appear. Several
    entries can then match one split, and the kernel must still extract
    the split fields as the plain version's masked sums do."""
    rng = np.random.default_rng(41)
    num_docs, num_slots = 96, 16
    pool = np.asarray([7, 0x9000_0001, 0xFFFF_FFFF], np.uint32)
    state_g = tr.make_empty_rle_state(num_docs, entries, cuda)
    state_c = tr.make_empty_rle_state(num_docs, entries, CPU)
    for _ in range(6):
        shape = (num_slots, num_docs)
        fields = (
            rng.integers(0, 4, shape).astype(np.int32),
            pool[rng.integers(0, 2, shape)],
            rng.integers(0, 24, shape).astype(np.int32),
            rng.integers(-2, 9, shape).astype(np.int32),
            pool[rng.integers(0, 3, shape)],
            rng.integers(0, 24, shape).astype(np.int32),
            pool[rng.integers(0, 3, shape)],
            rng.integers(0, 24, shape).astype(np.int32),
        )
        ti.integrate_op_slots_rle_fast(state_g, tk.ops_from_numpy(fields, cuda))
        ti.integrate_op_slots_rle_fast(state_c, tk.ops_from_numpy(fields, CPU))
    torch.cuda.synchronize()
    assert_same_rle(state_g, state_c)
