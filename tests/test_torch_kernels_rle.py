"""The port's run-length arena programs against the JAX package's.

Every input is made with numpy from a seed and handed to both packages;
integer state is compared exactly (tolerance 0). The K2 dispatchers take
their plain path for CPU tensors and are held against the Pallas kernel
in interpret mode, as the JAX package's own tests run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hocuspocus_tpu.tpu import kernels_rle as jr
from hocuspocus_tpu.tpu.kernels import KIND_DELETE, KIND_INSERT, NONE_CLIENT
from hocuspocus_tpu.tpu.pallas_kernels_rle import (
    _integrate_pallas_rle,
    _integrate_sparse_pallas_rle,
)
from hocuspocus_tpu_torch.tpu import integrate as ti
from hocuspocus_tpu_torch.tpu import kernels as tk
from hocuspocus_tpu_torch.tpu import kernels_rle as tr
from tests.test_torch_kernels import CLIENTS, jax_ops, random_stream

CPU = torch.device("cpu")
PAD_DEFAULTS = (0, 0, 0, 0, NONE_CLIENT, 0, NONE_CLIENT, 0)


def assert_rle_equal(jax_state, torch_state):
    ours = tr.rle_state_to_numpy(torch_state)
    for name, a, b in zip(jr.RleState._fields, jax_state, ours):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def seeded_rle(rng, num_docs, entries, rounds=2, num_slots=6):
    """The same random history integrated by both packages."""
    next_clock = np.zeros((len(CLIENTS), num_docs), np.int64)
    state_j = jr.make_empty_rle_state(num_docs, entries)
    state_t = tr.make_empty_rle_state(num_docs, entries, CPU)
    for _ in range(rounds):
        fields = random_stream(rng, num_docs, num_slots, next_clock)
        state_j, _ = jr.integrate_op_slots_rle(state_j, jax_ops(fields))
        tr.integrate_op_slots_rle(state_t, tk.ops_from_numpy(fields, CPU))
    return state_j, state_t, next_clock


def padded(live, width):
    """(K, busy) op fields widened to (K, width) with noop padding."""
    out = []
    for value, default in zip(live, PAD_DEFAULTS):
        full = np.full((value.shape[0], width), default, value.dtype)
        full[:, : value.shape[1]] = value
        out.append(full)
    return out


def ops_from_rows(columns):
    """(K, D) numpy op fields from per-column lists of op dicts."""
    num_slots = max(len(c) for c in columns)
    names = ("kind", "client", "clock", "run_len", "left_client", "left_clock",
             "right_client", "right_clock")
    fields = [
        np.full((num_slots, len(columns)), default,
                np.uint32 if name.endswith("client") else np.int32)
        for name, default in zip(names, PAD_DEFAULTS)
    ]
    for d, column in enumerate(columns):
        for k, op in enumerate(column):
            for i, name in enumerate(names):
                if name in op:
                    fields[i][k, d] = op[name]
    return fields


@pytest.mark.parametrize("seed", [1, 7])
def test_integrate_op_slots_rle_matches_jax(seed):
    rng = np.random.default_rng(seed)
    num_docs, entries, num_slots = 16, 128, 6
    next_clock = np.zeros((len(CLIENTS), num_docs), np.int64)
    state_j = jr.make_empty_rle_state(num_docs, entries)
    state_t = tr.make_empty_rle_state(num_docs, entries, CPU)
    for _ in range(4):
        fields = random_stream(rng, num_docs, num_slots, next_clock)
        state_j, count_j = jr.integrate_op_slots_rle(state_j, jax_ops(fields))
        state_t, count_t = tr.integrate_op_slots_rle(state_t, tk.ops_from_numpy(fields, CPU))
        assert int(count_j) == int(count_t)
    assert_rle_equal(state_j, state_t)
    assert (tr.rle_state_to_numpy(state_t).run_client >= 0x8000_0000).any()
    for doc in range(num_docs):
        for a, b in zip(jr.expand_to_units(state_j, doc), tr.expand_to_units(state_t, doc)):
            np.testing.assert_array_equal(a, b)
        assert jr.delete_ranges(state_j, doc) == tr.delete_ranges(state_t, doc)


def test_integrate_op_slots_rle_sparse_with_padding_matches_jax():
    rng = np.random.default_rng(5)
    num_docs, entries, busy, width, num_slots = 24, 96, 5, 8, 6
    state_j, state_t, next_clock = seeded_rle(rng, num_docs, entries)
    for _ in range(3):
        cols = np.sort(rng.choice(num_docs, size=busy, replace=False))
        sub_clock = next_clock[:, cols].copy()
        live = random_stream(rng, busy, num_slots, sub_clock)
        next_clock[:, cols] = sub_clock
        fields = padded(live, width)
        slots = np.full((width,), num_docs, np.int32)
        slots[:busy] = cols
        state_j, count_j = jr.integrate_op_slots_rle_sparse(
            state_j, jax_ops(fields), jnp.asarray(slots)
        )
        state_t, count_t = tr.integrate_op_slots_rle_sparse(
            state_t, tk.ops_from_numpy(fields, CPU), torch.from_numpy(slots)
        )
        assert int(count_j) == int(count_t)
    assert_rle_equal(state_j, state_t)


def test_delete_split_at_tight_capacity_matches_jax():
    """A delete whose own boundary splits take the last free entries
    succeeds without sticky overflow (the verdict is taken before the
    splits move num_runs); a second mid-run delete then overflows."""
    fields = ops_from_rows(
        [
            [
                dict(kind=KIND_INSERT, client=7, clock=0, run_len=20),
                dict(kind=KIND_DELETE, client=7, clock=5, run_len=4),
                dict(kind=KIND_DELETE, client=7, clock=12, run_len=2),
            ]
        ]
    )
    state_j, _ = jr.integrate_op_slots_rle(jr.make_empty_rle_state(1, 4), jax_ops(fields))
    state_t, _ = tr.integrate_op_slots_rle(
        tr.make_empty_rle_state(1, 4, CPU), tk.ops_from_numpy(fields, CPU)
    )
    assert_rle_equal(state_j, state_t)
    assert int(state_t.num_runs[0]) == 3
    assert bool(state_t.overflow[0])
    assert tr.delete_ranges(state_t, 0) == [(7, 5, 4)]


def test_overflow_and_missing_origins_match_jax():
    """Three tail appends fit a 4-entry row; the fourth op fails both the
    capacity margin and its unknown left origin; a right origin that is
    unknown drops an insert without overflow."""
    num_docs = 3
    column = [
        dict(kind=KIND_INSERT, client=7, clock=0, run_len=8),
        dict(kind=KIND_INSERT, client=7, clock=8, run_len=8, left_client=7, left_clock=7),
        dict(kind=KIND_INSERT, client=7, clock=16, run_len=8, left_client=7, left_clock=15),
        dict(kind=KIND_INSERT, client=7, clock=99, run_len=1, left_client=12345),
    ]
    right_missing = [
        dict(kind=KIND_INSERT, client=0x9000_0001, clock=0, run_len=3),
        dict(kind=KIND_INSERT, client=7, clock=0, run_len=2, right_client=7, right_clock=40),
    ]
    fields = ops_from_rows([column, column, right_missing])
    state_j, count_j = jr.integrate_op_slots_rle(
        jr.make_empty_rle_state(num_docs, 4), jax_ops(fields)
    )
    state_t, count_t = ti.integrate_op_slots_rle_fast(
        tr.make_empty_rle_state(num_docs, 4, CPU), tk.ops_from_numpy(fields, CPU)
    )
    assert int(count_j) == int(count_t) == 10  # dropped ops still count
    assert_rle_equal(state_j, state_t)
    assert state_t.overflow.tolist() == [True, True, False]
    assert state_t.total_units.tolist() == [24, 24, 3]


def _append_both(state_j, state_t, client, clock, run_len, slots):
    state_j, count_j = jr.append_run_slots_rle_sparse(
        state_j, *map(jnp.asarray, (client, clock, run_len, slots))
    )
    state_t, count_t = tr.append_run_slots_rle_sparse(
        state_t,
        *(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) for a in (client, clock, run_len)),
        torch.from_numpy(slots),
    )
    assert int(count_j) == int(count_t)
    return state_j, state_t


def test_append_fast_path_extends_and_overflows_like_jax():
    num_docs, entries = 8, 4
    state_j = jr.make_empty_rle_state(num_docs, entries)
    state_t = tr.make_empty_rle_state(num_docs, entries, CPU)
    # column 0: one client typing one run per batch: the first batch
    # appends, every later one EXTENDS the tail entry; column 1: two
    # clients alternating, so runs need lanes until the row is full and
    # the chain dies (one run 0 extends on the way); column 2: separate
    # runs of one client, the row fills and overflows; column 3: padding
    hi = 0x9000_0001
    slots = np.asarray([1, 4, 6, num_docs], np.int32)
    client = np.asarray([[hi, 7, 7, 0], [hi, hi, 7, 0], [hi, 7, hi, 0]], np.uint32)
    run_len = np.asarray([[3, 1, 2, 0], [0, 1, 2, 0], [0, 1, 2, 0]], np.int32)
    for step in range(3):
        clock = np.asarray(
            [
                [3 * step, 2 * step, 6 * step, 0],
                [0, step, 6 * step + 30, 0],
                [0, 2 * step + 1, 6 * step + 60, 0],
            ],
            np.int32,
        )
        state_j, state_t = _append_both(state_j, state_t, client, clock, run_len, slots)
        assert_rle_equal(state_j, state_t)
    assert int(state_t.num_runs[1]) == 1  # one entry, extended twice
    assert int(state_t.total_units[1]) == 9
    assert not bool(state_t.overflow[1])
    assert bool(state_t.overflow[4]) and bool(state_t.overflow[6])
    # random chains on top of a seeded arena (no extension: fresh clients)
    rng = np.random.default_rng(11)
    state_j, state_t, _ = seeded_rle(rng, num_docs, 64, rounds=1)
    run_len = rng.integers(0, 9, size=(4, num_docs)).astype(np.int32)
    client = rng.integers(1, 2**32, size=(4, num_docs), dtype=np.uint64).astype(np.uint32)
    clock = rng.integers(0, 1000, size=(4, num_docs)).astype(np.int32)
    state_j, state_t = _append_both(
        state_j, state_t, client, clock, run_len, np.arange(num_docs, dtype=np.int32)
    )
    assert_rle_equal(state_j, state_t)


def test_tail_probe_rle_matches_jax():
    rng = np.random.default_rng(3)
    state_j, state_t, _ = seeded_rle(rng, 12, 64)
    slots = np.asarray([0, 3, 5, 11, 2, 0, 0, 0], np.int32)
    got = tr.tail_probe_rle(state_t, torch.from_numpy(slots)).numpy().view(np.uint32)
    want = np.asarray(jr.tail_probe_rle(state_j, jnp.asarray(slots)))
    np.testing.assert_array_equal(got, want)
    empty = tr.make_empty_rle_state(2, 8, CPU)
    assert tr.tail_probe_rle(empty, torch.tensor([0, 1], dtype=torch.int32)).tolist() == [0] * 4


@pytest.mark.parametrize("width", [4, 128])
def test_catchup_pack_rle_matches_jax(width):
    """width 4 is below some rows' tombstoned-entry count: those rows
    report the true count and pack only the first `width` entries."""
    rng = np.random.default_rng(9)
    num_docs = 10
    state_j, state_t, _ = seeded_rle(rng, num_docs, 160, rounds=3)
    slots = np.asarray([1, 2, 3, 9, 0, 4, 4, 4], np.int32)
    got = tr.catchup_pack_rle(state_t, torch.from_numpy(slots), width).numpy().view(np.uint32)
    want = np.asarray(jr.catchup_pack_rle(state_j, jnp.asarray(slots), width))
    np.testing.assert_array_equal(got, want)
    if width == 4:
        assert (want[: slots.size] > width).any()


def test_rle_state_round_trips_through_numpy():
    rng = np.random.default_rng(8)
    state_j, _, _ = seeded_rle(rng, 8, 64)
    as_numpy = [np.asarray(field) for field in state_j]
    state_t = tr.rle_state_from_numpy(as_numpy, CPU)
    assert state_t.run_client.dtype == torch.int32
    assert state_t.run_deleted.dtype == torch.bool
    assert torch.equal(state_t.length, state_t.total_units)
    back = tr.rle_state_to_numpy(state_t)
    for name, a, b in zip(jr.RleState._fields, as_numpy, back):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (back.run_client[back.run_len > 0] >= 0x8000_0000).any()


def test_jax_rle_state_handed_across_mid_stream_continues_identically():
    rng = np.random.default_rng(17)
    num_docs, entries, num_slots = 16, 128, 6
    next_clock = np.zeros((len(CLIENTS), num_docs), np.int64)
    state_j = jr.make_empty_rle_state(num_docs, entries)
    for _ in range(2):
        fields = random_stream(rng, num_docs, num_slots, next_clock)
        state_j, _ = jr.integrate_op_slots_rle(state_j, jax_ops(fields))
    state_t = tr.rle_state_from_numpy([np.asarray(f) for f in state_j], CPU)
    for _ in range(2):
        fields = random_stream(rng, num_docs, num_slots, next_clock)
        state_j, _ = jr.integrate_op_slots_rle(state_j, jax_ops(fields))
        state_t, _ = ti.integrate_op_slots_rle_fast(state_t, tk.ops_from_numpy(fields, CPU))
    assert_rle_equal(state_j, state_t)


def test_rle_dense_dispatcher_matches_pallas_interpret():
    rng = np.random.default_rng(21)
    num_docs, entries, num_slots = 16, 128, 6
    next_clock = np.zeros((len(CLIENTS), num_docs), np.int64)
    state_j = jr.make_empty_rle_state(num_docs, entries)
    state_t = tr.make_empty_rle_state(num_docs, entries, CPU)
    before = ti.integrate_op_slots_rle_fast.launches
    for _ in range(3):
        fields = random_stream(rng, num_docs, num_slots, next_clock)
        state_j, count_j = _integrate_pallas_rle(state_j, jax_ops(fields), True)
        state_t, count_t = ti.integrate_op_slots_rle_fast(state_t, tk.ops_from_numpy(fields, CPU))
        assert int(count_j) == int(count_t)
    assert_rle_equal(state_j, state_t)
    assert ti.integrate_op_slots_rle_fast.launches == before  # the CPU path launches nothing


def test_rle_sparse_dispatcher_matches_pallas_interpret():
    """The JAX sparse dispatch gathers the routed rows, runs the Pallas
    kernel over them and scatters back; the port routes in place."""
    rng = np.random.default_rng(4)
    num_docs, entries, busy, width, num_slots = 16, 96, 6, 8, 6
    state_j, state_t, next_clock = seeded_rle(rng, num_docs, entries)
    for _ in range(3):
        cols = np.sort(rng.choice(num_docs, size=busy, replace=False))
        sub_clock = next_clock[:, cols].copy()
        live = random_stream(rng, busy, num_slots, sub_clock)
        next_clock[:, cols] = sub_clock
        fields = padded(live, width)
        slots = np.full((width,), num_docs, np.int32)
        slots[:busy] = cols
        state_j, count_j = _integrate_sparse_pallas_rle(
            state_j, jax_ops(fields), jnp.asarray(slots), True
        )
        state_t, count_t = ti.integrate_op_slots_rle_sparse_fast(
            state_t, tk.ops_from_numpy(fields, CPU), torch.from_numpy(slots)
        )
        assert int(count_j) == int(count_t)
    assert_rle_equal(state_j, state_t)
