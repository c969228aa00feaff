"""The PyTorch port's plain arena programs against the JAX package's.

Every input is made with numpy from a seed and handed to both packages;
integer state is compared exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hocuspocus_tpu.tpu import kernels as jk
from hocuspocus_tpu_torch.tpu import kernels as tk

CPU = torch.device("cpu")
# one client below 2^31 and one above: same-origin concurrent inserts
# from these two exercise the YATA client-id tiebreak as an UNSIGNED
# compare
CLIENTS = (7, 0x9000_0001)


def random_stream(rng, num_docs, num_slots, next_clock):
    """Causally-valid two-client op stream with random origins, as numpy
    arrays in the JAX package's dtypes; next_clock is (clients, docs)."""
    kind = rng.integers(0, 3, size=(num_slots, num_docs)).astype(np.int32)
    client = np.full((num_slots, num_docs), CLIENTS[0], np.uint32)
    clock = np.zeros((num_slots, num_docs), np.int32)
    run_len = rng.integers(1, 9, size=(num_slots, num_docs)).astype(np.int32)
    lc = np.full((num_slots, num_docs), jk.NONE_CLIENT, np.uint32)
    lk = np.zeros((num_slots, num_docs), np.int32)
    rc = np.full((num_slots, num_docs), jk.NONE_CLIENT, np.uint32)
    rk = np.zeros((num_slots, num_docs), np.int32)
    for k in range(num_slots):
        for d in range(num_docs):
            ci = rng.integers(0, len(CLIENTS))
            if kind[k, d] == 1:
                client[k, d] = CLIENTS[ci]
                clock[k, d] = next_clock[ci, d]
                known = [(i, c) for i, c in enumerate(next_clock[:, d]) if c > 0]
                if known:
                    oi, oc = known[rng.integers(0, len(known))]
                    lc[k, d] = CLIENTS[oi]
                    lk[k, d] = rng.integers(0, oc)
                    if rng.random() < 0.3:
                        ri, rcl = known[rng.integers(0, len(known))]
                        rc[k, d] = CLIENTS[ri]
                        rk[k, d] = rng.integers(0, rcl)
                next_clock[ci, d] += run_len[k, d]
            elif kind[k, d] == 2:
                if next_clock[ci, d] == 0:
                    kind[k, d] = 0
                else:
                    client[k, d] = CLIENTS[ci]
                    clock[k, d] = rng.integers(0, next_clock[ci, d])
                    run_len[k, d] = min(run_len[k, d], next_clock[ci, d] - clock[k, d])
    return (kind, client, clock, run_len, lc, lk, rc, rk)


def jax_ops(fields):
    return jk.OpBatch(*map(jnp.asarray, fields))


def assert_states_equal(jax_state, torch_state):
    ours = tk.doc_state_to_numpy(torch_state)
    for name, a, b in zip(jk.DocState._fields, jax_state, ours):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def seeded_states(rng, num_docs, capacity, rounds=2, num_slots=6):
    """The same random history integrated by both packages."""
    next_clock = np.zeros((len(CLIENTS), num_docs), np.int64)
    state_j = jk.make_empty_state(num_docs, capacity)
    state_t = tk.make_empty_state(num_docs, capacity, CPU)
    for _ in range(rounds):
        fields = random_stream(rng, num_docs, num_slots, next_clock)
        state_j, _ = jk.integrate_op_slots(state_j, jax_ops(fields))
        state_t, _ = tk.integrate_op_slots(state_t, tk.ops_from_numpy(fields, CPU))
    return state_j, state_t, next_clock


@pytest.mark.parametrize("seed", [1, 7])
def test_integrate_op_slots_matches_jax(seed):
    rng = np.random.default_rng(seed)
    num_docs, capacity, num_slots = 16, 256, 6
    next_clock = np.zeros((len(CLIENTS), num_docs), np.int64)
    state_j = jk.make_empty_state(num_docs, capacity)
    state_t = tk.make_empty_state(num_docs, capacity, CPU)
    for _ in range(4):
        fields = random_stream(rng, num_docs, num_slots, next_clock)
        state_j, count_j = jk.integrate_op_slots(state_j, jax_ops(fields))
        state_t, count_t = tk.integrate_op_slots(state_t, tk.ops_from_numpy(fields, CPU))
        assert int(count_j) == int(count_t)
    assert_states_equal(state_j, state_t)


def test_integrate_op_slots_sparse_with_padding_matches_jax():
    rng = np.random.default_rng(5)
    num_docs, capacity, busy, width, num_slots = 24, 192, 5, 8, 6
    state_j, state_t, next_clock = seeded_states(rng, num_docs, capacity)
    for _ in range(3):
        cols = np.sort(rng.choice(num_docs, size=busy, replace=False))
        sub_clock = next_clock[:, cols].copy()
        live = random_stream(rng, busy, num_slots, sub_clock)
        next_clock[:, cols] = sub_clock
        # padding columns carry noops and the out-of-range sentinel
        fields = []
        for value, default in zip(live, (0, 0, 0, 0, jk.NONE_CLIENT, 0, jk.NONE_CLIENT, 0)):
            full = np.full((num_slots, width), default, value.dtype)
            full[:, :busy] = value
            fields.append(full)
        slots = np.full((width,), num_docs, np.int32)
        slots[:busy] = cols
        state_j, count_j = jk.integrate_op_slots_sparse(
            state_j, jax_ops(fields), jnp.asarray(slots)
        )
        state_t, count_t = tk.integrate_op_slots_sparse(
            state_t, tk.ops_from_numpy(fields, CPU), torch.from_numpy(slots)
        )
        assert int(count_j) == int(count_t)
    assert_states_equal(state_j, state_t)


def test_append_run_slots_sparse_matches_jax_including_overflow_quirk():
    num_docs, capacity = 8, 64
    rng = np.random.default_rng(11)
    state_j = jk.make_empty_state(num_docs, capacity)
    state_t = tk.make_empty_state(num_docs, capacity, CPU)
    # column 0: a fitting chain; column 1: run 1 overflows and kills the
    # chain, run 2 would fit on its own but is dead (no overflow flag
    # from it); column 2: a dead-chain run that ALSO fails its own fits
    # check; column 3: padding
    run_len = np.asarray(
        [[10, 30, 40, 0], [12, 40, 70, 0], [5, 1, 20, 0]], np.int32
    )
    client = np.full((3, 4), 0x9000_0001, np.uint32)
    clock = np.cumsum(np.vstack([np.zeros((1, 4), np.int32), run_len[:-1]]), axis=0).astype(
        np.int32
    )
    slots = np.asarray([1, 4, 6, num_docs], np.int32)
    for _ in range(2):
        state_j, count_j = jk.append_run_slots_sparse(
            state_j, *map(jnp.asarray, (client, clock, run_len, slots))
        )
        state_t, count_t = tk.append_run_slots_sparse(
            state_t, *(torch.from_numpy(a.view(np.int32)) for a in (client, clock, run_len)),
            torch.from_numpy(slots),
        )
        assert int(count_j) == int(count_t)
        clock = clock + run_len.sum(axis=0, dtype=np.int32)
    assert_states_equal(state_j, state_t)
    assert bool(np.asarray(state_j.overflow)[4]) and bool(np.asarray(state_j.overflow)[6])
    # random chains on top of a seeded arena
    state_j, state_t, _ = seeded_states(rng, num_docs, capacity, rounds=1)
    run_len = rng.integers(0, 9, size=(4, num_docs)).astype(np.int32)
    client = rng.integers(1, 2**32, size=(4, num_docs), dtype=np.uint64).astype(np.uint32)
    clock = rng.integers(0, 1000, size=(4, num_docs)).astype(np.int32)
    slots = np.arange(num_docs, dtype=np.int32)
    state_j, count_j = jk.append_run_slots_sparse(
        state_j, *map(jnp.asarray, (client, clock, run_len, slots))
    )
    state_t, count_t = tk.append_run_slots_sparse(
        state_t, *(torch.from_numpy(a.view(np.int32)) for a in (client, clock, run_len)),
        torch.from_numpy(slots),
    )
    assert int(count_j) == int(count_t)
    assert_states_equal(state_j, state_t)


def test_tail_probe_matches_jax():
    rng = np.random.default_rng(3)
    num_docs, capacity = 12, 128
    state_j, state_t, _ = seeded_states(rng, num_docs, capacity)
    slots = np.asarray([0, 3, 5, 11, 2, 0, 0, 0], np.int32)
    got = tk.tail_probe(state_t, torch.from_numpy(slots)).numpy().view(np.uint32)
    want = np.asarray(jk.tail_probe(state_j, jnp.asarray(slots)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [4, 128])
def test_catchup_pack_matches_jax(width):
    """width 4 is below most rows' tombstone count: those rows report the
    true count and pack only the first `width` tombstones."""
    rng = np.random.default_rng(9)
    num_docs, capacity = 10, 160
    state_j, state_t, _ = seeded_states(rng, num_docs, capacity, rounds=3)
    slots = np.asarray([1, 2, 3, 9, 0, 4, 4, 4], np.int32)
    got = tk.catchup_pack(state_t, torch.from_numpy(slots), width).numpy().view(np.uint32)
    want = np.asarray(jk.catchup_pack(state_j, jnp.asarray(slots), width))
    np.testing.assert_array_equal(got, want)
    if width == 4:
        assert (want[: slots.size] > width).any()


def test_state_vector_diff_matches_jax():
    rng = np.random.default_rng(2)
    server = rng.integers(0, 50, size=(8, 16)).astype(np.int32)
    client = rng.integers(0, 50, size=(8, 16)).astype(np.int32)
    got = tk.state_vector_diff(torch.from_numpy(server), torch.from_numpy(client))
    want = jk.state_vector_diff(jnp.asarray(server), jnp.asarray(client))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compact_doc_rows_and_live_mask_match_jax():
    rng = np.random.default_rng(13)
    num_docs, capacity = 10, 128
    state_j, state_t, _ = seeded_states(rng, num_docs, capacity, rounds=3)
    np.testing.assert_array_equal(
        tk.extract_live_mask(state_t).numpy(), np.asarray(jk.extract_live_mask(state_j))
    )
    slots = np.asarray([2, 7, 0, num_docs], np.int32)
    state_j, len_j = jk.compact_doc_rows(state_j, jnp.asarray(slots))
    state_t, len_t = tk.compact_doc_rows(state_t, torch.from_numpy(slots))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert_states_equal(state_j, state_t)
