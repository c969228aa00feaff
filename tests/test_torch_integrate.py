"""The port's integrate dispatchers against the JAX package's Pallas kernel.

The Pallas kernel runs in interpret mode on the CPU, as the JAX
package's own tests run it; the port's dispatchers take their plain
path for CPU tensors. Integer state is compared exactly. The CUDA
kernel itself is held against the same plain path on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from hocuspocus_tpu.tpu import kernels as jk
from hocuspocus_tpu.tpu.pallas_kernels import integrate_op_slots_pallas
from hocuspocus_tpu_torch.tpu import integrate as ti
from hocuspocus_tpu_torch.tpu import kernels as tk
from tests.test_torch_kernels import (
    CLIENTS,
    assert_states_equal,
    jax_ops,
    random_stream,
)

CPU = torch.device("cpu")
D, N, K = 16, 256, 8


def overflow_and_missing_origin_ops(num_docs):
    """Slot 0 fits, slot 1 overflows, slot 2 names an unknown left
    origin, slot 3 an unknown right origin."""
    rows = 4
    kind = np.ones((rows, num_docs), np.int32)
    client = np.full((rows, num_docs), 7, np.uint32)
    clock = np.asarray([[0], [200], [300], [301]], np.int32).repeat(num_docs, 1)
    run_len = np.asarray([[200], [100], [1], [1]], np.int32).repeat(num_docs, 1)
    lc = np.asarray([[jk.NONE_CLIENT], [7], [12345], [7]], np.uint32).repeat(num_docs, 1)
    lk = np.asarray([[0], [199], [0], [3]], np.int32).repeat(num_docs, 1)
    rc = np.asarray(
        [[jk.NONE_CLIENT], [jk.NONE_CLIENT], [jk.NONE_CLIENT], [999]], np.uint32
    ).repeat(num_docs, 1)
    rk = np.zeros((rows, num_docs), np.int32)
    return (kind, client, clock, run_len, lc, lk, rc, rk)


def test_dense_dispatcher_matches_pallas_interpret():
    rng = np.random.default_rng(21)
    next_clock = np.zeros((len(CLIENTS), D), np.int64)
    state_j = jk.make_empty_state(D, N)
    state_t = tk.make_empty_state(D, N, CPU)
    for _ in range(3):
        fields = random_stream(rng, D, K, next_clock)
        state_j, count_j = integrate_op_slots_pallas(state_j, jax_ops(fields), interpret=True)
        state_t, count_t = ti.integrate_op_slots_fast(state_t, tk.ops_from_numpy(fields, CPU))
        assert int(count_j) == int(count_t)
    assert_states_equal(state_j, state_t)
    assert ti.integrate_op_slots_fast.launches == 0  # the CPU path launches nothing


def test_dense_dispatcher_overflow_and_missing_origins_match_pallas():
    fields = overflow_and_missing_origin_ops(D)
    state_j, count_j = integrate_op_slots_pallas(
        jk.make_empty_state(D, N), jax_ops(fields), interpret=True
    )
    state_t, count_t = ti.integrate_op_slots_fast(
        tk.make_empty_state(D, N, CPU), tk.ops_from_numpy(fields, CPU)
    )
    assert int(count_j) == int(count_t) == 4 * D  # dropped ops still count
    assert_states_equal(state_j, state_t)
    assert state_t.overflow.all()
    assert (state_t.length == 200).all()


def test_sparse_dispatcher_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    busy, width = 6, 8
    next_clock = np.zeros((len(CLIENTS), D), np.int64)
    state_j = jk.make_empty_state(D, N)
    state_t = tk.make_empty_state(D, N, CPU)
    for _ in range(3):
        cols = np.sort(rng.choice(D, size=busy, replace=False))
        sub_clock = next_clock[:, cols].copy()
        live = random_stream(rng, busy, K, sub_clock)
        next_clock[:, cols] = sub_clock
        fields = []
        for value, default in zip(live, (0, 0, 0, 0, jk.NONE_CLIENT, 0, jk.NONE_CLIENT, 0)):
            full = np.full((K, width), default, value.dtype)
            full[:, :busy] = value
            fields.append(full)
        slots = np.full((width,), D, np.int32)
        slots[:busy] = cols
        from hocuspocus_tpu.tpu.pallas_kernels import integrate_op_slots_sparse_pallas

        state_j, count_j = integrate_op_slots_sparse_pallas(
            state_j, jax_ops(fields), jnp.asarray(slots), interpret=True
        )
        state_t, count_t = ti.integrate_op_slots_sparse_fast(
            state_t, tk.ops_from_numpy(fields, CPU), torch.from_numpy(slots)
        )
        assert int(count_j) == int(count_t)
    assert_states_equal(state_j, state_t)


def test_state_round_trips_through_numpy():
    rng = np.random.default_rng(8)
    next_clock = np.zeros((len(CLIENTS), D), np.int64)
    state_j, _ = jk.integrate_op_slots(
        jk.make_empty_state(D, N), jax_ops(random_stream(rng, D, K, next_clock))
    )
    as_numpy = [np.asarray(field) for field in state_j]
    state_t = tk.doc_state_from_numpy(as_numpy, CPU)
    assert state_t.id_client.dtype == torch.int32
    assert state_t.deleted.dtype == torch.bool
    back = tk.doc_state_to_numpy(state_t)
    for name, a, b in zip(jk.DocState._fields, as_numpy, back):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (back.id_client >= 0x8000_0000).any()  # high client ids survive
    ops = tk.ops_from_numpy(random_stream(rng, D, K, next_clock), CPU)
    assert all(field.dtype == torch.int32 for field in ops)


def test_jax_state_handed_across_mid_stream_continues_identically():
    rng = np.random.default_rng(17)
    next_clock = np.zeros((len(CLIENTS), D), np.int64)
    state_j = jk.make_empty_state(D, N)
    for _ in range(2):
        state_j, _ = integrate_op_slots_pallas(
            state_j, jax_ops(random_stream(rng, D, K, next_clock)), interpret=True
        )
    state_t = tk.doc_state_from_numpy([np.asarray(f) for f in state_j], CPU)
    for _ in range(2):
        fields = random_stream(rng, D, K, next_clock)
        state_j, _ = integrate_op_slots_pallas(state_j, jax_ops(fields), interpret=True)
        state_t, _ = ti.integrate_op_slots_fast(state_t, tk.ops_from_numpy(fields, CPU))
    assert_states_equal(state_j, state_t)

