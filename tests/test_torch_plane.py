"""The port's merge plane and serving path against the JAX package's.

A twin of test_plane_fuzz_concurrent_editors_converge: two editors
(the JAX package's CRDT engine, in the test) mutate independent replicas
with mixed content; the shuffled stream of their updates goes to the JAX
MergePlane + PlaneServing and to the port's, on the CPU, over the unit
arena and over the run-length arena. After every flush the arena tensors
must be equal element for element, and the SyncStep2 and broadcast bytes
equal byte for byte.
"""

import numpy as np
import pytest

from hocuspocus_tpu.crdt import Doc, apply_update, encode_state_vector
from hocuspocus_tpu.tpu.merge_plane import MergePlane as JaxPlane
from hocuspocus_tpu.tpu.serving import PlaneServing as JaxServing
from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing, TpuSyncSource
from hocuspocus_tpu_torch.tpu.kernels import doc_state_to_numpy
from hocuspocus_tpu_torch.tpu.kernels_rle import rle_state_to_numpy
from tests.tpu.test_plane_fuzz import _doc_fingerprint, _random_edit

NAME = "conc"
COUNTERS = (
    "flush_fast_ops",
    "flush_slow_ops",
    "flush_batches_fast",
    "flush_batches_sparse",
    "flush_batches_dense",
    "docs_retired_overflow",
    "docs_retired_desync",
    "docs_retired_unsupported",
    "docs_retired_capacity",
    "plane_broadcasts",
    "sync_serves",
)


def assert_planes_equal(jax_plane, plane):
    to_numpy = rle_state_to_numpy if plane.arena == "rle" else doc_state_to_numpy
    ours = to_numpy(plane.state)
    assert type(jax_plane.state).__name__ == type(ours).__name__
    for name, a, b in zip(ours._fields, jax_plane.state, ours):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    for key in COUNTERS:
        assert jax_plane.counters[key] == plane.counters[key], key


@pytest.mark.parametrize("run_merge", [True, False])
@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_plane_twin_concurrent_editors(arena, seed, run_merge):
    rng = np.random.default_rng(seed)
    a, b = Doc(), Doc()
    out_a, out_b = [], []
    a.on("update", lambda update, *rest: out_a.append(update))
    b.on("update", lambda update, *rest: out_b.append(update))

    jax_plane = JaxPlane(num_docs=32, capacity=1024, arena=arena)
    plane = MergePlane(num_docs=32, capacity=1024, device="cpu", arena=arena)
    jax_plane.run_merge_enabled = run_merge
    plane.run_merge_enabled = run_merge
    jax_serving, serving = JaxServing(jax_plane), PlaneServing(plane)
    for p in (jax_plane, plane):
        p.register(NAME)

    def cross_deliver():
        for _ in range(8):
            if not out_a and not out_b:
                break
            batch_a, batch_b = out_a[:], out_b[:]
            out_a.clear()
            out_b.clear()
            pending = batch_a + batch_b
            rng.shuffle(pending)
            for update in pending:
                assert jax_plane.enqueue_update(NAME, update) == plane.enqueue_update(
                    NAME, update
                )
            for update in batch_a:
                apply_update(b, update)
            for update in batch_b:
                apply_update(a, update)
        assert not out_a and not out_b

    stale_sv = None
    for round_no in range(12):
        for doc in (a, b):
            for step in range(int(rng.integers(1, 5))):
                _random_edit(rng, doc, round_no * 100 + step)
        cross_deliver()
        assert _doc_fingerprint(a) == _doc_fingerprint(b)

        # broadcasts build from the host logs, before the device flush
        assert jax_serving.build_broadcast_pair(NAME) == serving.build_broadcast_pair(NAME)
        assert jax_plane.flush() == plane.flush()
        jax_serving.refresh()
        serving.refresh()
        assert_planes_equal(jax_plane, plane)
        assert plane.is_supported(NAME)

        cold = serving.encode_state_as_update(NAME, a, None)
        assert cold is not None
        assert cold == jax_serving.encode_state_as_update(NAME, a, None)
        rebuilt = Doc()
        apply_update(rebuilt, cold)
        assert _doc_fingerprint(rebuilt) == _doc_fingerprint(a)
        if stale_sv is not None:
            stale = TpuSyncSource(serving, NAME, a).encode_state_as_update(stale_sv)
            assert stale == jax_serving.encode_state_as_update(NAME, a, stale_sv)
        stale_sv = encode_state_vector(a)
    if run_merge:
        assert plane.counters["flush_fast_ops"] > 0
    assert plane.counters["flush_slow_ops"] > 0
    assert plane.counters["cpu_fallbacks"] == 0


async def test_batched_catch_up_matches_jax():
    """A storm of SyncStep1s (cold and stale) for several docs shares one
    state_vector_diff triage; the replies equal the JAX package's."""
    import asyncio

    rng = np.random.default_rng(19)
    jax_plane = JaxPlane(num_docs=16, capacity=512)
    plane = MergePlane(num_docs=16, capacity=512, device="cpu")
    jax_serving, serving = JaxServing(jax_plane), PlaneServing(plane)
    editors, stale = {}, {}
    for n in range(4):
        name = f"d{n}"
        a, b = Doc(), Doc()
        sent = []
        a.on("update", lambda update, *rest, sent=sent: sent.append(update))
        b.on("update", lambda update, *rest, sent=sent: sent.append(update))
        for step in range(6):
            _random_edit(rng, a if step % 2 else b, step)
            if step == 2:
                stale[name] = encode_state_vector(a)
        for update in sent:
            jax_plane.enqueue_update(name, update)
            plane.enqueue_update(name, update)
            apply_update(a, update)
        editors[name] = a
    requests = [(name, None) for name in editors] + list(stale.items())

    async def storm(serving_):
        return await asyncio.gather(
            *(serving_.batched_sync(name, editors[name], sv) for name, sv in requests)
        )

    ours = await storm(serving)
    theirs = await storm(jax_serving)
    assert all(reply is not None for reply in ours)
    assert ours == theirs


def test_plane_text_and_health_readback():
    plane = MergePlane(num_docs=4, capacity=64, device="cpu")
    editor = Doc()
    updates = []
    editor.on("update", lambda update, *rest: updates.append(update))
    editor.get_text("t").insert(0, "hello")
    editor.get_text("t").insert(2, "XY")
    for update in updates:
        plane.enqueue_update("d", update)
    plane.flush()
    assert plane.text("d") == "heXYllo"
    assert plane.last_lengths.tolist()[plane.docs["d"].seqs[("root", "t")]] == 7
    plane.release("d")
    assert len(plane.free) == 4
    assert int(plane.state.length.sum()) == 0


def _plane_with_pending_edit():
    plane = MergePlane(num_docs=4, capacity=64, device="cpu")
    editor = Doc()
    updates = []
    editor.on("update", lambda update, *rest: updates.append(update))
    editor.get_text("t").insert(0, "hello")
    for update in updates:
        plane.enqueue_update("d", update)
    return plane, editor


def test_sync_source_counts_each_cpu_fallback():
    plane, editor = _plane_with_pending_edit()
    serving = PlaneServing(plane)
    assert TpuSyncSource(serving, "d", editor).encode_state_as_update(None) is not None
    assert plane.counters["cpu_fallbacks"] == 0
    # a doc the plane does not hold, and a state vector that does not decode
    assert TpuSyncSource(serving, "absent", Doc()).encode_state_as_update(None) is None
    assert TpuSyncSource(serving, "d", editor).encode_state_as_update(b"\x05\xff") is None
    assert plane.counters["cpu_fallbacks"] == 2


@pytest.mark.parametrize("batched", [False, True])
def test_device_step_failure_propagates_instead_of_serving_the_cpu(monkeypatch, batched):
    """A failed kernel build or launch reaches the caller: the sync is
    not answered from the CPU document in its place."""
    import asyncio

    from hocuspocus_tpu_torch.tpu import merge_plane

    def refuse(*args, **kwargs):
        raise RuntimeError("integrate kernel launch failed")

    for name in ("integrate_op_slots_fast", "integrate_op_slots_sparse_fast",
                 "append_run_slots_sparse_fast"):
        monkeypatch.setattr(merge_plane, name, refuse)
    plane, editor = _plane_with_pending_edit()
    source = TpuSyncSource(PlaneServing(plane), "d", editor)
    with pytest.raises(RuntimeError, match="launch failed"):
        if batched:
            asyncio.run(source.encode_state_as_update_async(None))
        else:
            source.encode_state_as_update(None)
    assert plane.counters["cpu_fallbacks"] == 0


def _churn_planes(arena):
    """30 cycles of "type a 16-unit burst at the end, delete it" at
    capacity 256, flushing every 4 cycles, into the JAX plane and the
    port's: the live text stays empty while cumulative units reach 480."""
    editor = Doc()
    updates = []
    editor.on("update", lambda update, *rest: updates.append(update))
    jax_plane = JaxPlane(num_docs=8, capacity=256, arena=arena)
    plane = MergePlane(num_docs=8, capacity=256, device="cpu", arena=arena)
    text = editor.get_text("body")
    for cycle in range(30):
        base = len(text)
        text.insert(base, "x" * 16)
        text.delete(base, 16)
        for update in updates:
            assert jax_plane.enqueue_update("churny", update) == plane.enqueue_update(
                "churny", update
            )
        updates.clear()
        if cycle % 4 == 3:
            assert jax_plane.flush() == plane.flush()
            if plane.is_supported("churny"):
                assert_planes_equal(jax_plane, plane)
    jax_plane.flush()
    plane.flush()
    return jax_plane, plane


@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_churn_retires_the_unit_arena_but_not_the_rle_arena(arena):
    jax_plane, plane = _churn_planes(arena)
    for key in COUNTERS:
        assert jax_plane.counters[key] == plane.counters[key], key
    if arena == "unit":
        assert plane.counters["docs_retired_capacity"] > 0
        assert not plane.is_supported("churny")
        return
    assert_planes_equal(jax_plane, plane)
    retired = {k: v for k, v in plane.counters.items() if k.startswith("docs_retired_")}
    assert not any(retired.values()), retired
    assert plane.is_supported("churny")
    assert plane.text("churny") == jax_plane.text("churny") == ""
    assert int(plane.state.total_units.max()) == 480  # rank space: every unit ever typed
    assert int(plane.state.num_runs.max()) < 256


def test_rle_text_walks_an_extended_tail_entry():
    """One typist's later runs EXTEND the rank-tail entry on the append
    fast path, so one entry's units span several insert records; text()
    walks them, and a concurrent insert splitting it reads back too."""
    jax_plane = JaxPlane(num_docs=4, capacity=64, arena="rle")
    plane = MergePlane(num_docs=4, capacity=64, device="cpu", arena="rle")
    editor = Doc()
    updates = []
    editor.on("update", lambda update, *rest: updates.append(update))
    text = editor.get_text("t")

    def ship():
        for update in updates:
            jax_plane.enqueue_update("d", update)
            plane.enqueue_update("d", update)
        updates.clear()
        assert jax_plane.flush() == plane.flush()
        assert_planes_equal(jax_plane, plane)

    for word in ("hello", " wor", "ld", " \U0001F600!"):
        text.insert(len(text), word)
        ship()
    slot = plane.docs["d"].seqs[("root", "t")]
    assert int(plane.state.num_runs[slot]) == 1  # one entry, extended three times
    assert plane.counters["flush_fast_ops"] == 4
    assert plane.text("d") == jax_plane.text("d") == text.to_string()
    text.insert(3, "XY")
    text.delete(0, 1)
    ship()
    assert int(plane.state.num_runs[slot]) > 1
    assert plane.text("d") == jax_plane.text("d") == text.to_string()
