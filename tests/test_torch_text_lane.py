"""The port's native text lane against its Python host path and against
the JAX package's lane.

A lane plane (`MergePlane.enable_lane` + `register_lane`) runs a
plain-text doc's whole host path in the port's C++: decode, causal
lowering, serve log, the columnar drain into the device batch and the
broadcast windows. The same update streams, made from a numpy seed, go
through a lane plane and a Python-path plane of the port on the CPU,
over both arenas, and (in the fuzz cases) through the JAX package's
lane plane: broadcast windows and sync serves byte for byte, arenas
element for element through the numpy carry-across, tolerance 0.
"""

import numpy as np
import pytest

from hocuspocus_tpu.tpu.merge_plane import MergePlane as JaxPlane
from hocuspocus_tpu.tpu.serving import PlaneServing as JaxServing
from hocuspocus_tpu_torch.crdt import (
    Doc,
    apply_update,
    diff_update,
    encode_state_as_update,
    encode_state_vector,
)
from hocuspocus_tpu_torch.crdt.encoding import Encoder
from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing
from hocuspocus_tpu_torch.tpu.kernels import doc_state_to_numpy
from hocuspocus_tpu_torch.tpu.kernels_rle import rle_state_to_numpy

ARENAS = ["unit", "rle"]
# client ids at and above 2**31 ride the device as negative int32 bit
# patterns; the fast/slow split compares them with uint32 host tails
HIGH_CLIENTS = (0x80000007, 0xFFFFFFF0)


def _planes(arena, num_docs=8, capacity=4096):
    lane_plane = MergePlane(num_docs=num_docs, capacity=capacity, device="cpu", arena=arena)
    lane_plane.enable_lane()
    py_plane = MergePlane(num_docs=num_docs, capacity=capacity, device="cpu", arena=arena)
    return lane_plane, PlaneServing(lane_plane), py_plane, PlaneServing(py_plane)


def _arena(plane):
    to_numpy = rle_state_to_numpy if plane.arena == "rle" else doc_state_to_numpy
    return to_numpy(plane.state)


def assert_arenas_equal(left, right):
    """Element for element; `left` may be a JAX plane (its state is
    read through np.asarray)."""
    ours = _arena(right)
    theirs = _arena(left) if isinstance(left, MergePlane) else left.state
    for name, a, b in zip(ours._fields, theirs, ours):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def _flush_all(*planes):
    counts = [plane.flush() for plane in planes]
    assert len(set(counts)) == 1, counts
    return counts[0]


@pytest.mark.parametrize("seed", [2, 9])
@pytest.mark.parametrize("arena", ARENAS)
def test_lane_windows_serves_and_arena_match_python_and_jax(arena, seed):
    rng = np.random.default_rng(seed)
    lane_plane, lane_serving, py_plane, py_serving = _planes(arena)
    jax_plane = JaxPlane(num_docs=8, capacity=4096, arena=arena)
    assert jax_plane.enable_lane()
    jax_serving = JaxServing(jax_plane)
    assert lane_plane.register_lane("d") is not None
    assert jax_plane.register_lane("d") is not None
    py_plane.register("d")

    src = Doc()
    src.client_id = 7
    text = src.get_text("body")
    updates = []
    src.on("update", lambda u, *r: updates.append(u))

    for round_no in range(10):
        for _ in range(int(rng.integers(1, 5))):
            r = rng.random()
            n = len(text)
            if r < 0.6 or n < 4:
                text.insert(int(rng.integers(0, n + 1)), f"r{round_no}x{'y' * int(rng.integers(1, 9))}")
            elif r < 0.85:
                pos = int(rng.integers(0, n - 2))
                text.delete(pos, int(rng.integers(1, min(3, n - pos) + 1)))
            else:
                text.insert(int(rng.integers(0, n + 1)), "emoji\U0001f600")
        while updates:
            u = updates.pop(0)
            accepted = lane_plane.enqueue_update("d", u)
            assert accepted > 0
            assert accepted == jax_plane.enqueue_update("d", u)
            assert py_plane.enqueue_update("d", u) > 0
        assert lane_plane.pending_ops() == py_plane.pending_ops() == jax_plane.pending_ops()
        lw = lane_serving.build_broadcast_pair("d")
        assert lw == py_serving.build_broadcast_pair("d"), round_no
        assert lw == jax_serving.build_broadcast_pair("d"), round_no
        _flush_all(lane_plane, py_plane, jax_plane)
        assert_arenas_equal(py_plane, lane_plane)
        assert_arenas_equal(jax_plane, lane_plane)

    for serving in (lane_serving, py_serving, jax_serving):
        serving.refresh()
    assert lane_plane.text("d") == text.to_string() == py_plane.text("d")
    cold = lane_serving.encode_state_as_update("d", src, None)
    assert cold is not None
    assert cold == py_serving.encode_state_as_update("d", src, None)
    assert cold == jax_serving.encode_state_as_update("d", src, None)
    probe = Doc()
    apply_update(probe, cold)
    assert probe.get_text("body").to_string() == text.to_string()

    mid_sv = encode_state_vector(src)
    text.insert(0, "tail ")
    while updates:
        u = updates.pop(0)
        for plane in (lane_plane, py_plane, jax_plane):
            plane.enqueue_update("d", u)
    _flush_all(lane_plane, py_plane, jax_plane)
    for serving in (lane_serving, py_serving, jax_serving):
        serving.refresh()
    stale = lane_serving.encode_state_as_update("d", src, mid_sv)
    assert stale is not None
    assert stale == py_serving.encode_state_as_update("d", src, mid_sv)
    assert stale == jax_serving.encode_state_as_update("d", src, mid_sv)
    assert lane_plane.counters["plane_broadcasts"] == py_plane.counters["plane_broadcasts"]
    assert lane_plane.counters["sync_serves"] == jax_plane.counters["sync_serves"]


def _record_flush(plane, log):
    """Wrap the plane's classifier and batch assembly so a flush leaves
    their outputs in `log`: the fast run pack and every staged batch."""
    classify, assemble = plane._classify_fast, plane._assemble_batch

    def classify_recorded(drained):
        fast, slow = classify(drained)
        log.append(("fast", None if fast is None else fast[:6] + fast[7:]))
        return fast, slow

    def assemble_recorded(k, drained, staging, dense, b):
        slot_view, b = assemble(k, drained, staging, dense, b)
        size = 8 * k * b + (0 if slot_view is None else b)
        log.append(("batch", k, b, dense, staging.array[:size].copy()))
        return slot_view, b

    plane._classify_fast = classify_recorded
    plane._assemble_batch = assemble_recorded


@pytest.mark.parametrize("run_merge", [True, False])
@pytest.mark.parametrize("arena", ARENAS)
def test_lane_drain_split_and_batches_match_python(arena, run_merge):
    """The lane's columnar drain folds into the fast/slow split and the
    staged device batch exactly like the Python queues, column for
    column, with client ids at and above 2**31 on both paths."""
    rng = np.random.default_rng(5)
    lane_plane, _, py_plane, _ = _planes(arena, num_docs=8, capacity=1024)
    for plane in (lane_plane, py_plane):
        plane.run_merge_enabled = run_merge
    names = [f"d{i}" for i in range(6)]
    editors = {}
    for name in names:
        assert lane_plane.register_lane(name) is not None
        pair = []
        for client in HIGH_CLIENTS:
            doc = Doc()
            doc.client_id = client
            sent = []
            doc.on("update", lambda u, *r, sent=sent: sent.append(u))
            pair.append((doc, sent))
        editors[name] = pair
    lane_log, py_log = [], []
    _record_flush(lane_plane, lane_log)
    _record_flush(py_plane, py_log)
    for round_no in range(8):
        # a few docs a round: sparse batches; most docs: the dense layout
        busy = names[: 2 if round_no % 2 else 6]
        for name in busy:
            (a, sent_a), (b, sent_b) = editors[name]
            ta = a.get_text("t")
            ta.insert(len(ta), f"a{round_no} ")  # tail appends: the fast path
            if round_no % 3 == 2:
                tb = b.get_text("t")
                tb.insert(int(rng.integers(0, len(tb) + 1)), f"B{round_no}")  # concurrent
            stream = sent_a + sent_b
            for u in sent_a:
                apply_update(b, u)
            for u in sent_b:
                apply_update(a, u)
            sent_a.clear()
            sent_b.clear()
            for u in stream:
                assert lane_plane.enqueue_update(name, u) == py_plane.enqueue_update(name, u)
        for name in busy:
            assert lane_plane.docs[name].lane_slot == py_plane.docs[name].seqs[("root", "t")]
        _flush_all(lane_plane, py_plane)
        assert_arenas_equal(py_plane, lane_plane)
        for key in ("flush_fast_ops", "flush_slow_ops", "flush_batches_dense", "flush_batches_sparse"):
            assert lane_plane.counters[key] == py_plane.counters[key], key
        np.testing.assert_array_equal(lane_plane.dispatched_units, py_plane.dispatched_units)
        np.testing.assert_array_equal(lane_plane._tail_client, py_plane._tail_client)
    assert len(lane_log) == len(py_log)
    for ours, theirs in zip(lane_log, py_log):
        assert ours[0] == theirs[0]
        if ours[0] == "batch":
            assert ours[1:4] == theirs[1:4]
            np.testing.assert_array_equal(ours[4], theirs[4])
        elif ours[1] is None or theirs[1] is None:
            assert ours[1] is theirs[1] is None
        else:
            for a, b in zip(ours[1], theirs[1]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    batches = [entry for entry in lane_log if entry[0] == "batch"]
    assert any(entry[3] for entry in batches) and any(not entry[3] for entry in batches)
    staged_clients = np.concatenate(
        [entry[4][: 8 * entry[1] * entry[2]].reshape(8, -1)[1].view(np.uint32) for entry in batches]
    )
    assert (staged_clients >= 2**31).any()
    if run_merge:
        assert lane_plane.counters["flush_fast_ops"] > 0
    assert lane_plane.counters["flush_slow_ops"] > 0
    for name in names:
        assert lane_plane.text(name) == py_plane.text(name) == editors[name][0][0].get_text(
            "t"
        ).to_string()


@pytest.mark.parametrize("arena", ARENAS)
def test_lane_buffers_out_of_order_updates(arena):
    """A delta that arrives before its causal predecessor waits in the
    lane's pending set and applies once the gap closes, as in the Python
    lowerer."""
    lane_plane, lane_serving, py_plane, py_serving = _planes(arena)
    lane_plane.register_lane("d")
    py_plane.register("d")
    src = Doc()
    src.client_id = 3
    text = src.get_text("t")
    text.insert(0, "base ")
    u1 = encode_state_as_update(src)
    sv1 = encode_state_vector(src)
    text.insert(5, "middle ")
    u2 = diff_update(encode_state_as_update(src), sv1)
    sv2 = encode_state_vector(src)
    text.insert(0, "front ")
    u3 = diff_update(encode_state_as_update(src), sv2)
    for plane in (lane_plane, py_plane):
        assert plane.enqueue_update("d", u1) > 0
        assert plane.enqueue_update("d", u3) == 0  # gap: buffered
        assert plane.enqueue_update("d", u2) > 0  # closes the gap; drains u3
        assert plane.is_supported("d")
    lw = lane_serving.build_broadcast_pair("d")
    assert lw is not None and lw == py_serving.build_broadcast_pair("d")
    _flush_all(lane_plane, py_plane)
    assert_arenas_equal(py_plane, lane_plane)
    assert lane_plane.text("d") == text.to_string()


@pytest.mark.parametrize("arena", ARENAS)
def test_lane_demotes_on_rich_content_and_bans(arena):
    lane_plane, _, _, _ = _planes(arena)
    lane_plane.register_lane("d")
    src = Doc()
    src.get_text("t").insert(0, "plain")
    assert lane_plane.enqueue_update("d", encode_state_as_update(src)) > 0
    src.get_map("m").set("k", 1)
    assert lane_plane.enqueue_update("d", encode_state_as_update(src)) == 0
    doc = lane_plane.docs["d"]
    assert doc.retired and doc.retire_reason == "lane_demote"
    assert "d" in lane_plane._lane_banned
    assert lane_plane.counters["docs_retired_lane_demote"] == 1
    assert lane_plane.pending_ops() == 0  # the demote dropped its queue
    # re-onboard goes to the Python path, which takes the rich doc
    slot = doc.lane_slot
    lane_plane.release("d")
    assert slot in lane_plane.free
    assert lane_plane.register_lane("d") is None
    lane_plane.register("d")
    assert lane_plane.enqueue_update("d", encode_state_as_update(src)) > 0
    assert lane_plane.is_supported("d") and lane_plane.docs["d"].lane_slot is None


@pytest.mark.parametrize("arena", ARENAS)
def test_lane_remote_flags_split_cross_instance_windows(arena):
    lane_plane, lane_serving, py_plane, py_serving = _planes(arena)
    lane_plane.register_lane("d")
    py_plane.register("d")
    src = Doc()
    src.client_id = 5
    src.get_text("t").insert(0, "local one ")
    u_local = encode_state_as_update(src)
    sv = encode_state_vector(src)
    peer = Doc()
    peer.client_id = 6
    apply_update(peer, u_local)
    peer.get_text("t").insert(0, "REMOTE ")
    u_remote = diff_update(encode_state_as_update(peer), sv)
    for plane in (lane_plane, py_plane):
        plane.enqueue_update("d", u_local)
        plane.enqueue_update("d", u_remote, remote=True)
    lw_full, lw_cross = lane_serving.build_broadcast_pair("d")
    pw_full, pw_cross = py_serving.build_broadcast_pair("d")
    assert lw_full == pw_full
    assert lw_cross == pw_cross
    assert lw_cross != lw_full  # remote record excluded


@pytest.mark.parametrize("arena", ARENAS)
def test_lane_sm_serves_match_python_cross_product(arena):
    """The native stale/cold serve (cutoff trimming, offset origin
    rewrite, surrogate widening in C) equals the Python serve across the
    per-client cutoff cross-product, surrogate pairs included."""
    lane_plane, lane_serving, py_plane, py_serving = _planes(arena)
    assert lane_plane.register_lane("d") is not None
    py_plane.register("d")
    a, b = Doc(), Doc()
    a.client_id, b.client_id = 7, HIGH_CLIENTS[0]
    ta = a.get_text("t")
    ta.insert(0, "base \U0001f600 text")
    u1 = encode_state_as_update(a)
    apply_update(b, u1)
    b.get_text("t").insert(3, "B\U0001f680B")
    u2 = encode_state_as_update(b)
    apply_update(a, u2)
    ta.insert(0, "more ")
    ta.delete(2, 4)
    u3 = encode_state_as_update(a)
    for plane in (lane_plane, py_plane):
        for u in (u1, u2, u3):
            plane.enqueue_update("d", u)
    _flush_all(lane_plane, py_plane)
    assert_arenas_equal(py_plane, lane_plane)
    lane_serving.refresh()
    py_serving.refresh()
    lane_doc, py_doc = lane_plane.docs["d"], py_plane.docs["d"]
    known = lane_serving._local_sv(lane_doc)
    assert known == dict(py_doc.lowerer.known)
    for cut_a in range(known.get(7, 0) + 1):
        for cut_b in range(0, known.get(HIGH_CLIENTS[0], 0) + 1, 2):
            sm = {7: cut_a, HIGH_CLIENTS[0]: cut_b}
            assert lane_serving._encode_from_sm(lane_doc, dict(sm)) == py_serving._encode_from_sm(
                py_doc, dict(sm)
            ), sm


@pytest.mark.parametrize("seed", [4, 19])
@pytest.mark.parametrize("arena", ARENAS)
def test_lane_concurrent_editors_differential(arena, seed):
    """Two text editors on independent replicas, updates cross-applied in
    a shuffled interleave: windows, cold and stale serves and arenas stay
    identical between the port's lane, its Python path and the JAX
    package's lane, round after round."""
    rng = np.random.default_rng(seed)
    a, b = Doc(), Doc()
    a.client_id, b.client_id = 7, HIGH_CLIENTS[1]
    out_a, out_b = [], []
    a.on("update", lambda update, *rest: out_a.append(update))
    b.on("update", lambda update, *rest: out_b.append(update))
    lane_plane, lane_serving, py_plane, py_serving = _planes(arena, capacity=8192)
    jax_plane = JaxPlane(num_docs=8, capacity=8192, arena=arena)
    assert jax_plane.enable_lane()
    jax_serving = JaxServing(jax_plane)
    assert lane_plane.register_lane("conc") is not None
    assert jax_plane.register_lane("conc") is not None
    py_plane.register("conc")
    planes = (lane_plane, py_plane, jax_plane)
    servings = (lane_serving, py_serving, jax_serving)

    def edit(doc, tag):
        text = doc.get_text("t")
        n = len(text)
        r = rng.random()
        if r < 0.55 or n < 4:
            text.insert(int(rng.integers(0, n + 1)), f"{tag}x{'y' * int(rng.integers(1, 7))}")
        elif r < 0.8:
            pos = int(rng.integers(0, n - 2))
            text.delete(pos, int(rng.integers(1, min(4, n - pos) + 1)))
        else:
            text.insert(int(rng.integers(0, n + 1)), "\U0001f600")

    def serve_all(sv):
        replies = [serving.encode_state_as_update("conc", a, sv) for serving in servings]
        assert replies[0] is not None
        assert replies[0] == replies[1] == replies[2]

    for round_no in range(10):
        for doc, tag in ((a, "a"), (b, "b")):
            for _ in range(int(rng.integers(1, 5))):
                edit(doc, f"{tag}{round_no}")
        pending = out_a + out_b
        rng.shuffle(pending)
        for update in pending:
            for plane in planes:
                plane.enqueue_update("conc", update)
        for update in out_a:
            apply_update(b, update)
        for update in out_b:
            apply_update(a, update)
        out_a.clear()
        out_b.clear()
        assert a.get_text("t").to_string() == b.get_text("t").to_string()
        windows = [serving.build_broadcast_pair("conc") for serving in servings]
        assert windows[0] == windows[1] == windows[2], round_no
        _flush_all(*planes)
        for serving in servings:
            serving.refresh()
        assert_arenas_equal(py_plane, lane_plane)
        assert_arenas_equal(jax_plane, lane_plane)
        assert all(plane.is_supported("conc") for plane in planes)
        serve_all(None)
        if round_no % 3 == 2:
            sv = encode_state_vector(b)
            edit(a, f"tail{round_no}")
            while out_a:
                u = out_a.pop(0)
                for plane in planes:
                    plane.enqueue_update("conc", u)
                apply_update(b, u)
            _flush_all(*planes)
            for serving in servings:
                serving.refresh()
            serve_all(sv)
    assert lane_plane.text("conc") == a.get_text("t").to_string()


@pytest.mark.parametrize("arena", ARENAS)
def test_lane_gc_structs_match_python(arena):
    """A wire GC struct on a text doc: the lane records it host-side
    (never queued to the device), advances known past the range and
    serves windows identical to the Python path."""
    lane_plane, lane_serving, py_plane, py_serving = _planes(arena)
    assert lane_plane.register_lane("d") is not None
    py_plane.register("d")
    # [1 section][2 structs][client 42][clock 0]
    #   GC len 4, then ContentString "hi" with origin (42, 3)
    e = Encoder()
    e.write_var_uint(1)
    e.write_var_uint(2)
    e.write_var_uint(42)
    e.write_var_uint(0)
    e.write_uint8(0)  # GC ref
    e.write_var_uint(4)
    e.write_uint8(0x04 | 0x80)  # ContentString + origin
    e.write_var_uint(42)
    e.write_var_uint(3)
    e.write_var_string("hi")
    e.write_var_uint(0)  # empty delete set
    update = e.to_bytes()
    assert lane_plane.enqueue_update("d", update) > 0
    assert py_plane.enqueue_update("d", update) > 0
    assert lane_plane.is_supported("d") and py_plane.is_supported("d")
    # the insert's origin lies in the collected range, so it collapses
    # to GC too: nothing queues to the device
    assert lane_plane.pending_ops() == py_plane.pending_ops() == 0
    lw = lane_serving.build_broadcast_pair("d")
    assert lw is not None and lw == py_serving.build_broadcast_pair("d")
    lane_plane.flush()
    py_plane.flush()
    lane_serving.refresh()
    py_serving.refresh()
    assert lane_serving._local_sv(lane_plane.docs["d"]) == {42: 6}
    for sm in ({42: 0}, {42: 2}, {42: 4}, {42: 5}):
        assert lane_serving._encode_from_sm(lane_plane.docs["d"], dict(sm)) == (
            py_serving._encode_from_sm(py_plane.docs["d"], dict(sm))
        ), sm


@pytest.mark.parametrize("arena", ARENAS)
def test_lane_batched_catch_up_matches_python(arena):
    """A storm of cold and stale SyncStep1s over lane docs shares one
    state_vector_diff triage; the replies equal the Python plane's."""
    import asyncio

    rng = np.random.default_rng(23)
    lane_plane, lane_serving, py_plane, py_serving = _planes(arena, num_docs=16)
    editors, stale = {}, {}
    for n in range(4):
        name = f"d{n}"
        lane_plane.register_lane(name)
        src = Doc()
        src.client_id = HIGH_CLIENTS[n % 2] - n
        sent = []
        src.on("update", lambda u, *r, sent=sent: sent.append(u))
        text = src.get_text("t")
        for step in range(6):
            text.insert(int(rng.integers(0, len(text) + 1)), f"s{step}")
            if step == 2:
                stale[name] = encode_state_vector(src)
        for u in sent:
            lane_plane.enqueue_update(name, u)
            py_plane.enqueue_update(name, u)
        editors[name] = src
    requests = [(name, None) for name in editors] + list(stale.items())

    async def storm(serving):
        return await asyncio.gather(
            *(serving.batched_sync(name, editors[name], sv) for name, sv in requests)
        )

    ours = asyncio.run(storm(lane_serving))
    assert all(reply is not None for reply in ours)
    assert ours == asyncio.run(storm(py_serving))
    assert lane_plane.materialize_lane(lane_plane.docs["d0"]) is None
    assert dict(lane_plane.docs["d0"].lowerer.known) == dict(py_plane.docs["d0"].lowerer.known)
