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
# a row that is one warp window; short rows in a wide row (the warp path
# beside a CTA launch that finds every column done)
@pytest.mark.parametrize("capacity", [256, 20_000])
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
# a row that is one warp window; short rows in a wide row
@pytest.mark.parametrize("entries", [256, 12_000])
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
@pytest.mark.parametrize("entries", [64, 1024, 12_000])
def test_rle_kernel_matches_plain_version_when_ids_repeat(cuda, entries):
    """Random ops with no causal order: ids repeat, runs may be empty or
    negative, origins may be missing, unknown kinds appear. Several
    entries can then match one split, and the kernel must still extract
    the split fields as the plain version's masked sums do. Every row
    here takes the warp path (R = 64 is one window; at 1024 and 12,000
    the rows stay far inside theirs)."""
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


# -- the warp path and the CTA path, both kernels --------------------------------

ARENAS = {
    "unit": (tk.make_empty_state, ti.integrate_op_slots_fast, ti.integrate_op_slots_sparse_fast),
    "rle": (
        tr.make_empty_rle_state,
        ti.integrate_op_slots_rle_fast,
        ti.integrate_op_slots_rle_sparse_fast,
    ),
}
WINDOW = ti.WARP_WINDOW


def typed_rows(arena, sizes, width):
    """CPU rows of sizes[i] units (unit arena) or one-unit entries (RLE
    arena) typed in order by client 7: ids 7:0.., ranks 0.., each one's
    origin its predecessor. Returns the state and next_clock (2, D)."""
    make = ARENAS[arena][0]
    state = make(len(sizes), width, CPU)
    for d, n in enumerate(sizes):
        ids = torch.arange(n, dtype=torch.int32)
        if arena == "unit":
            state.id_client[d, :n] = 7
            state.id_clock[d, :n] = ids
            state.rank[d, :n] = ids
            state.origin_rank[d, :n] = ids - 1
            state.length[d] = n
        else:
            state.run_client[d, :n] = 7
            state.run_clock[d, :n] = ids
            state.run_len[d, :n] = 1
            state.run_rank[d, :n] = ids
            state.run_orank[d, :n] = ids - 1
            state.num_runs[d] = n
            state.total_units[d] = n
    next_clock = np.zeros((2, len(sizes)), np.int64)
    next_clock[0] = sizes
    return state, next_clock


def assert_dispatch_matches(arena, cuda, state_c, fields, slots=None):
    """One dispatcher call on the card and on the CPU, from the same
    state; every field equal."""
    _make, dense, sparse = ARENAS[arena]
    state_g = type(state_c)(*(f.to(cuda) for f in state_c))
    if slots is None:
        dense(state_g, tk.ops_from_numpy(fields, cuda))
        dense(state_c, tk.ops_from_numpy(fields, CPU))
    else:
        sparse(state_g, tk.ops_from_numpy(fields, cuda), torch.from_numpy(slots).to(cuda))
        sparse(state_c, tk.ops_from_numpy(fields, CPU), torch.from_numpy(slots))
    torch.cuda.synchronize()
    for name, g, c in zip(state_c._fields, state_g, state_c):
        assert torch.equal(g.cpu(), c), name


def edge_sizes(arena, num_slots):
    """Row sizes whose need is the window and one past it: a unit row
    grows by the K run-1 inserts, an RLE row by up to 2K entries."""
    grow = num_slots if arena == "unit" else 2 * num_slots
    return [WINDOW - grow, WINDOW - grow + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
# CTA rows in the same launch; in a second launch, in shared / global memory
@pytest.mark.parametrize("width", [1024, 6000, "global"])
def test_one_launch_mixes_warp_rows_and_cta_rows(cuda, arena, width):
    width = width if width != "global" else (20_000 if arena == "unit" else 12_000)
    rng = np.random.default_rng(43)
    num_slots = 8
    sizes = [0, 3, 100, *edge_sizes(arena, num_slots), 700, 40, 900, 10, 250, 600]
    state, next_clock = typed_rows(arena, sizes, width)
    fields = random_ops(rng, next_clock, num_slots, insert_only=True, run_range=(1, 2))
    before = ARENAS[arena][1].launches
    assert_dispatch_matches(arena, cuda, state, fields)
    assert ARENAS[arena][1].launches - before == 1
    fields = random_ops(rng, next_clock, num_slots)  # inserts, deletes, noops
    assert_dispatch_matches(arena, cuda, state, fields)


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
@pytest.mark.parametrize("past", [0, 1])  # need = window, window + 1
def test_rows_at_the_window_edge(cuda, arena, past):
    rng = np.random.default_rng(47 + past)
    num_slots = 8
    size = edge_sizes(arena, num_slots)[past]
    state, next_clock = typed_rows(arena, [size] * 9, 4096)
    fields = random_ops(rng, next_clock, num_slots, insert_only=True, run_range=(1, 2))
    assert_dispatch_matches(arena, cuda, state, fields)
    grown = state.length if arena == "unit" else state.num_runs
    assert int(grown.min()) > size  # every row took its inserts


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_sixty_four_op_slots_span_two_prefetch_lanes(cuda, arena):
    rng = np.random.default_rng(53)
    state, next_clock = typed_rows(arena, [0, 5, 60, 130, 20, 0, 7, 90, 33], 1024)
    for _ in range(2):
        assert_dispatch_matches(arena, cuda, state, random_ops(rng, next_clock, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_padding_columns_beside_live_warps(cuda, arena):
    """13 routed columns (not a multiple of 8 warps), padding in the
    middle of a CTA whose other warps are live, rows on both paths."""
    rng = np.random.default_rng(59)
    num_docs = 16
    sizes = [int(x) for x in rng.integers(0, 200, num_docs)]
    sizes[3], sizes[11] = 800, 700  # CTA-path rows
    state, next_clock = typed_rows(arena, sizes, 1024)
    slots = np.asarray([3, num_docs, 5, 7, -1, 9, 11, 0, num_docs, 14, 2, 8, 1], np.int32)
    live = slots[(slots >= 0) & (slots < num_docs)]
    for _ in range(2):
        sub_clock = next_clock[:, live].copy()
        ops = random_ops(rng, sub_clock, 8)
        next_clock[:, live] = sub_clock
        fields = []
        for value, default in zip(ops, (0, 0, 0, 0, 0xFFFFFFFF, 0, 0xFFFFFFFF, 0)):
            full = np.full((8, len(slots)), default, value.dtype)
            full[:, (slots >= 0) & (slots < num_docs)] = value
            fields.append(full)
        assert_dispatch_matches(arena, cuda, state, fields, slots)


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_launch_setup_grows_its_shared_memory_in_one_process(cuda, arena):
    """Narrow rows (a window under 48 KB), then wide rows whose warp
    window and CTA row each need more: every launch in this process
    succeeds and matches the plain version."""
    rng = np.random.default_rng(61)
    for width, sizes in ((64, [0, 10, 30]), (1024, [5, 300, 900]), (4096, [50, 2000, 3000])):
        state, next_clock = typed_rows(arena, sizes, width)
        assert_dispatch_matches(arena, cuda, state, random_ops(rng, next_clock, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_served_path_through_the_extension_on_the_card(cuda, arena):
    """8 docs x 3 in-process providers through the port's server core and
    TpuMergeExtension on the card (chip_smoke.run_server at a small
    size): every provider converges, the served bytes rebuild every doc,
    and the arena's kernel launches from the server path."""
    import asyncio

    from chip_smoke import run_server

    ext, out = asyncio.run(
        run_server(np.random.default_rng(3), arena, 8, 1024, 3, rounds=3, device=cuda)
    )
    counters = out["counters"]
    assert sum(out["integrate_launches"].values()) > 0
    assert counters["cpu_fallbacks"] == 0
    assert not any(v for k, v in counters.items() if k.startswith("docs_retired_"))
    assert counters["plane_broadcasts"] > 0 and counters["sync_serves"] >= 16
    assert out["served_docs"] == 8
    assert out["warm_launches"]["unwarmed"] == 0
    assert ext.plane.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_a_failed_launch_on_the_card_fails_the_flush_and_the_sync_serve(cuda, arena, monkeypatch):
    """A kernel launch that fails on the card (a nonzero cudaError_t from
    the C entry, injected) propagates out of the extension's flush and
    out of both sync serves; no doc moves to the CPU document."""
    import asyncio

    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import TpuMergeExtension
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

    async def until(condition):
        for _ in range(3000):
            if condition():
                return
            await asyncio.sleep(0.01)
        raise AssertionError("condition not met in 30 s")

    async def body():
        reset_device_lane()
        ext = TpuMergeExtension(
            num_docs=8, capacity=1024, serve=True, arena=arena, device=cuda,
            governor=False, flush_interval_ms=60_000,
        )
        core = Hocuspocus(Configuration(quiet=True, extensions=[ext]))
        await core.ensure_configured()
        provider = HocuspocusProvider(name="d", websocket_provider=InProcessProviderSocket(core))
        provider.attach()
        await until(lambda: provider.synced)
        text = provider.document.get_text("t")
        text.insert(0, "typed at the end")
        await until(lambda: ext.plane.pending_ops() > 0)
        await ext._flush_now(max_batches=None, final=True)
        document = core.documents["d"]
        launches = {"n": 0}

        def failing_launch(self, *args):
            launches["n"] += 1
            raise RuntimeError(f"{self.source.stem} kernel launch failed: injected")

        monkeypatch.setattr(ti.KernelLibrary, "launch", failing_launch)
        try:
            for step in ("flush", "sync", "sync_async"):
                text.insert(0, f"{step}: ")  # mid-text: the integrate kernel, not the append path
                await until(lambda: ext.plane.pending_ops() > 0)
                with pytest.raises(RuntimeError, match="injected"):
                    if step == "flush":
                        await ext._flush_now(max_batches=None, final=True)
                    elif step == "sync":
                        document.sync_source.encode_state_as_update(None)
                    else:
                        await document.sync_source.encode_state_as_update_async(None)
            assert launches["n"] >= 3
            assert ext.plane.counters["cpu_fallbacks"] == 0
            assert not any(
                v for k, v in ext.plane.counters.items() if k.startswith("docs_retired_")
            )
            assert "d" in ext._docs
        finally:
            monkeypatch.undo()
            provider.destroy()
            provider.websocket_provider.destroy()
            await core.hooks("on_destroy", Payload(instance=core))

    asyncio.run(body())


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_lane_plane_on_the_card_matches_a_cpu_python_twin(cuda, arena):
    """Text-lane docs on the card (lane drain -> the fast/slow split ->
    K1/K2) against a CPU plane on the Python host path: arena element
    for element and served bytes byte for byte after every flush, with
    client ids at and above 2**31 and the integrate kernel launched."""
    from hocuspocus_tpu_torch.crdt import Doc, apply_update
    from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing

    rng = np.random.default_rng(13)
    lane = MergePlane(num_docs=16, capacity=1024, device=cuda, arena=arena)
    lane.enable_lane()
    twin = MergePlane(num_docs=16, capacity=1024, device="cpu", arena=arena)
    servings = PlaneServing(lane), PlaneServing(twin)
    to_numpy = tr.rle_state_to_numpy if arena == "rle" else tk.doc_state_to_numpy
    names = [f"d{i}" for i in range(6)]
    editors = {}
    for i, name in enumerate(names):
        assert lane.register_lane(name) is not None
        pair = []
        for client in (0x80000001 + i, 17 + i):
            doc = Doc()
            doc.client_id = client
            sent = []
            doc.on("update", lambda u, *r, sent=sent: sent.append(u))
            pair.append((doc, sent))
        editors[name] = pair
    if arena == "rle":
        dispatchers = (ti.integrate_op_slots_rle_fast, ti.integrate_op_slots_rle_sparse_fast)
    else:
        dispatchers = (ti.integrate_op_slots_fast, ti.integrate_op_slots_sparse_fast)
    launches = sum(d.launches for d in dispatchers)
    for round_no in range(6):
        for name in names:
            (a, sent_a), (b, sent_b) = editors[name]
            ta, tb = a.get_text("t"), b.get_text("t")
            ta.insert(len(ta), f"a{round_no} ")  # a tail append: the fast path
            if round_no % 2:  # a concurrent insert: the integrate kernel
                tb.insert(int(rng.integers(0, len(tb) + 1)), f"B{round_no}\U0001f600")
            stream = sent_a + sent_b
            for u in sent_a:
                apply_update(b, u)
            for u in sent_b:
                apply_update(a, u)
            sent_a.clear()
            sent_b.clear()
            for u in stream:
                assert lane.enqueue_update(name, u) == twin.enqueue_update(name, u)
        windows = [serving.build_broadcast_pairs(names) for serving in servings]
        assert windows[0] == windows[1]
        assert lane.flush() == twin.flush()
        for ours, theirs in zip(to_numpy(lane.state), to_numpy(twin.state)):
            np.testing.assert_array_equal(ours, theirs)
        for serving in servings:
            serving.refresh()
        for name in names:
            a = editors[name][0][0]
            replies = [s.encode_state_as_update(name, a, None) for s in servings]
            assert replies[0] is not None and replies[0] == replies[1]
            assert lane.text(name) == twin.text(name) == a.get_text("t").to_string()
    assert lane.counters["flush_fast_ops"] == twin.counters["flush_fast_ops"] > 0
    assert lane.counters["flush_slow_ops"] == twin.counters["flush_slow_ops"] > 0
    assert all(lane.docs[name].lane_slot is not None for name in names)
    assert not any(v for k, v in lane.counters.items() if k.startswith("docs_retired_"))
    assert sum(d.launches for d in dispatchers) > launches
