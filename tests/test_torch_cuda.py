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


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_compaction_on_the_card_matches_the_plain_version(cuda, arena):
    """The compaction program on arena rows the kernel integrated, against
    the same program on the plain version's rows on the CPU: routed rows
    (the num_docs sentinel padding the routing) and the packed sizes equal,
    unrouted rows untouched."""
    rng = np.random.default_rng(41)
    num_docs, width, num_slots = 32, 512, 8
    next_clock = np.zeros((2, num_docs), np.int64)
    module = tr if arena == "rle" else tk
    make = module.make_empty_rle_state if arena == "rle" else module.make_empty_state
    dispatcher = ti.integrate_op_slots_rle_fast if arena == "rle" else ti.integrate_op_slots_fast
    compact = ti.compact_doc_rows_rle_fast if arena == "rle" else ti.compact_doc_rows_fast
    state_g, state_c = make(num_docs, width, cuda), make(num_docs, width, CPU)
    for _ in range(4):
        fields = random_ops(rng, next_clock, num_slots)
        dispatcher(state_g, tk.ops_from_numpy(fields, cuda))
        dispatcher(state_c, tk.ops_from_numpy(fields, CPU))
    slots = np.asarray([3, 0, 17, 31, 9, num_docs, num_docs, num_docs], np.int32)
    launches = compact.launches
    state_g, sizes_g = compact(state_g, torch.from_numpy(slots).to(cuda))
    state_c, sizes_c = compact(state_c, torch.from_numpy(slots))
    torch.cuda.synchronize()
    assert compact.launches == launches + 2
    assert torch.equal(sizes_g.cpu(), sizes_c)
    for g, c in zip(state_g, state_c):
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_canary_on_the_card(cuda, arena):
    """The supervisor's canary on a card plane: one sparse kernel launch at
    (K_max, 1) on the plane's stream, a readback, and the arena unchanged
    (equal to a CPU twin fed the same traffic)."""
    from hocuspocus_tpu_torch.crdt import Doc, encode_state_as_update
    from hocuspocus_tpu_torch.tpu import MergePlane

    card = MergePlane(num_docs=16, capacity=1024, device=cuda, arena=arena)
    twin = MergePlane(num_docs=16, capacity=1024, device="cpu", arena=arena)
    for i in range(5):
        doc = Doc()
        doc.get_text("t").insert(0, f"canary doc {i}")
        for plane in (card, twin):
            plane.register(f"d{i}")
            plane.enqueue_update(f"d{i}", encode_state_as_update(doc), presync=True)
            plane.flush()
    sparse = ti.integrate_op_slots_rle_sparse_fast if arena == "rle" else ti.integrate_op_slots_sparse_fast
    launches = sparse.launches
    seconds = card.canary_probe()
    assert seconds > 0 and sparse.launches == launches + 1
    for g, c in zip(card.state, twin.state):
        assert torch.equal(g.cpu(), c)
    assert card.text("d3") == "canary doc 3"


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_supervised_and_compaction_phases_on_the_card(cuda, arena):
    """chip_smoke's supervised deployment (no `device`: the card) and its
    compaction phase at a few docs: READY, every doc evicted and hydrated
    back, no fallback; every row compacted (or declined on the unit arena
    where the rebuild would not decode), card and twin equal."""
    import asyncio

    from chip_smoke import COMPACT_TWINS, run_compact_plane, run_supervised_server

    _ext, out = asyncio.run(
        run_supervised_server(np.random.default_rng(5), arena, 8, 1024, 3, 1, evict_idle_secs=0.5)
    )
    assert out["supervisor"]["state"] == "ready" and out["evicted"] == 8
    assert out["storm_hydrated"] >= 8 and out["cpu_fallbacks_by_cause"]["other"] == 0
    assert sum(out["integrate_launches"].values()) > 0
    compacted = asyncio.run(
        run_compact_plane(np.random.default_rng(3), arena, 4, 2048, device=cuda, twin=COMPACT_TWINS[arena])
    )
    declined = compacted["declined_undecodable"]  # unit rows whose rebuild would not decode
    assert declined == 0 or arena == "unit"
    assert compacted["retired_now"] == declined and compacted["compactions"] == 4 - declined
    assert compacted["max_abs_err"] == 0 and compacted["compact_device_ms"] > 0
    assert sum(compacted["integrate_launches"].values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_metrics_and_wal_beside_the_supervised_plane_on_the_card(cuda, arena):
    """The CLI's --tpu-serve --metrics --wal-dir deployment on the card at
    a few docs (chip_smoke.run_supervised_server, which checks each):
    /metrics equals the plane's counters and reads READY, every evicted
    doc's log is its checkpoint, a fresh WalManager replays every doc to
    its served state, and a one-second torch.profiler capture names the
    arena's kernel."""
    import asyncio

    from chip_smoke import ARENAS, run_supervised_server

    _ext, out = asyncio.run(
        run_supervised_server(
            np.random.default_rng(5), arena, 8, 1024, 3, 1, evict_idle_secs=0.5,
            device_profile_secs=1.0,
        )
    )
    assert out["wal_checkpoints"] == 8 and out["wal"]["docs"] == 8
    assert out["scrapes"]["joins"]["wal_appended_records"] >= out["edits_sent"]
    assert "CUDA" in out["device_profile"]["activities"]
    kernels = out["device_profile"]["kernels"]
    assert any(name in k for k in kernels for name in ARENAS[arena]["kernels"]), kernels


@pytest.mark.cuda
def test_cli_and_loadgen_phases_on_the_card(cuda):
    """The entry points' smoke phases on the card at a few docs (each
    checks itself): the CLI in a process of its own serves every doc
    byte-identically to its providers and a joiner, /metrics counts every
    edit integrated, SIGTERM drains with exit code 0 and a second process
    replays the WAL; the scenario runner's smoke passes, replication_lag's
    acknowledged edits are all observed on the other instance, and the
    edge scenarios pass with writers and readers converged."""
    import asyncio

    from chip_smoke import run_cli_server, run_loadgen

    out = asyncio.run(
        run_cli_server(np.random.default_rng(5), 16, extra_args=("--tpu-docs", "64"))
    )
    assert out["replay"]["docs"] == 16 and out["ops_integrated"] == out["edits"] == 32
    assert out["k1_launches"]["first"] > 0
    assert out["server_profile"]["device_events"] >= 0
    scenarios = asyncio.run(run_loadgen(16))
    assert scenarios["smoke"]["verdict"] == "pass"
    assert scenarios["replication_lag"]["acked"]["docs_observed"] == 16
    for name in ("edge_fanout", "edge_handoff"):
        assert scenarios[name]["verdict"] == "pass", scenarios[name]
        assert scenarios[name]["convergence"]["converged"], scenarios[name]


async def _supervised_on_the_card(arena):
    """A SupervisedTpuMergeExtension without `device` (the card) in the
    port's core, its listen hook fired: (extension, core)."""
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import SupervisedTpuMergeExtension
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

    reset_device_lane()
    ext = SupervisedTpuMergeExtension(
        num_docs=8, capacity=1024, serve=True, arena=arena, watchdog_interval=0.1,
    )
    core = Hocuspocus(Configuration(quiet=True, extensions=[ext]))
    await core.ensure_configured()
    await core.hooks("on_listen", Payload(instance=core, port=None))
    return ext, core


async def _until(condition, what):
    import asyncio

    for _ in range(6000):
        if condition():
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"{what} not met in 60 s")


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_a_failed_kernel_build_stops_the_supervised_server(cuda, arena, monkeypatch):
    """A kernel library that does not build (injected into the runtime
    factory's `load_kernels`) stops the supervised server on the card: the
    supervisor goes BROKEN with the error, and no plane is served."""
    import asyncio

    from hocuspocus_tpu_torch.server.types import Payload

    def failing_build(self):
        raise RuntimeError(f"nvcc failed for {self.source.name}: injected")

    monkeypatch.setattr(ti.KernelLibrary, "get", failing_build)

    async def body():
        ext, core = await _supervised_on_the_card(arena)
        try:
            await _until(lambda: ext.supervisor.state == "broken", "a BROKEN supervisor")
            assert "injected" in str(ext.supervisor.fault)
            assert ext.supervisor.counters["card_faults"] == 1 and ext.runtime is None
            assert ext.health_status()["degraded"]
        finally:
            await core.hooks("on_destroy", Payload(instance=core))

    asyncio.run(body())


@pytest.mark.cuda
@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_a_failed_canary_launch_stops_the_supervised_server(cuda, arena, monkeypatch):
    """A canary whose kernel launch fails on the card (a nonzero
    cudaError_t from the C entry, injected) raises out of the canary and
    stops serving: BROKEN, no breaker trip, the served doc not moved to the
    CPU document, new connections refused."""
    import asyncio

    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
    from hocuspocus_tpu_torch.server.types import Payload

    async def body():
        ext, core = await _supervised_on_the_card(arena)
        providers = []

        def provider():
            p = HocuspocusProvider(name="d", websocket_provider=InProcessProviderSocket(core))
            p.attach()
            providers.append(p)
            return p

        try:
            await _until(lambda: ext.supervisor.state == "ready", "READY")
            await ext.runtime.warmup_task
            first = provider()
            await _until(lambda: first.synced and ext.runtime.is_served("d"), "a served doc")
            probes = ext.supervisor.counters["canary_probes"]

            def failing_launch(self, *args):
                raise RuntimeError(f"{self.source.stem} kernel launch failed: injected")

            # the next launch is the watchdog's canary (no edit is pending)
            monkeypatch.setattr(ti.KernelLibrary, "launch", failing_launch)
            await _until(lambda: ext.supervisor.state == "broken", "a BROKEN supervisor")
            monkeypatch.undo()
            assert "injected" in str(ext.supervisor.fault)
            assert ext.supervisor.counters["canary_probes"] > probes
            assert ext.supervisor.counters["canary_errors"] == 1
            assert ext.supervisor.counters["card_faults"] == 1
            assert not ext.supervisor.breaker.transitions
            assert ext.plane.counters["cpu_fallbacks"] == 0 and ext.runtime.is_served("d")
            refused = []
            late = provider()
            late.on("authentication_failed", refused.append)
            await _until(lambda: refused, "the refusal")
            assert not late.synced
        finally:
            monkeypatch.undo()
            for p in providers:
                p.destroy()
                p.websocket_provider.destroy()
            await core.hooks("on_destroy", Payload(instance=core))

    asyncio.run(body())


@pytest.mark.cuda
def test_redis_fanout_between_two_planes_on_the_card(cuda):
    """BASELINE config 4's two-instance topology at 16 docs
    (chip_smoke.run_cluster_server, which checks convergence on both
    instances and the served bytes): two served planes on the card behind
    the port's Redis extension; K1 launches, no CPU fallback."""
    import asyncio

    from chip_smoke import run_cluster_server

    out = asyncio.run(run_cluster_server(np.random.default_rng(5), 16, 1024, device=cuda))
    assert sum(out["integrate_launches"].values()) > 0, out["integrate_launches"]
    for side in ("a", "b"):
        counters = out["counters"][side]
        assert counters["cpu_fallbacks"] == 0, (
            side, counters, out["settle_counters"]
        )
        assert counters["docs_retired_unsupported"] == 0, (side, counters)
        assert counters["plane_broadcasts"] > 0, (side, counters)
        assert out["served_docs"][side] == 16, (side, out["served_docs"])


@pytest.mark.cuda
def test_edge_topology_on_the_card(cuda):
    """The split front door at 16 docs (chip_smoke.run_edge_server, which
    checks every reader byte-identical to its writer after each round, the
    hot doc's follower byte-identical to its owner, every doc on the
    survivor byte-identical to its writer and rebuilt from its served
    bytes): two cells with card planes behind two edges, a follower and a
    drain under traffic; K1 launches on both planes, no CPU fallback, no
    client-visible disconnect."""
    import asyncio

    from chip_smoke import run_edge_server

    out = asyncio.run(
        run_edge_server(np.random.default_rng(5), 16, 1024, device=cuda, rows=64,
                        hot_readers=16, watermark=4)
    )
    assert sum(out["integrate_launches"].values()) > 0, out["integrate_launches"]
    assert out["launches_outside_flush"] == 0, out["launches_outside_flush"]
    assert sum(out["cell_launches"].values()) == sum(out["integrate_launches"].values())
    for cell, launches in out["cell_launches"].items():
        assert launches > 0 and out["k1_ops"][cell] > 0, (out["cell_launches"], out["k1_ops"])
        assert out["counters"][cell]["cpu_fallbacks"] == 0, (cell, out["counters"][cell])
        assert out["ops_integrated"][cell] > 0, out["ops_integrated"]
    assert out["served_docs"][out["survivor"]] == 16 and out["rebuilt"] == 16
    assert out["hot_doc"]["replica_serves"][out["hot_doc"]["owner"]]["snapshot"] >= 1, out["hot_doc"]
    assert not any(out["hot_doc"]["cpu_fallbacks"].values()), out["hot_doc"]
    assert not out["client_closes"], out["client_closes"]


@pytest.mark.cuda
def test_four_cells_on_the_card_migrate_a_doc_under_edits(cuda):
    """Four per-device cells wrapped onto the card, each with its own lane:
    a doc migrates between two cells while its editor types, nothing it
    acknowledged is lost; then the multi-device phase at 32 docs
    (chip_smoke.run_multi_device_server, through its gates) launches K1
    in every cell's flushes, migrates docs in its skew round and degrades
    and restores one late cell alone."""
    import asyncio

    import chip_smoke
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import MultiDeviceMergeExtension
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

    async def migrate_under_edits():
        reset_device_lane()
        ext = MultiDeviceMergeExtension(devices=4, num_docs=16, capacity=1024, serve=True,
                                        flush_interval_ms=1, rebalance_interval_s=0)
        assert all(cell.plane.device.type == "cuda" for cell in ext.cells)
        assert len({id(cell.lane) for cell in ext.cells}) == 4
        core = Hocuspocus(Configuration(quiet=True, extensions=[ext]))
        await core.ensure_configured()
        await core.hooks("on_listen", Payload(instance=core, port=None))
        providers = [HocuspocusProvider(name="card-mig", websocket_provider=InProcessProviderSocket(core))
                     for _ in range(2)]
        try:
            for p in providers:
                p.attach()
            await _until(lambda: all(p.synced for p in providers), "synced editors")
            a, b = providers
            a.document.get_text("t").insert(0, "before;")
            await _until(lambda: b.document.get_text("t").to_string() == "before;", "the first edit")
            src = ext.cell_index_for("card-mig")
            dst = (src + 1) % 4

            async def edits():
                for i in range(20):
                    a.document.get_text("t").insert(0, f"e{i};")
                    await asyncio.sleep(0.002)

            task = asyncio.ensure_future(edits())
            moved = False
            for _ in range(100):
                if await ext.migrate_doc("card-mig", src, dst):
                    moved = True
                    break
                await asyncio.sleep(0.01)
            await task
            assert moved, ext.migration_stats
            await _until(lambda: "card-mig" in ext.cells[dst]._docs, "the doc on its target cell")
            a.document.get_text("t").insert(0, "after;")
            await _until(lambda: b.document.get_text("t").to_string() == a.document.get_text("t").to_string()
                         and "after;" in b.document.get_text("t").to_string(), "convergence")
            text = b.document.get_text("t").to_string()
            assert all(f"e{i};" in text for i in range(20)), text
            assert ext.cells[dst].plane.counters["cpu_fallbacks"] == 0
        finally:
            for p in providers:
                p.destroy()
                p.websocket_provider.destroy()
            await core.hooks("on_destroy", Payload(instance=core))

    asyncio.run(migrate_under_edits())
    out = asyncio.run(chip_smoke.run_multi_device_server(np.random.default_rng(5), 32, 4096, rows=64, chunk=16))
    launches = chip_smoke.check_multi_device(out, 32, chip_smoke.MULTI_CUTS, on_card=True)
    assert launches > 0 and all(n > 0 for n in out["cell_launches"].values()), out["cell_launches"]
    assert out["migrations"]["in_skew_round"] >= 1


@pytest.mark.cuda
def test_tiptap_doc_through_the_webhook_on_the_run_length_plane(cuda, monkeypatch):
    """A Tiptap doc loaded through the Webhook and the transformer, edited
    in bursts, checkpointed and restored by History, stored and reloaded
    by SQLite, on the run-length plane on the card
    (chip_smoke.run_tiptap_server at 4 docs, 2 of them checkpointed and
    restored): K2 launches, no CPU fallback. A restore writes a fresh XML
    tree, 5 more arena rows until the doc recycles, so the plane's 8 rows
    a doc leave room for 2 restores at this size."""
    import asyncio

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "TIPTAP_CHECKPOINTS", 2)
    out = asyncio.run(
        chip_smoke.run_tiptap_server(np.random.default_rng(5), 4, 4096, device=cuda, webhook_debounce_ms=200)
    )
    assert sum(out["integrate_launches"].values()) > 0
    assert out["counters"]["cpu_fallbacks"] == 0, out["cpu_fallbacks_after"]
    assert out["counters"]["docs_retired_unsupported"] == 0
    assert out["served_docs"] == 4 and out["webhook"]["bad_signatures"] == 0


@pytest.mark.cuda
def test_fleet_controller_activates_and_parks_cells_on_the_card(cuda):
    """Four cells wrapped onto the card under the fleet controller with two
    warm spares: the controller boots with cells 2 and 3 parked; an
    injected hot digest activates cell 2, then a cold one naming cell 1
    the coldest parks it while its ~256 docs' editors type (its docs
    migrate to cells 0 and 2 over the evict -> hydrate rail); nothing
    acknowledged is lost, no client closes, the parked cell holds no doc
    and its lane admits nothing but canaries afterwards, and K1 launches
    with ops of its own in the flushes of every active cell (counted at
    the wrapper under the cell, chip_smoke.CellLaunches). Prints the
    park's seconds and docs migrated (`fleet_card:`; run with -s)."""
    import asyncio
    import json
    import time

    import chip_smoke
    from hocuspocus_tpu_torch.crdt import encode_state_as_update
    from hocuspocus_tpu_torch.fleet import FleetControllerExtension
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import MultiDeviceMergeExtension
    from hocuspocus_tpu_torch.tpu.scheduler import CLASS_CANARY, reset_device_lane

    num_docs = 512
    rng = np.random.default_rng(5)

    async def body():
        reset_device_lane()
        ext = MultiDeviceMergeExtension(devices=4, num_docs=512, capacity=1024, serve=True,
                                        flush_interval_ms=1, rebalance_interval_s=0)
        fleet = FleetControllerExtension(interval_s=3600.0, warm_spares=2, min_cells=1, hold_ticks=1,
                                         cooldown_ticks=0, work_target=100.0)
        core = Hocuspocus(Configuration(quiet=True, extensions=[ext, fleet]))
        await core.ensure_configured()
        await core.hooks("on_listen", Payload(instance=core, port=None))
        for cell in ext.cells:
            await cell.warmup_task
        assert fleet.active_cells() == [0, 1] and ext.placement.healthy == {0, 1}

        def digest(loads):
            return [{"cell": i, "healthy": i in ext.placement.healthy, "work_rate": w}
                    for i, w in enumerate(loads)]

        # every flush marked from the first; counting starts with no flush
        # in flight (one in flight would count outside every cell)
        counts = chip_smoke.CellLaunches(ext.cells)

        names = [f"fleet-card-{i}" for i in range(num_docs)]
        editors = {}
        closes = []
        try:
            for base in range(0, num_docs, 64):
                wave = []
                for name in names[base:base + 64]:
                    editors[name] = [HocuspocusProvider(name=name, websocket_provider=InProcessProviderSocket(core))
                                     for _ in range(2)]
                    wave += editors[name]
                for p in wave:
                    p.on("close", lambda *_a, **_k: closes.append(1))
                    p.attach()
                await _until(lambda: all(p.synced for p in wave), "synced editors")
            assert not ext.cells[2]._docs and not ext.cells[3]._docs
            for d, name in enumerate(names):
                editors[name][0].document.get_text("t").insert(0, chip_smoke.WORDS[d % len(chip_smoke.WORDS)])

            def converged():
                return all(len({encode_state_as_update(p.document) for p in editors[n]}
                               | {encode_state_as_update(core.documents[n])}) == 1 for n in names)

            await _until(converged, "the first words")
            await _until(lambda: not any(c.plane.pending_ops() or c._flush_inflight for c in ext.cells),
                         "the queues drained")
            counts.start()
            slow0 = [cell.plane.counters["flush_slow_ops"] for cell in ext.cells]

            async def edit_round():
                for d, name in enumerate(names):
                    for p in editors[name]:
                        chip_smoke._server_edit(rng, p.document.get_text("t"))
                    if d % 16 == 15:
                        await asyncio.sleep(0.001)

            with counts.counted():
                up = await fleet.tick_once(cells=digest([90.0, 90.0, 0.0, 0.0]))
                assert up["action"] == "scale_up" and up["cell"] == 2, up
                assert ext.placement.healthy == {0, 1, 2}
                held = sorted(ext.cells[1]._docs)
                edits = asyncio.ensure_future(edit_round())
                t0 = time.perf_counter()
                down = await fleet.tick_once(cells=digest([20.0, 0.0, 20.0, 0.0]))
                park_s = time.perf_counter() - t0
                assert down["action"] == "scale_down" and down["cell"] == 1, down
                retries = 0
                while ext.cells[1]._docs and retries < 50:
                    retries += 1
                    await asyncio.sleep(0.02)
                    await ext.park_cell(1)
                await edits
                assert not ext.cells[1]._docs and 1 not in ext.placement.healthy
                parked_admissions = list(ext.cells[1].lane.class_admissions)
                await _until(lambda: all(n in ext.cells[0]._docs or n in ext.cells[2]._docs for n in held),
                             "the migrated docs hydrated on the survivors")
                await edit_round()
                await _until(converged, "convergence after the park")
            assert all(not p.has_unsynced_changes for group in editors.values() for p in group)
            assert not closes
            after = list(ext.cells[1].lane.class_admissions)
            after[CLASS_CANARY] = parked_admissions[CLASS_CANARY]
            assert after == parked_admissions, (parked_admissions, ext.cells[1].lane.class_admissions)
            k1_ops = [cell.plane.counters["flush_slow_ops"] - slow0[i] for i, cell in enumerate(ext.cells)]
            for i in (0, 2):
                assert counts.flush_launches[i] > 0 and k1_ops[i] > 0, (i, dict(counts.flush_launches), k1_ops)
            assert counts.flush_launches[None] == 0
            assert sum(ext.cells[i].plane.counters["cpu_fallbacks"] for i in range(4)) == 0
            print("fleet_card:", json.dumps({
                "docs_on_parked_cell": len(held), "park_seconds": round(park_s, 3), "park_retries": retries,
                "docs_migrated": fleet.actuation["docs_migrated"], "cell_launches": dict(counts.flush_launches),
                "k1_ops": k1_ops, "gpu": chip_smoke.nvidia_smi_line(),
            }))
        finally:
            for group in editors.values():
                for p in group:
                    p.destroy()
                    p.websocket_provider.destroy()
            await core.hooks("on_destroy", Payload(instance=core))

    asyncio.run(body())


@pytest.mark.cuda
def test_fleet_server_phase_on_the_card(cuda):
    """The fleet_server phase at 64 docs on the card, through its own
    gates (chip_smoke.check_fleet), the diurnal rates and the fresh
    sessions scaled to the docs."""
    import asyncio

    import chip_smoke

    out = asyncio.run(chip_smoke.run_fleet_server(
        np.random.default_rng(5), 64, 4096, rows=128, chunk=16, peak_rate=128.0, work_target=150.0,
        phase_s=4.0, night_max_s=30.0, fresh_rate=4.0,
    ))
    assert chip_smoke.check_fleet(out, 64, chip_smoke.FLEET_CUTS, on_card=True) > 0
