"""The port's arena residency (tpu/residency.py) against the JAX package's.

Twins of tests/tpu/test_residency.py (all but the WAL checkpoint test,
which waits for the port of `storage/`), run on the CPU. The plane-level
twins feed the same update bytes, made from a numpy seed, to the JAX
MergePlane + PlaneServing + ResidencyManager and to the port's: after
every step the arenas are equal element for element and the served
SyncStep2 bytes byte for byte (tolerance 0). The compaction programs are
held against the JAX ones on random states. The extension twins drive
the port's server core with in-process providers.
"""

import asyncio
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hocuspocus_tpu.crdt as jax_crdt
import hocuspocus_tpu_torch.crdt as port_crdt
from hocuspocus_tpu.tpu import kernels as jk
from hocuspocus_tpu.tpu import kernels_rle as jr
from hocuspocus_tpu.tpu.merge_plane import MergePlane as JaxPlane
from hocuspocus_tpu.tpu.merge_plane import PlaneDoc as JaxPlaneDoc
from hocuspocus_tpu.tpu.pallas_kernels import compact_doc_rows_fast as jax_compact_fast
from hocuspocus_tpu.tpu.pallas_kernels_rle import compact_doc_rows_rle_fast as jax_compact_rle_fast
from hocuspocus_tpu.tpu.residency import EvictedDoc as JaxEvictedDoc
from hocuspocus_tpu.tpu.residency import ResidencyManager as JaxManager
from hocuspocus_tpu.tpu.serving import PlaneServing as JaxServing
from hocuspocus_tpu_torch.tpu import (
    EvictedDoc,
    MergePlane,
    PlaneDoc,
    PlaneServing,
    ResidencyManager,
    compact_doc_rows_fast,
    compact_doc_rows_rle_fast,
)
from hocuspocus_tpu_torch.tpu import kernels as tk
from hocuspocus_tpu_torch.tpu import kernels_rle as tr
from hocuspocus_tpu_torch.tpu.kernels import KIND_INSERT, NONE_CLIENT
from hocuspocus_tpu_torch.tpu.lowering import DenseOp
from tests.test_torch_plane import assert_planes_equal
from tests.test_torch_server import Served, _assert, _served_ext, until

_INF = 0x7FFFFFFF
CLIENT_IDS = np.asarray([7, 0x9000_0001, 0xFFFF_FFF0], np.uint32)  # two >= 2**31


# -- the compaction programs ---------------------------------------------------


def random_rle_fields(rng, num_docs, entries):
    """Random RLE rows with tied ranks, dead lanes, client ids >= 2**31 and
    a clock column at the int32 edge (ck + ln wraps)."""
    cl = CLIENT_IDS[rng.integers(0, 3, (num_docs, entries))]
    ck = rng.integers(0, 6, (num_docs, entries)).astype(np.int32)
    ck[0] = 0x7FFF_FFFE
    ln = rng.integers(0, 4, (num_docs, entries)).astype(np.int32)
    rk = rng.integers(0, 10, (num_docs, entries)).astype(np.int32)
    ok = rng.integers(-1, 10, (num_docs, entries)).astype(np.int32)
    dl = rng.random((num_docs, entries)) < 0.3
    nr = rng.integers(0, entries + 1, num_docs).astype(np.int32)
    tu = rng.integers(0, 50, num_docs).astype(np.int32)
    ov = rng.random(num_docs) < 0.5
    return [cl, ck, ln, rk, ok, dl, nr, tu, ov]


def assert_rle_equal(jax_state, torch_state):
    for name, a, b in zip(jr.RleState._fields, jax_state, tr.rle_state_to_numpy(torch_state)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def assert_unit_equal(jax_state, torch_state):
    for name, a, b in zip(jk.DocState._fields, jax_state, tk.doc_state_to_numpy(torch_state)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


@pytest.mark.parametrize("seed", [0, 5, 12])
def test_compact_doc_rows_rle_matches_jax(seed):
    rng = np.random.default_rng(seed)
    num_docs, entries = 12, 24
    fields = random_rle_fields(rng, num_docs, entries)
    state_j = jr.RleState(*(jnp.asarray(f) for f in fields))
    state_t = tr.rle_state_from_numpy(fields, "cpu")
    # the num_docs sentinel pads the routing, as the plane sends it
    slots = np.asarray([3, 0, 11, 5, num_docs, num_docs, 1, num_docs], np.int32)
    state_j, counts_j = jr.compact_doc_rows_rle(state_j, jnp.asarray(slots))
    state_t, counts_t = tr.compact_doc_rows_rle(state_t, torch.from_numpy(slots))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    assert_rle_equal(state_j, state_t)
    # the dispatchers: the JAX one's XLA program, the port's plain version
    state_j, counts_j = jax_compact_rle_fast(state_j, jnp.asarray(slots[::-1].copy()))
    launches = compact_doc_rows_rle_fast.launches
    state_t, counts_t = compact_doc_rows_rle_fast(state_t, torch.from_numpy(slots[::-1].copy()))
    assert compact_doc_rows_rle_fast.launches == launches + 1
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    assert_rle_equal(state_j, state_t)


def test_compact_rle_defragments_like_jax():
    """Twin of test_compact_kernel_rle_defragments: fragments merge, a
    deleted continuation stays, a dead lane drops, the rank space stays."""
    num_docs, entries = 3, 16
    fields = [
        np.full((num_docs, entries), NONE_CLIENT, np.uint32),
        np.zeros((num_docs, entries), np.int32),
        np.zeros((num_docs, entries), np.int32),
        np.full((num_docs, entries), _INF, np.int32),
        np.full((num_docs, entries), -1, np.int32),
        np.zeros((num_docs, entries), bool),
        np.zeros(num_docs, np.int32),
        np.zeros(num_docs, np.int32),
        np.asarray([False, True, False]),
    ]
    rows = [(1, 3, 2, 3, 2, False), (1, 0, 3, 0, -1, False), (1, 5, 1, 5, 4, True),
            (3, 9, 0, 7, -1, False), (2, 0, 4, 6, 5, False)]
    for j, row in enumerate(rows):
        for f, value in enumerate(row):
            fields[f][1, j] = value
    fields[6][1], fields[7][1] = len(rows), 10
    state_j = jr.RleState(*(jnp.asarray(f) for f in fields))
    state_t = tr.rle_state_from_numpy(fields, "cpu")
    state_j, counts_j = jr.compact_doc_rows_rle(state_j, jnp.asarray([1, num_docs], jnp.int32))
    state_t, counts_t = tr.compact_doc_rows_rle(state_t, torch.tensor([1, num_docs], dtype=torch.int32))
    assert counts_t.tolist() == np.asarray(counts_j).tolist() == [3, 0]
    assert_rle_equal(state_j, state_t)
    assert int(state_t.total_units[1]) == 10 and not bool(state_t.overflow[1])


def test_compact_unit_rows_match_jax_on_crafted_rows():
    """Twin of test_compact_kernel_matches_cpu_reference: dense rank
    permutations with random tombstones, an untouched bystander row and a
    set overflow flag, through both dispatchers."""
    rng = np.random.default_rng(11)
    num_docs, width = 4, 32
    fields = [
        np.full((num_docs, width), NONE_CLIENT, np.uint32),
        np.zeros((num_docs, width), np.int32),
        np.full((num_docs, width), _INF, np.int32),
        np.full((num_docs, width), -1, np.int32),
        np.zeros((num_docs, width), bool),
        np.zeros(num_docs, np.int32),
        np.zeros(num_docs, bool),
    ]
    for d, n in ((0, 20), (1, 9), (2, 31)):
        client = CLIENT_IDS[rng.integers(0, 3, n)]
        fields[0][d, :n] = client
        fields[1][d, :n] = np.arange(n)
        fields[2][d, :n] = rng.permutation(n)
        fields[4][d, :n] = rng.random(n) < 0.4
        fields[5][d] = n
    fields[6][0] = True
    state_j = jk.DocState(*(jnp.asarray(f) for f in fields))
    state_t = tk.doc_state_from_numpy(fields, "cpu")
    slots = np.asarray([0, 2, num_docs, num_docs], np.int32)
    state_j, sizes_j = jax_compact_fast(state_j, jnp.asarray(slots))
    state_t, sizes_t = compact_doc_rows_fast(state_t, torch.from_numpy(slots))
    np.testing.assert_array_equal(sizes_t.numpy(), np.asarray(sizes_j))
    assert_unit_equal(state_j, state_t)
    assert int(state_t.length[1]) == 9, "the unrouted row is untouched"


# -- twin planes ---------------------------------------------------------------


class Refs:
    """A reference doc in each package: edits happen on the JAX doc, and
    every update it emits is applied to the port's doc too, so each
    package's manager replays its own package's document."""

    def __init__(self) -> None:
        self.j = jax_crdt.Doc()
        self.t = port_crdt.Doc()
        self.updates: list = []
        self.j.on("update", self._on_update)

    def _on_update(self, update, *rest) -> None:
        port_crdt.apply_update(self.t, update)
        self.updates.append(update)

    def state(self) -> bytes:
        full = jax_crdt.encode_state_as_update(self.j)
        assert port_crdt.encode_state_as_update(self.t) == full
        return full

    def diff(self, before: bytes) -> bytes:
        return jax_crdt.encode_state_as_update(self.j, before)

    def sv(self) -> bytes:
        return jax_crdt.encode_state_vector(self.j)

    def text(self) -> str:
        return self.j.get_text("t").to_string()


class Twin:
    """The JAX plane + serving + manager beside the port's, fed alike."""

    def __init__(self, num_docs=4, capacity=64, arena="unit", **manager) -> None:
        self.jax_plane = JaxPlane(num_docs=num_docs, capacity=capacity, arena=arena)
        self.plane = MergePlane(num_docs=num_docs, capacity=capacity, arena=arena, device="cpu")
        self.jax_serving, self.serving = JaxServing(self.jax_plane), PlaneServing(self.plane)
        self.jax_mgr = JaxManager(plane=self.jax_plane, serving=self.jax_serving, **manager)
        self.mgr = ResidencyManager(plane=self.plane, serving=self.serving, **manager)

    def register(self, name: str) -> None:
        self.jax_plane.register(name)
        self.plane.register(name)

    def enqueue(self, name: str, update: bytes, presync: bool = False) -> int:
        count = self.plane.enqueue_update(name, update, presync=presync)
        assert self.jax_plane.enqueue_update(name, update, presync=presync) == count
        return count

    def flush(self) -> None:
        assert self.jax_plane.flush() == self.plane.flush()
        self.jax_serving.refresh()
        self.serving.refresh()
        self.check()

    def check(self) -> None:
        assert_planes_equal(self.jax_plane, self.plane)
        for key in ("docs_compacted", "compactions_declined", "docs_evicted", "docs_hydrated",
                    "hydrations_declined"):
            assert self.jax_plane.counters[key] == self.plane.counters[key], key

    def serve(self, name: str, refs: Refs, sv=None) -> bytes:
        """The SyncStep2 bytes of both planes, which must be equal."""
        ours = self.serving.encode_state_as_update(name, refs.t, sv)
        assert self.jax_serving.encode_state_as_update(name, refs.j, sv) == ours
        return ours

    def doc(self, name: str):
        jax_doc, doc = self.jax_plane.docs[name], self.plane.docs[name]
        assert (jax_doc.retired, jax_doc.retire_reason) == (doc.retired, doc.retire_reason)
        return doc

    async def compact(self, name: str, **kwargs) -> bool:
        async with self.jax_plane.flush_lock:
            want = await self.jax_mgr.compact_doc_locked(name, **kwargs)
        async with self.plane.flush_lock:
            got = await self.mgr.compact_doc_locked(name, **kwargs)
        assert got == want
        self.check()
        return got


def rebuilt_text(payload: bytes) -> str:
    doc = port_crdt.Doc()
    port_crdt.apply_update(doc, payload)
    return doc.get_text("t").to_string()


async def test_overflow_compact_recycle_unit_arena():
    """A churning doc retires on capacity; its live state fits, so the
    tombstone GC recycles it in place and it serves JAX-equal bytes, with
    the origin remap re-anchoring later edits."""
    twin = Twin(num_docs=4, capacity=64, compact_threshold=0.75)
    refs = Refs()
    t = refs.j.get_text("t")
    twin.register("churny")
    twin.enqueue("churny", refs.state(), presync=True)
    for _ in range(12):
        before = refs.sv()
        t.insert(len(t), "abcdef")
        t.delete(0, 5)
        twin.enqueue("churny", refs.diff(before))
        if twin.doc("churny").retired:
            break
    doc = twin.doc("churny")
    assert doc.retired and doc.retire_reason == "capacity"
    assert doc.serve_log, "a capacity retire keeps the logs for compaction"
    assert await twin.compact("churny")
    assert not twin.doc("churny").retired
    assert twin.plane.counters["docs_compacted"] == 1
    assert twin.plane.docs["churny"].origin_remap == twin.jax_plane.docs["churny"].origin_remap

    twin.enqueue("churny", refs.state(), presync=True)  # the live-tail replay
    twin.flush()
    assert twin.plane.text("churny") == t.to_string()
    assert rebuilt_text(twin.serve("churny", refs)) == t.to_string()

    for i in range(3):
        before = refs.sv()
        t.insert(len(t), f"+{i}x")
        t.delete(0, 2)
        twin.enqueue("churny", refs.diff(before))
    twin.flush()
    assert not twin.doc("churny").retired
    assert twin.plane.text("churny") == t.to_string()
    assert rebuilt_text(twin.serve("churny", refs)) == t.to_string()


async def test_overflow_compact_recycle_rle_arena():
    """Fragmentation exhausts the run-length row; the id-preserving
    defragmenter recycles the doc, equal to the JAX plane's."""
    twin = Twin(num_docs=4, capacity=48, arena="rle", compact_threshold=0.75)
    refs = Refs()
    t = refs.j.get_text("t")
    twin.register("frag")
    twin.enqueue("frag", refs.state(), presync=True)
    for _ in range(40):
        before = refs.sv()
        t.insert(len(t), "hello")
        t.delete(1 if len(t) > 6 else 0, 3)
        twin.enqueue("frag", refs.diff(before))
        if twin.doc("frag").retired:
            break
    assert twin.doc("frag").retired
    twin.flush()
    assert await twin.compact("frag")
    assert not twin.doc("frag").retired
    twin.enqueue("frag", refs.state(), presync=True)
    twin.flush()
    assert twin.plane.text("frag") == t.to_string()
    assert rebuilt_text(twin.serve("frag", refs)) == t.to_string()


async def test_compact_declines_when_live_state_has_no_headroom():
    twin = Twin(num_docs=4, capacity=64, compact_threshold=0.75)
    refs = Refs()
    t = refs.j.get_text("t")
    twin.register("dense")
    twin.enqueue("dense", refs.state(), presync=True)
    for _ in range(10):
        before = refs.sv()
        t.insert(len(t), "0123456789")  # pure growth: everything live
        twin.enqueue("dense", refs.diff(before))
        if twin.doc("dense").retired:
            break
    doc = twin.doc("dense")
    assert doc.retired and doc.retire_reason == "capacity"
    assert not await twin.compact("dense")
    assert twin.doc("dense").retired
    assert twin.plane.counters["compactions_declined"] == 1
    assert not doc.serve_log, "a declined compaction drops the kept logs"
    assert not twin.mgr.wants_logs(doc, "capacity"), "the decline is sticky"


def _random_edits(rng, ref, steps: int) -> None:
    words = ["alpha ", "beta ", "gamma ", "zz", "q "]
    for step in range(steps):
        kind = int(rng.integers(0, 5))
        text = ref.get_text("t")
        if kind == 0:
            text.insert(int(rng.integers(0, len(text) + 1)), words[int(rng.integers(0, len(words)))])
        elif kind == 1 and len(text) > 2:
            pos = int(rng.integers(0, len(text) - 1))
            text.delete(pos, min(int(rng.integers(1, 4)), len(text) - pos))
        elif kind == 2:
            ref.get_map("m").set(f"k{int(rng.integers(0, 3))}", int(step))
        elif kind == 3:
            key = f"k{int(rng.integers(0, 3))}"
            if ref.get_map("m").get(key) is not None:
                ref.get_map("m").delete(key)
        else:
            arr = ref.get_array("a")
            if int(rng.integers(0, 3)) == 0 and len(arr) > 0:
                arr.delete(int(rng.integers(0, len(arr))), 1)
            else:
                arr.insert(int(rng.integers(0, len(arr) + 1)), [int(step)])


def _fingerprint(doc):
    return (
        doc.get_text("t").to_delta(),
        dict(doc.get_map("m").to_json()),
        doc.get_array("a").to_json(),
    )


async def _drained(*managers) -> None:
    deadline = time.monotonic() + 30
    while any(m._queue or m._drain_running for m in managers):
        assert time.monotonic() < deadline, "the hydration queue never drained"
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("arena", ["unit", "rle"])
@pytest.mark.parametrize("seed", [3, 19])
async def test_evict_hydrate_roundtrip_fuzz(seed, arena):
    """Random edits, evict, more edits on the CPU path, hydrate: both
    packages' snapshots, arenas and served bytes are equal, and the bytes
    rebuild the reference's content and state vector."""
    rng = np.random.default_rng(seed)
    twin = Twin(num_docs=8, capacity=4096, arena=arena, hydrate_batch=4)
    refs = Refs()
    twin.register("roundtrip")
    twin.enqueue("roundtrip", refs.state(), presync=True)
    for cycle in range(3):
        _random_edits(rng, refs.j, 25)
        while refs.updates:
            twin.enqueue("roundtrip", refs.updates.pop(0))
        twin.flush()
        free_before = len(twin.plane.free)
        assert await twin.jax_mgr.evict("roundtrip", refs.j)
        assert await twin.mgr.evict("roundtrip", refs.t)
        assert twin.mgr.evicted["roundtrip"].snapshot == twin.jax_mgr.evicted["roundtrip"].snapshot
        assert "roundtrip" not in twin.plane.docs and len(twin.plane.free) > free_before
        twin.check()
        mid_sv = refs.sv()

        _random_edits(rng, refs.j, 10)  # the tail rides the CPU path
        refs.updates.clear()  # the hydration's live-document replay carries it
        twin.jax_mgr.request_hydration("roundtrip", refs.j)
        twin.mgr.request_hydration("roundtrip", refs.t)
        await _drained(twin.jax_mgr, twin.mgr)
        assert not twin.mgr.is_evicted("roundtrip")
        assert twin.plane.is_supported("roundtrip"), (seed, arena, cycle)
        twin.check()
        served = twin.serve("roundtrip", refs)
        assert served is not None, (seed, arena, cycle)
        rebuilt = port_crdt.Doc()
        port_crdt.apply_update(rebuilt, served)
        assert _fingerprint(rebuilt) == _fingerprint(refs.t), (seed, arena, cycle)
        assert port_crdt.encode_state_vector(rebuilt) == port_crdt.encode_state_vector(refs.t)
        stale = twin.serve("roundtrip", refs, mid_sv)
        assert stale is not None
        peer = port_crdt.Doc()
        port_crdt.apply_update(peer, served)
        port_crdt.apply_update(peer, stale)
        assert _fingerprint(peer) == _fingerprint(refs.t)
    assert twin.plane.counters["docs_evicted"] == 3
    assert twin.plane.counters["docs_hydrated"] == 3


async def test_extension_evicts_idle_doc_and_rehydrates_on_edit():
    ext = _served_ext(evict_idle_secs=0.3)
    assert ext.residency is not None
    async with Served(ext) as served:
        a, b = served.provider("sleepy"), served.provider("sleepy")
        await served.synced(a, b)
        ext._schedule_residency()  # the maintenance timer (on_listen arms it in a server)
        a.document.get_text("t").insert(0, "written then idle")

        def evicted():
            assert ext.residency.is_evicted("sleepy")
            assert "sleepy" not in ext._docs and "sleepy" not in ext.plane.docs

        await until(evicted)
        assert ext.plane.counters["docs_evicted"] >= 1
        a.document.get_text("t").insert(0, "awake! ")

        def converged_and_rehydrated():
            assert b.document.get_text("t").to_string() == "awake! written then idle"
            assert "sleepy" in ext._docs and ext.plane.is_supported("sleepy")
            ext.plane.flush()
            assert ext.plane.text("sleepy") == "awake! written then idle"

        await until(converged_and_rehydrated)
        assert ext.plane.counters["docs_hydrated"] >= 1
        assert ext.plane.docs["sleepy"].lane_slot is not None, "the lane doc came back on the lane"
        assert ext.plane.counters["docs_retired_lane_demote"] == 0


async def _run_admission_storm(num_docs: int, storm: int, hydrate_batch: int):
    """`storm` cold snapshots burst into the hydration queue at once: every
    flush the drain issues carries at most `hydrate_batch` docs, and every
    doc comes out served with its exact content."""
    plane = MergePlane(num_docs=num_docs, capacity=64, device="cpu")
    serving = PlaneServing(plane)
    mgr = ResidencyManager(plane=plane, serving=serving, hydrate_batch=hydrate_batch)
    texts = {}
    for i in range(storm):
        ref = port_crdt.Doc()
        ref.get_text("t").insert(0, f"doc {i:05d} payload")
        texts[f"cold-{i}"] = ref.get_text("t").to_string()
        mgr.evicted[f"cold-{i}"] = EvictedDoc(port_crdt.encode_state_as_update(ref), 0.0)
    inflight_at_flush = []
    real_flush = plane.flush

    def spy_flush(*args, **kwargs):
        inflight_at_flush.append(mgr.inflight)
        return real_flush(*args, **kwargs)

    plane.flush = spy_flush
    for name in texts:
        mgr.request_hydration(name)
    assert plane.residency_stats["hydration_queue_peak"] >= storm - hydrate_batch
    await _drained(mgr)
    plane.flush = real_flush
    assert inflight_at_flush and max(inflight_at_flush) <= hydrate_batch
    assert len(inflight_at_flush) >= storm // hydrate_batch
    assert plane.counters["docs_hydrated"] == storm
    assert plane.counters["hydrations_declined"] == 0
    assert mgr.inflight == 0 and not mgr._queue
    assert plane.residency_stats["hydration_p99_ms"] > 0.0
    return plane, serving, texts


async def test_storm_admission_bounded_inflight():
    plane, serving, texts = await _run_admission_storm(num_docs=256, storm=200, hydrate_batch=32)
    serving.refresh()
    for name, want in texts.items():
        assert plane.is_supported(name) and plane.text(name) == want, name


async def test_storm_overflow_declines_without_loss():
    """More cold docs than rows: the excess is declined and counted, the
    admitted docs serve their exact content, and JAX declines alike."""
    twin = Twin(num_docs=4, capacity=64, hydrate_batch=2)
    texts = {}
    for i in range(8):
        refs = Refs()
        refs.j.get_text("t").insert(0, f"burst {i}")
        texts[f"b-{i}"] = refs.text()
        twin.jax_mgr.evicted[f"b-{i}"] = JaxEvictedDoc(refs.state(), 0.0)
        twin.mgr.evicted[f"b-{i}"] = EvictedDoc(refs.state(), 0.0)
        twin.jax_mgr.request_hydration(f"b-{i}")
        twin.mgr.request_hydration(f"b-{i}")
    await _drained(twin.jax_mgr, twin.mgr)
    twin.check()
    assert twin.plane.counters["docs_hydrated"] == 4
    assert twin.plane.counters["hydrations_declined"] == 4
    twin.serving.refresh()
    admitted = [n for n in texts if twin.plane.is_supported(n)]
    assert admitted == [n for n in texts if twin.jax_plane.is_supported(n)] and len(admitted) == 4
    for name in admitted:
        assert twin.plane.text(name) == texts[name]
    assert sum(1 for n in texts if twin.mgr.is_evicted(n)) == 4


def test_release_fuses_multi_slot_clears():
    plane = MergePlane(num_docs=8, capacity=256, device="cpu")
    ref = port_crdt.Doc()
    ref.get_text("t").insert(0, "text")
    ref.get_array("a").insert(0, [1, 2])
    ref.get_xml_fragment("x")
    plane.register("wide")
    plane.enqueue_update("wide", port_crdt.encode_state_as_update(ref), presync=True)
    plane.flush()
    doc = plane.docs["wide"]
    released = len(set(doc.seqs.values()))
    assert released >= 2, "need a multi-slot doc"
    epoch, free_before = plane.flush_epoch, len(plane.free)
    plane.release("wide")
    assert plane.flush_epoch == epoch + 1
    assert len(plane.free) == free_before + released


def test_remap_origins_chases_stacked_compactions():
    """An origin in a GC'd range re-anchors to the range's recorded
    neighbour, chasing a later compaction that removed the neighbour too;
    both packages re-anchor alike."""
    remap = {1: ([4, 10], [(4, 7, (1, 2), (1, 25)), (10, 20, (1, 5), (1, 25))])}
    edge = {1: ([0], [(0, 30, None, None)])}
    results = []
    for plane, doc_cls in (
        (JaxPlane(num_docs=4, capacity=256), JaxPlaneDoc),
        (MergePlane(num_docs=4, capacity=256, device="cpu"), PlaneDoc),
    ):
        doc = doc_cls("chained")
        doc.origin_remap.update(remap)
        op = DenseOp(kind=KIND_INSERT, client=2, clock=0, run_len=1,
                     left_client=1, left_clock=12, right_client=1, right_clock=15)
        plane._remap_origins(doc, ("root", "t"), [op])
        doc2 = doc_cls("edge")
        doc2.origin_remap.update(edge)
        op2 = DenseOp(kind=KIND_INSERT, client=2, clock=1, run_len=1,
                      left_client=1, left_clock=3, right_client=1, right_clock=29)
        plane._remap_origins(doc2, ("root", "t"), [op2])
        results.append(
            ((op.left_client, op.left_clock), (op.right_client, op.right_clock),
             (op2.left_client, op2.right_client, op2.parent))
        )
    assert results[0] == results[1]
    assert results[1][0] == (1, 2), "one hop is not enough"
    assert results[1][1] == (1, 25)
    assert results[1][2] == (NONE_CLIENT, NONE_CLIENT, ("root", "t"))


def test_forget_drops_lane_slot_tombstone_cache():
    plane = MergePlane(num_docs=4, capacity=256, device="cpu")
    plane.enable_lane()
    serving = PlaneServing(plane)
    doc = plane.register_lane("laney")
    assert doc is not None and doc.lane_slot is not None
    serving._tombstone_cache[doc.lane_slot] = ("stale", "entry")
    serving.forget("laney", doc)
    assert doc.lane_slot not in serving._tombstone_cache


def test_residency_counters_and_occupancy_exported():
    jax_plane = JaxPlane(num_docs=8, capacity=256)
    plane = MergePlane(num_docs=8, capacity=256, device="cpu")
    assert set(plane.counters) == set(jax_plane.counters) - {"total_integrated"}
    assert set(plane.residency_stats) == set(jax_plane.residency_stats)
    assert set(plane.memory_stats()) == set(jax_plane.memory_stats())
    assert plane.memory_stats()["arena_bytes"] == sum(
        np.asarray(field).nbytes for field in jax_plane.state
    )
    free, live = len(plane.free), int(plane.slot_live.sum())
    assert free + live + (plane.num_docs - free - live) == plane.num_docs


async def test_evict_declines_while_broadcast_window_pending():
    """A claimed but unshipped update blocks eviction (release would drop
    it from fan-out); once the window ships the same eviction goes through."""
    ext = _served_ext(evict_idle_secs=30.0)  # manager on; its timer never fires here
    async with Served(ext) as served:
        a = served.provider("windowed")
        await served.synced(a)
        a.document.get_text("t").insert(0, "claimed update")

        def settled():
            ext.plane.flush()
            assert ext.plane.text("windowed") == "claimed update"
            assert not ext.residency._has_unshipped(ext.plane.docs.get("windowed"))

        await until(settled)
        document = ext._docs["windowed"]
        real_broadcast = ext._broadcast_served
        ext._broadcast_served = lambda *a, **k: None
        ext.plane.dirty.add("windowed")
        assert not await ext.residency.evict("windowed", document)
        assert "windowed" in ext._docs and not ext.residency.is_evicted("windowed")
        ext._broadcast_served = real_broadcast
        ext.plane.dirty.discard("windowed")
        assert await ext.residency.evict("windowed", document)
        assert ext.residency.is_evicted("windowed") and "windowed" not in ext._docs


async def test_preserved_retired_doc_reclaimed_by_sweep():
    """A health-sweep retire (no recycle seam runs) keeps the doc's logs;
    the maintenance pass compacts it back onto the plane."""
    ext = _served_ext(compact_threshold=0.75, native_lane=False)
    async with Served(ext) as served:
        a = served.provider("swept")
        await served.synced(a)
        t = a.document.get_text("t")
        t.insert(0, "abcdefgh")
        t.delete(0, 4)

        def flushed():
            ext.plane.flush()
            assert ext.plane.text("swept") == "efgh"
            assert ext.plane.pending_ops() == 0 and "swept" not in ext.plane.dirty

        await until(flushed)
        ext.plane.retire_doc("swept", "overflow")
        ext._fallback_to_cpu(ext._docs["swept"])
        doc = ext.plane.docs["swept"]
        assert doc.retired and doc.serve_log and "swept" in ext.residency._preserved
        ext._instance = served.core
        await ext.residency._visit_preserved()
        assert not ext.plane.docs["swept"].retired and ext.plane.is_supported("swept")
        assert "swept" in ext._docs and "swept" not in ext.residency._preserved
        assert ext.plane.counters["docs_compacted"] >= 1

        def serves_again():
            ext.plane.flush()
            assert ext.plane.text("swept") == "efgh"

        await until(serves_again)


def _stream_edit(rng, text, live: int, words: tuple, delete: tuple) -> None:
    """chip_smoke.py's compaction stream: random-position inserts of a few
    words and deletes, deletes likelier as the live text passes `live`."""
    names = ["alpha ", "béta ", "γ", "zz ", "e", "plane "]
    length = len(text)
    if length > 16 and rng.random() < min(0.95, length / live):
        pos = int(rng.integers(0, length - 1))
        text.delete(pos, min(int(rng.integers(*delete)), length - pos))
    else:
        picked = rng.integers(0, len(names), int(rng.integers(*words)))
        text.insert(int(rng.integers(0, length + 1)), "".join(names[w] for w in picked))


@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_compaction_under_random_position_edits_matches_jax(arena):
    """Rows filled by random-position inserts and deletes retire, and both
    managers compact and replay them: arenas and served bytes equal to the
    JAX package's after every round, and the bytes rebuild the text on
    both arenas. (Where the unit rebuild would not decode, the port
    declines instead: test_unit_compaction_declines_where_the_rebuild_would_not_decode.)"""
    rng = np.random.default_rng(7)
    stream = (
        {"live": 400, "words": (10, 61), "delete": (20, 201), "edits": 4}
        if arena == "unit"
        else {"live": 400, "words": (1, 6), "delete": (1, 5), "edits": 64}
    )
    twin = Twin(num_docs=4, capacity=2048, arena=arena, compact_threshold=0.75)
    refs = Refs()
    twin.register("d")
    compactions = after = 0
    for _round in range(120):
        t = refs.j.get_text("t")
        refs.j.transact(
            lambda _tr: [
                _stream_edit(rng, t, stream["live"], stream["words"], stream["delete"])
                for _ in range(stream["edits"])
            ]
        )
        while refs.updates:
            twin.enqueue("d", refs.updates.pop(0))
        twin.flush()
        assert (twin.jax_serving.doc_healthy("d") is None) == (twin.serving.doc_healthy("d") is None)
        if twin.doc("d").retired:
            assert await twin.compact("d")
            compactions += 1
            # the live-tail replay (the full state, as compact-and-replay
            # sends it); on the run-length arena its delete set can push
            # the host projection past capacity again, alike on both sides
            twin.enqueue("d", refs.state(), presync=True)
            twin.flush()
            if twin.doc("d").retired:
                break
        served = twin.serve("d", refs)
        assert served is not None
        assert rebuilt_text(served) == refs.text()
        after += compactions > 0
        if after == 4:  # four rounds of traffic on the compacted rows
            break
    assert compactions >= 1
    assert twin.plane.docs["d"].origin_remap == twin.jax_plane.docs["d"].origin_remap


async def test_unit_compaction_declines_where_the_rebuild_would_not_decode():
    """A row whose live text holds a client's later clocks before its
    earlier ones (typing at the front) retires on capacity. The JAX
    package compacts it into a serve log that chains each live run to its
    rank predecessor, which names the later clock as the earlier run's
    origin, and a Yjs decoder refuses those bytes (ROADMAP.md, Queue C).
    The port declines that compaction, counted like any decline, and
    leaves the doc as it was; the snapshot recycle cannot take it back
    either, since the snapshot's tombstones fill the row again."""
    twin = Twin(num_docs=4, capacity=64, compact_threshold=0.75)
    refs = Refs()
    t = refs.j.get_text("t")
    twin.register("front")
    t.insert(0, "abcdefgh")
    t.insert(0, "XY")  # later clocks of the same client, before the earlier
    twin.enqueue("front", refs.state(), presync=True)
    for _ in range(12):
        before = refs.sv()
        t.insert(len(t), "uvwxyz")
        t.delete(len(t) - 6, 5)
        twin.enqueue("front", refs.diff(before))
        if twin.doc("front").retired:
            break
    assert twin.doc("front").retired and twin.doc("front").retire_reason == "capacity"
    async with twin.jax_plane.flush_lock:
        assert await twin.jax_mgr.compact_doc_locked("front")
    async with twin.plane.flush_lock:
        assert not await twin.mgr.compact_doc_locked("front")
    assert twin.plane.counters["compactions_declined"] == 1
    assert twin.plane.counters["docs_compacted"] == 0
    assert twin.plane.docs["front"].retired, "a declined compaction leaves the doc as it was"

    twin.jax_plane.enqueue_update("front", refs.state(), presync=True)
    twin.jax_plane.flush()
    twin.jax_serving.refresh()
    jax_served = twin.jax_serving.encode_state_as_update("front", refs.j)
    with pytest.raises((KeyError, RuntimeError)):  # the origin's struct is not there
        rebuilt_text(jax_served)

    # what the snapshot recycle (TpuMergeExtension._recycle_capacity_doc_admitted)
    # would register: the full state's tombstones retire the row again
    plane = twin.plane
    plane.release("front")
    plane.register("front")
    plane.enqueue_update("front", refs.state(), presync=True)
    assert plane.docs["front"].retired and plane.docs["front"].retire_reason == "capacity"


async def test_extension_serves_a_declined_unit_compaction_from_the_cpu_document():
    """Through the extension: a unit doc typed at the front and churned
    past its row retires; compact-and-replay declines (the rebuild would
    not decode) and so does the snapshot recycle (no headroom), so the doc
    goes on from the CPU document, counted as a fallback, and every
    client and a late joiner converge on its text."""
    ext = _served_ext(compact_threshold=0.75, native_lane=False, capacity=64)
    async with Served(ext) as served:
        a, b = served.provider("front"), served.provider("front")
        await served.synced(a, b)
        t = a.document.get_text("t")
        t.insert(0, "abcdefgh")
        t.insert(0, "XY")
        await until(lambda: _assert(b.document.get_text("t").to_string() == "XYabcdefgh"))
        for _ in range(12):
            t.insert(len(t), "uvwxyz")
            t.delete(len(t) - 6, 5)
            await asyncio.sleep(0.01)
        expected = t.to_string()
        await until(lambda: _assert("front" not in ext._docs and "front" in ext._recycle_declined))
        assert ext.plane.counters["compactions_declined"] >= 1
        assert ext.plane.counters["docs_compacted"] == 0
        assert ext.plane.counters["cpu_fallbacks"] >= 1
        await until(lambda: _assert(b.document.get_text("t").to_string() == expected))
        c = served.provider("front")
        await served.synced(c)
        await until(lambda: _assert(c.document.get_text("t").to_string() == expected))
