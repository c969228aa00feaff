"""Twins of the JAX package's plane fuzz (tests/tpu/test_plane_fuzz.py).

Random mixed-content edit streams (plain and rich text, maps, arrays, XML
trees, embeds), made from numpy seeds by the JAX test's own `_random_edit`,
go as wire updates to the JAX MergePlane + PlaneServing and to the port's
(`device="cpu"`), over both arenas, many seeds in one process. After every
flush the arenas must be equal element for element and the served
SyncStep2 bytes byte for byte, and the bytes must rebuild the reference
doc. The reload twin loads fresh planes from a snapshot mid-stream (the
hydration path's input, GC structs included once subtrees are deleted).

Where the JAX plane misses (serves None, as its reload fuzz does now and
then at seed 17), the port must still serve: that step is skipped for the
byte comparison, the JAX side is not compared again until the next reload,
and every skip is recorded (a warning naming the seed and step). A skip is
never counted as agreement.
"""

import warnings

import pytest

import hocuspocus_tpu_torch.crdt as port_crdt
from hocuspocus_tpu.tpu.merge_plane import MergePlane as JaxPlane
from hocuspocus_tpu.tpu.serving import PlaneServing as JaxServing
from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing
from tests.test_torch_plane import assert_planes_equal
from tests.test_torch_residency import Refs
from tests.tpu.test_plane_fuzz import _doc_fingerprint, _random_edit

import numpy as np


def planes(arena: str, num_docs: int, capacity: int, name: str):
    jax_plane = JaxPlane(num_docs=num_docs, capacity=capacity, arena=arena)
    plane = MergePlane(num_docs=num_docs, capacity=capacity, arena=arena, device="cpu")
    for p in (jax_plane, plane):
        p.register(name)
    return jax_plane, JaxServing(jax_plane), plane, PlaneServing(plane)


def rebuilt_fingerprint(payload: bytes):
    doc = port_crdt.Doc()
    port_crdt.apply_update(doc, payload)
    return _doc_fingerprint(doc)


def mixed_content_stream(seed: int, arena: str) -> None:
    rng = np.random.default_rng(seed)
    refs = Refs()
    jax_plane, jax_serving, plane, serving = planes(arena, 64, 2048, "fuzz")
    for step in range(120):
        _random_edit(rng, refs.j, step)
        while refs.updates:
            update = refs.updates.pop(0)
            assert plane.enqueue_update("fuzz", update) == jax_plane.enqueue_update("fuzz", update)
        if step % 10 == 9:
            assert plane.flush() == jax_plane.flush()
            jax_serving.refresh()
            serving.refresh()
            assert_planes_equal(jax_plane, plane)
            assert plane.is_supported("fuzz") == jax_plane.is_supported("fuzz") is True, (seed, step)
            served = serving.encode_state_as_update("fuzz", refs.t, None)
            assert served is not None, (seed, step)
            assert served == jax_serving.encode_state_as_update("fuzz", refs.j, None), (seed, step)
            assert rebuilt_fingerprint(served) == _doc_fingerprint(refs.j), (seed, step)
    direct = port_crdt.Doc()
    port_crdt.apply_update(direct, refs.state())
    assert rebuilt_fingerprint(served) == _doc_fingerprint(direct)


@pytest.mark.parametrize("arena", ["unit", "rle"])
@pytest.mark.parametrize("seeds", [range(0, 6), range(6, 12)], ids=["seeds0-5", "seeds6-11"])
def test_plane_fuzz_mixed_content_matches_jax(arena, seeds):
    for seed in seeds:
        mixed_content_stream(seed, arena)


def reload_stream(seed: int, arena: str) -> list:
    """Returns the steps where the JAX plane missed and was skipped."""
    rng = np.random.default_rng(seed)
    refs = Refs()

    def tree_delete():
        frag = refs.j.get_xml_fragment("x")
        if len(frag) > 0:
            frag.delete(int(rng.integers(0, len(frag))), 1)

    jax_plane, jax_serving, plane, serving = planes(arena, 64, 4096, "r")
    jax_live = True  # False from a JAX miss until the next reload
    skipped = []
    for step in range(90):
        if step % 7 == 6:
            tree_delete()  # GC'd subtrees in later snapshots
        else:
            _random_edit(rng, refs.j, step)
        while refs.updates:
            update = refs.updates.pop(0)
            plane.enqueue_update("r", update)
            jax_plane.enqueue_update("r", update)
        if step % 30 == 29:
            # a server restart: fresh planes loaded from the snapshot
            jax_plane, jax_serving, plane, serving = planes(arena, 64, 4096, "r")
            snapshot = refs.state()
            plane.enqueue_update("r", snapshot)
            jax_plane.enqueue_update("r", snapshot)
            jax_live = True
        if step % 10 == 9:
            plane.flush()
            jax_plane.flush()
            jax_serving.refresh()
            serving.refresh()
            assert plane.is_supported("r"), (seed, step, {k: v for k, v in plane.counters.items() if v})
            served = serving.encode_state_as_update("r", refs.t, None)
            assert served is not None, (seed, step)
            assert rebuilt_fingerprint(served) == _doc_fingerprint(refs.j), (seed, step)
            if jax_live:
                want = jax_serving.encode_state_as_update("r", refs.j, None)
                if want is None:
                    jax_live = False
                else:
                    assert_planes_equal(jax_plane, plane)
                    assert served == want, (seed, step)
            if not jax_live:
                skipped.append(step)
    return skipped


@pytest.mark.parametrize("arena", ["unit", "rle"])
def test_plane_fuzz_reload_from_gc_snapshot_matches_jax(arena):
    misses = {}
    for seed in (5, 17, 2, 9, 13, 21):
        skipped = reload_stream(seed, arena)
        if skipped:
            misses[seed] = skipped
    if misses:
        warnings.warn(f"JAX plane missed (skipped, not compared): {arena} arena, seed -> steps {misses}")
