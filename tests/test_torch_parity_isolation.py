"""The port's tests that hold it against the JAX package's native codec
and text lane must not depend on how that package resolved its codec in
the worker process they land on.

The JAX package builds its `_codec` module with g++ into its own source
directory at the first `get_codec()` of a process and keeps the outcome
for the process's life: a failed first import leaves `None`, and every
later plane of that process runs without the text lane. On a fresh
checkout, parallel test workers all reach that first call at collection
time and build the same file at once, so a worker can import it while
another worker's linker is still writing it, and keep `None`. A parity
case asking the JAX side for its lane then found `native_lane` False
(`test_served_path_matches_jax_after_every_flush[*-True]`).

`resolve_jax_codec` re-resolves such a failure before a port test uses
the JAX codec; the case below leaves exactly that state behind, with a
half-written copy of the module, and runs a parity case after it in the
same process.
"""

import os
import shutil

import pytest

from hocuspocus_tpu import native as jax_native


def resolve_jax_codec():
    """The JAX package's compiled codec, resolved afresh when this
    process's first resolution found no usable module. Never rebuilds a
    module that is already there: another worker may be importing it."""
    codec = jax_native.get_codec()
    if codec is None and not os.environ.get("HOCUSPOCUS_TPU_NO_NATIVE"):
        jax_native._resolved = False
        jax_native._build_attempted = False
        codec = jax_native.get_codec()
    assert codec is not None, f"the JAX package's codec did not build: {jax_native.codec_status()}"
    return codec


def _fail_first_resolution(monkeypatch, tmp_path) -> None:
    """Leave what a worker keeps when its first `get_codec()` imported
    the module while another worker's linker was writing it."""
    good = resolve_jax_codec()
    so_path, so_dir = jax_native._SO, jax_native._DIR
    half = tmp_path / os.path.basename(so_path)
    half.write_bytes(b"")  # the linker has opened it and not yet written
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(jax_native, "_SO", str(half))
    monkeypatch.setattr(jax_native, "_DIR", str(tmp_path))
    monkeypatch.setattr(jax_native, "_resolved", False)
    monkeypatch.setattr(jax_native, "_build_attempted", True)
    monkeypatch.setattr(jax_native, "_codec", None)
    assert jax_native.get_codec() is None
    # the link ends and the whole module is in place; the process's
    # verdict stays
    half.unlink()
    jax_native._SO, jax_native._DIR = so_path, so_dir
    assert jax_native.get_codec() is None


def test_a_failed_first_resolution_is_resolved_again(monkeypatch, tmp_path):
    _fail_first_resolution(monkeypatch, tmp_path)
    codec = resolve_jax_codec()
    assert hasattr(codec, "lane_window_sm")
    assert jax_native.get_codec() is codec


@pytest.mark.parametrize("arena", ["unit", "rle"])
async def test_parity_with_the_lane_after_a_failed_first_resolution(monkeypatch, tmp_path, arena):
    from tests.test_torch_server_parity import test_served_path_matches_jax_after_every_flush

    _fail_first_resolution(monkeypatch, tmp_path)
    await test_served_path_matches_jax_after_every_flush(arena, 5, True)
