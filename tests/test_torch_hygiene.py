"""The PyTorch port stands alone: it imports nothing of JAX or the JAX
package, and it runs on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

IMPORT_EVERYTHING = """
import importlib.util, pkgutil, sys
import hocuspocus_tpu_torch
for info in pkgutil.walk_packages(hocuspocus_tpu_torch.__path__, "hocuspocus_tpu_torch."):
    importlib.import_module(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)  # defines main() without running it
assert callable(module.main)
leaked = sorted(
    name for name in sys.modules
    if name == "jax" or name.startswith("jax.")
    or name == "hocuspocus_tpu" or name.startswith("hocuspocus_tpu.")
)
print("LEAKED", leaked)
"""

NO_CUDA = """
from hocuspocus_tpu_torch.tpu import MergePlane
for arena in ("unit", "rle"):
    try:
        MergePlane(arena=arena)
    except RuntimeError as error:
        print("RAISED", arena, error)
    plane = MergePlane(num_docs=2, capacity=8, device="cpu", arena=arena)
    print("CPU", arena, type(plane.state).__name__, plane.state[0].device)
"""


def _run(snippet: str, **env) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", snippet],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), **env},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    out = _run(IMPORT_EVERYTHING)
    assert "LEAKED []" in out, out


def test_merge_plane_raises_without_cuda_unless_asked_for_the_cpu():
    out = _run(NO_CUDA, CUDA_VISIBLE_DEVICES="")
    assert "RAISED unit MergePlane needs a CUDA device" in out, out
    assert "RAISED rle MergePlane needs a CUDA device" in out, out
    assert "CPU unit DocState cpu" in out, out
    assert "CPU rle RleState cpu" in out, out


NO_AIOHTTP = """
import sys
sys.modules["aiohttp"] = None  # an import of it now raises ImportError
import hocuspocus_tpu_torch.server
import hocuspocus_tpu_torch.provider
import hocuspocus_tpu_torch.tpu.merge_plane
from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
try:
    hocuspocus_tpu_torch.server.Server
except ImportError:
    print("SERVER NEEDS AIOHTTP")
print("IMPORTED")
"""

EXTENSION_NO_CUDA = """
from hocuspocus_tpu_torch.tpu import TpuMergeExtension
for arena in ("unit", "rle"):
    try:
        TpuMergeExtension(arena=arena)
    except RuntimeError as error:
        print("RAISED", arena, error)
    ext = TpuMergeExtension(num_docs=2, capacity=8, device="cpu", arena=arena, serve=True)
    print("CPU", arena, ext.plane.state[0].device)
"""


def test_server_packages_import_without_aiohttp():
    out = _run(NO_AIOHTTP)
    assert "IMPORTED" in out and "SERVER NEEDS AIOHTTP" in out, out


def test_extension_raises_without_cuda_unless_asked_for_the_cpu():
    out = _run(EXTENSION_NO_CUDA, CUDA_VISIBLE_DEVICES="")
    for arena in ("unit", "rle"):
        assert f"RAISED {arena} MergePlane needs a CUDA device" in out, out
        assert f"CPU {arena} cpu" in out, out


def test_chip_smoke_refuses_to_run_without_cuda():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


NATIVE_LOAD = """
import sys
before = list(sys.path)
from hocuspocus_tpu_torch.native import get_codec
codec = get_codec()
print("NAME", codec.__name__)
print("FILE", codec.__file__)
print("PATH_UNCHANGED", sys.path == before)
print("NO_JAX_CODEC", "_codec" not in sys.modules)
"""


def test_native_codec_loads_from_build_under_its_own_name():
    out = _run(NATIVE_LOAD)
    assert "NAME _hocuspocus_torch_codec" in out, out
    loaded = next(line.split(" ", 1)[1] for line in out.splitlines() if line.startswith("FILE "))
    path = Path(loaded)
    assert path.parent == ROOT / "build" / "torch_native", loaded
    assert path.name.startswith("_hocuspocus_torch_codec_"), loaded
    assert "PATH_UNCHANGED True" in out, out
    assert "NO_JAX_CODEC True" in out, out


def test_no_port_file_names_the_jax_native_package():
    offenders = []
    for path in [ROOT / "chip_smoke.py", *sorted((ROOT / "hocuspocus_tpu_torch").rglob("*"))]:
        if path.suffix not in (".py", ".cpp", ".cu"):
            continue
        text = path.read_text(encoding="utf-8")
        for needle in ("hocuspocus_tpu/native", "hocuspocus_tpu.native"):
            if needle in text:
                offenders.append(f"{path.relative_to(ROOT)}: {needle}")
    assert not offenders, offenders


def test_a_failed_codec_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    from hocuspocus_tpu_torch import native

    compiler = tmp_path / "broken-cxx"
    compiler.write_text("#!/bin/sh\necho 'broken-cxx: no such header Python.h' >&2\nexit 1\n")
    compiler.chmod(0o755)
    monkeypatch.setattr(native, "_codec", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "CXX", str(compiler))
    with pytest.raises(RuntimeError, match="no such header Python.h"):
        native.get_codec()
    assert native._codec is None  # nothing to fall back to
    assert not list((tmp_path / "out").glob("*.so"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "missing-cxx"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.get_codec()


SLICE_MODULES = """
import importlib, sys
names = [
    "hocuspocus_tpu_torch.observability.slo",
    "hocuspocus_tpu_torch.observability.profiler",
    "hocuspocus_tpu_torch.observability.fleet",
    "hocuspocus_tpu_torch.observability.device_watch",
    "hocuspocus_tpu_torch.observability.extension",
    "hocuspocus_tpu_torch.storage",
    "hocuspocus_tpu_torch.storage.faults",
    "hocuspocus_tpu_torch.storage.wal",
    "hocuspocus_tpu_torch.storage.extension",
]
for name in names:
    importlib.import_module(name)
    print("IMPORTED", name)
leaked = sorted(
    name for name in sys.modules
    if name == "jax" or name.startswith("jax.")
    or name == "hocuspocus_tpu" or name.startswith("hocuspocus_tpu.")
)
print("LEAKED", leaked)
print("AIOHTTP", "aiohttp" in sys.modules)
"""


def test_observability_and_storage_modules_import_no_jax_and_no_jax_package():
    out = _run(SLICE_MODULES)
    assert out.count("IMPORTED ") == 9, out
    assert "LEAKED []" in out, out
    # the Metrics endpoints resolve aiohttp when they answer, not at import
    assert "AIOHTTP False" in out, out


SLICE_8_MODULES = """
import importlib, sys
sys.modules["aiohttp"] = None  # an import of it now raises ImportError
names = [
    "hocuspocus_tpu_torch.net",
    "hocuspocus_tpu_torch.net.resp",
    "hocuspocus_tpu_torch.net.mini_redis",
    "hocuspocus_tpu_torch.extensions",
    "hocuspocus_tpu_torch.extensions.webhook",
    "hocuspocus_tpu_torch.extensions.s3",
    "hocuspocus_tpu_torch.extensions.redis",
    "hocuspocus_tpu_torch.extensions.history",
    "hocuspocus_tpu_torch.transformer",
    "hocuspocus_tpu_torch.crdt.permanent_user_data",
    "hocuspocus_tpu_torch.provider.history",
]
for name in names:
    importlib.import_module(name)
    print("IMPORTED", name)
from hocuspocus_tpu_torch.extensions import Durability, S3, Webhook
from hocuspocus_tpu_torch.storage import Durability as StorageDurability
print("DURABILITY", Durability is StorageDurability)
Webhook(url="http://127.0.0.1:1/")  # constructing one needs no aiohttp either
S3(bucket="b", endpoint="http://127.0.0.1:1")
import hocuspocus_tpu_torch as top
print("TOP", top.Configuration.__name__, top.Hocuspocus.__name__, top.Doc.__name__)
leaked = sorted(
    name for name in sys.modules
    if name == "jax" or name.startswith("jax.")
    or name == "hocuspocus_tpu" or name.startswith("hocuspocus_tpu.")
)
print("LEAKED", leaked)
"""


def test_extensions_transformer_and_net_import_without_aiohttp_or_jax():
    out = _run(SLICE_8_MODULES)
    assert out.count("IMPORTED ") == 11, out
    assert "DURABILITY True" in out, out
    assert "TOP Configuration Hocuspocus Doc" in out, out
    assert "LEAKED []" in out, out


SLICE_9_MODULES = """
import importlib, sys
sys.modules["aiohttp"] = None  # an import of it now raises ImportError
names = [
    "hocuspocus_tpu_torch.crdt.relative_position",
    "hocuspocus_tpu_torch.crdt.undo",
    "hocuspocus_tpu_torch.cli",
    "hocuspocus_tpu_torch.loadgen",
    "hocuspocus_tpu_torch.loadgen.scenario",
    "hocuspocus_tpu_torch.loadgen.scenarios",
    "hocuspocus_tpu_torch.loadgen.timeline",
    "hocuspocus_tpu_torch.loadgen.harness",
    "hocuspocus_tpu_torch.loadgen.runner",
    "hocuspocus_tpu_torch.loadgen.__main__",
]
for name in names:
    importlib.import_module(name)
    print("IMPORTED", name)
from hocuspocus_tpu_torch.crdt import encode_relative_position
from hocuspocus_tpu_torch.loadgen import ScenarioRunner, run_served_load
from hocuspocus_tpu_torch.tpu import MultiDeviceMergeExtension, ShardedTpuMergeExtension
leaked = sorted(
    name for name in sys.modules
    if name == "jax" or name.startswith("jax.")
    or name == "hocuspocus_tpu" or name.startswith("hocuspocus_tpu.")
)
print("LEAKED", leaked)
"""


def test_cli_loadgen_undo_and_relative_positions_import_no_jax_and_no_aiohttp():
    out = _run(SLICE_9_MODULES)
    assert out.count("IMPORTED ") == 10, out
    assert "LEAKED []" in out, out


@pytest.mark.parametrize("module", ["protocol.frames", "fleet.controller", "tpu.cells"])
def test_a_port_module_imports_first_in_a_fresh_process(module):
    """`hocuspocus_tpu_torch.protocol.frames` imported first in a process
    (as tests/test_torch_native.py does when its worker collects it
    first) used to meet the observability -> server -> frames cycle half
    way and raise ImportError; the JAX package's top-level import orders
    that cycle for it."""
    out = _run(f"import hocuspocus_tpu_torch.{module}; print('IMPORTED')")
    assert "IMPORTED" in out, out


def test_no_port_loadgen_or_cli_file_sets_a_jax_platform():
    offenders = [
        str(path.relative_to(ROOT))
        for path in [ROOT / "hocuspocus_tpu_torch" / "cli.py",
                     *sorted((ROOT / "hocuspocus_tpu_torch" / "loadgen").glob("*.py"))]
        if "JAX_PLATFORMS" in path.read_text(encoding="utf-8")
    ]
    assert not offenders, offenders
