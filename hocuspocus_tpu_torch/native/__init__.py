"""The port's native (C++) Yjs codec and text lane.

`get_codec()` returns the CPython extension module built from this
directory's `codec.cpp` and `text_lane.cpp`: the wire-frame and varint
helpers, the byte-level update merge and frontier scan, the update
decode screen of the lowering, and the text lane (`lane_*`), which runs
the whole host path of a plain-text document (decode, causal lowering,
serve log, the columnar drain into the device batch, broadcast window
encoding).

The module is compiled with g++ on first use into `build/torch_native/`
at the checkout's root, under a file name carrying the sources' hash (an
edited source rebuilds), and loaded under its own name
`_hocuspocus_torch_codec` without touching `sys.path`. One build per
process, under a lock; a file lock keeps concurrent processes from
compiling the same target at once. A failed build raises with the
compiler's output: there is no Python fallback and no switch to turn the
codec off. The pure-Python path is taken only where a caller asks for it
(`TpuMergeExtension(native_lane=False)` keeps the plane's host path in
Python) or where a native call defers to it by returning None.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

MODULE_NAME = "_hocuspocus_torch_codec"
CXX = "g++"
_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_DIR = Path(__file__).resolve().parent
_SOURCES = (_DIR / "codec.cpp", _DIR / "text_lane.cpp")
_BUILD_DIR = _DIR.parent.parent / "build" / "torch_native"

_lock = threading.Lock()
_codec = None
# what the last build in this process did: seconds of g++ (0.0 when the
# target was already built), the module's path and the Python include
build_info: dict = {}


def _target() -> Path:
    digest = hashlib.sha256()
    for source in _SOURCES:
        digest.update(source.read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _BUILD_DIR / f"{MODULE_NAME}_{digest.hexdigest()[:12]}{suffix}"


def build() -> Path:
    """Compile the sources into build/torch_native/ unless the hashed
    target exists; raise RuntimeError with the compiler's output on
    failure."""
    target = _target()
    include = sysconfig.get_paths()["include"]
    build_info.update(path=str(target), include=include, seconds=0.0)
    if target.exists():
        return target
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / f"{target.name}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if target.exists():  # another process built it meanwhile
                return target
            partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [CXX, *_CXX_FLAGS, f"-I{include}", *map(str, _SOURCES), "-o", str(partial)]
            started = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as exc:
                raise RuntimeError(f"cannot run {CXX} to build {MODULE_NAME}: {exc}") from exc
            build_info["seconds"] = time.perf_counter() - started
            if proc.returncode != 0:
                partial.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{CXX} failed to build {MODULE_NAME} from {_DIR}:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(partial, target)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return target


def get_codec():
    """The compiled module, built and loaded once per process."""
    global _codec
    if _codec is not None:
        return _codec
    with _lock:
        if _codec is None:
            path = build()
            spec = importlib.util.spec_from_file_location(MODULE_NAME, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            _codec = module
    return _codec
