"""Dispatchers for the integrate step, and the hand-written Hopper kernel.

The counterpart of the JAX package's `tpu/pallas_kernels.py`. For a
tensor on the card every integrate dispatcher launches the CUDA kernel
in `csrc/integrate.cu` (built with nvcc at first use, loaded with
ctypes) or raises: there is no fallback from a CUDA tensor to the plain
path. For a tensor on the CPU they call the plain PyTorch version in
`kernels.py`. Each dispatcher counts the kernel launches it makes in
its `launches` attribute.

The run-append fast path is plain tensor code on every device (the JAX
package wrote no kernel for it either); its dispatcher keeps the
plane's call seam uniform.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .kernels import (
    DocState,
    OpBatch,
    append_run_slots_sparse,
    integrate_op_slots,
    integrate_op_slots_sparse,
    op_count,
)

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "integrate.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelLibrary:
    """The integrate kernel's shared library: built from the checkout's
    source into build/torch_kernels/ (named by the source's hash, so an
    edited source rebuilds) and loaded with ctypes, once per process."""

    def __init__(self) -> None:
        self.build_seconds = 0.0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _nvcc(self) -> str:
        found = shutil.which("nvcc")
        if found:
            return found
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
        raise RuntimeError("nvcc not found: the integrate kernel cannot be built")

    def build(self) -> Path:
        digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
        target = _BUILD_DIR / f"libhp_integrate_{digest}.so"
        if target.exists():
            return target
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_suffix(f".{os.getpid()}.tmp")
        started = time.perf_counter()
        proc = subprocess.run(
            [self._nvcc(), *_NVCC_FLAGS, "-o", str(partial), str(_SOURCE)],
            capture_output=True,
            text=True,
        )
        self.build_seconds = time.perf_counter() - started
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{self.build_log}")
        os.replace(partial, target)
        return target

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                ptr, i32 = ctypes.c_void_p, ctypes.c_int
                lib.hp_integrate_rows.argtypes = [ptr] * 7 + [i32, i32] + [ptr] * 8 + [
                    i32, i32, ptr, ptr,
                ]
                lib.hp_integrate_rows.restype = i32
                lib.hp_error_string.argtypes = [i32]
                lib.hp_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


LIBRARY = KernelLibrary()


def _check(tensor: torch.Tensor, name: str, dtype, shape, device) -> None:
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name} has dtype {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(tensor.shape)}, expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def integrate_rows_cuda(state: DocState, ops: OpBatch, slots: torch.Tensor) -> None:
    """Launch the Hopper integrate kernel: K op slots into the rows
    `slots` routes to, IN PLACE; columns routed outside [0, num_docs)
    are padding. Checks every tensor and raises on a refused launch."""
    device = state.id_client.device
    num_docs, capacity = state.id_client.shape
    num_slots, batch = ops.kind.shape
    for name in ("id_client", "id_clock", "rank", "origin_rank"):
        _check(getattr(state, name), name, torch.int32, (num_docs, capacity), device)
    _check(state.deleted, "deleted", torch.bool, (num_docs, capacity), device)
    _check(state.length, "length", torch.int32, (num_docs,), device)
    _check(state.overflow, "overflow", torch.bool, (num_docs,), device)
    for name, field in zip(ops._fields, ops):
        _check(field, name, torch.int32, (num_slots, batch), device)
    _check(slots, "slots", torch.int32, (batch,), device)
    lib = LIBRARY.get()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.hp_integrate_rows(
        *(field.data_ptr() for field in state),
        num_docs,
        capacity,
        *(field.data_ptr() for field in ops),
        num_slots,
        batch,
        slots.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(
            f"integrate kernel launch failed: {lib.hp_error_string(err).decode()}"
        )


def integrate_op_slots_fast(state: DocState, ops: OpBatch) -> tuple[DocState, torch.Tensor]:
    """Integrate K op slots into every row (ops fields (K, D)), in place:
    the Hopper kernel on the card, the plain version on the CPU."""
    if not state.id_client.is_cuda:
        return integrate_op_slots(state, ops)
    num_docs = state.id_client.shape[0]
    slots = torch.arange(num_docs, dtype=torch.int32, device=state.id_client.device)
    integrate_rows_cuda(state, ops, slots)
    integrate_op_slots_fast.launches += 1
    return state, op_count(ops)


integrate_op_slots_fast.launches = 0


def integrate_op_slots_sparse_fast(
    state: DocState, ops: OpBatch, slots: torch.Tensor
) -> tuple[DocState, torch.Tensor]:
    """Integrate K op slots over the B rows `slots` routes to (ops
    fields (K, B), num_docs = padding sentinel), in place: the Hopper
    kernel on the card, the plain version on the CPU."""
    if not state.id_client.is_cuda:
        return integrate_op_slots_sparse(state, ops, slots)
    integrate_rows_cuda(state, ops, slots)
    integrate_op_slots_sparse_fast.launches += 1
    return state, op_count(ops)


integrate_op_slots_sparse_fast.launches = 0


def integrate_launches() -> int:
    """Kernel launches made by both integrate dispatchers."""
    return integrate_op_slots_fast.launches + integrate_op_slots_sparse_fast.launches


def reset_integrate_launches() -> None:
    integrate_op_slots_fast.launches = 0
    integrate_op_slots_sparse_fast.launches = 0


def append_run_slots_sparse_fast(
    state: DocState, client, clock, run_len, slots
) -> tuple[DocState, torch.Tensor]:
    """The run-append fast path: one fit pass over K runs and one masked
    fill of each routed row, plain tensor code on every device."""
    return append_run_slots_sparse(state, client, clock, run_len, slots)

