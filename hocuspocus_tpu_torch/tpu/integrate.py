"""Dispatchers for the integrate steps, and the hand-written Hopper kernels.

The counterpart of the JAX package's `tpu/pallas_kernels.py` (K1, the
unit arena) and `tpu/pallas_kernels_rle.py` (K2, the run-length arena).
For a tensor on the card every integrate dispatcher launches its CUDA
kernel (`csrc/integrate.cu` for K1, `csrc/integrate_rle.cu` for K2, each
built with nvcc into its own shared library at first use and loaded with
ctypes) or raises: there is no fallback from a CUDA tensor to the plain
path. For a tensor on the CPU they call the plain PyTorch version in
`kernels.py` / `kernels_rle.py`. Each dispatcher counts the kernel
launches it makes in its `launches` attribute.

The run-append fast paths and the compaction programs are plain tensor
code on every device (the JAX package wrote no kernel for them either);
their dispatchers keep the plane's call seam uniform. The compaction
dispatchers count their calls in `launches` too.
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
    compact_doc_rows,
    integrate_op_slots,
    integrate_op_slots_sparse,
    op_count,
)
from .kernels_rle import (
    RleState,
    append_run_slots_rle_sparse,
    compact_doc_rows_rle,
    integrate_op_slots_rle,
    integrate_op_slots_rle_sparse,
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelLibrary:
    """One kernel source's shared library: built from the checkout's
    `csrc/<source>` into build/torch_kernels/ (named by the source's
    hash, so an edited source rebuilds) and loaded with ctypes, once per
    process. `entry` is the launch function's C name and `argtypes` its
    ctypes signature; every library also exports `hp_error_string`."""

    def __init__(self, source: str, entry: str, argtypes: list) -> None:
        self.source = _CSRC / source
        self.entry = entry
        self.argtypes = argtypes
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
        raise RuntimeError(f"nvcc not found: {self.source.name} cannot be built")

    def build(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        target = _BUILD_DIR / f"lib{self.source.stem}_{digest}.so"
        if target.exists():
            return target
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_suffix(f".{os.getpid()}.tmp")
        started = time.perf_counter()
        proc = subprocess.run(
            [self._nvcc(), *_NVCC_FLAGS, "-o", str(partial), str(self.source)],
            capture_output=True,
            text=True,
        )
        self.build_seconds = time.perf_counter() - started
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source}:\n{self.build_log}")
        os.replace(partial, target)
        return target

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                entry = getattr(lib, self.entry)
                entry.argtypes = self.argtypes
                entry.restype = ctypes.c_int
                lib.hp_error_string.argtypes = [ctypes.c_int]
                lib.hp_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def launch(self, *args) -> None:
        """Call the entry point; raise on a nonzero cudaError_t."""
        lib = self.get()
        err = getattr(lib, self.entry)(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.source.stem} kernel launch failed: "
                f"{lib.hp_error_string(err).decode()}"
            )


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# state fields, (num_docs, width), 8 op fields, (num_slots, batch), slots,
# window, done, stream
_TAIL = [_PTR] * 8 + [_I32] * 2 + [_PTR] + [_I32] + [_PTR] * 2
LIBRARY = KernelLibrary("integrate.cu", "hp_integrate_rows", [_PTR] * 7 + [_I32] * 2 + _TAIL)
RLE_LIBRARY = KernelLibrary(
    "integrate_rle.cu", "hp_integrate_rle_rows", [_PTR] * 9 + [_I32] * 2 + _TAIL
)

# The widest window, in units (K1) or entries (K2), that a warp-path row
# gets in shared memory. At 512, a CTA of 8 warps takes 8 * 512 * 21 B =
# 86 KB (K2) or 8 * 512 * 17 B = 70 KB (K1), so two CTAs fit an SM's
# 227 KB and the plane's 1,024 routed rows (128 CTAs) are resident in
# one wave on the H100's 132 SMs. The plane's rows (about 100 entries,
# about 200 units, plus what K = 16 ops add) and the RLE bench's (about
# 260 entries) fit with room to spare, and 8 windows hold a whole row of
# the plane's width 4096, so a row that outgrows its window still runs in
# the same launch, on the CTA path.
WARP_WINDOW = 512


def _warp_window(width: int) -> int:
    """The warp path's window for rows `width` wide: the whole row when
    it is narrow, else WARP_WINDOW. A row whose ops can reach past it
    runs on the CTA path."""
    return min(width, WARP_WINDOW)


def _check(tensor: torch.Tensor, name: str, dtype, shape, device) -> None:
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name} has dtype {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(tensor.shape)}, expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(state, row_fields, bool_fields, scalar_fields, ops, slots) -> tuple:
    """Check every tensor a row kernel takes: row fields (D, W) int32 or
    bool, per-row scalars (D,), op fields (K, B) int32, slots (B,) int32,
    all contiguous on the state's device. Returns (D, W, K, B)."""
    first = getattr(state, row_fields[0])
    device = first.device
    num_docs, width = first.shape
    num_slots, batch = ops.kind.shape
    for name in row_fields:
        _check(getattr(state, name), name, torch.int32, (num_docs, width), device)
    for name in bool_fields:
        _check(getattr(state, name), name, torch.bool, (num_docs, width), device)
    for name, dtype in scalar_fields:
        _check(getattr(state, name), name, dtype, (num_docs,), device)
    for name, field in zip(ops._fields, ops):
        _check(field, name, torch.int32, (num_slots, batch), device)
    _check(slots, "slots", torch.int32, (batch,), device)
    return num_docs, width, num_slots, batch


def _launch(library: KernelLibrary, state, ops, slots, shape) -> None:
    """Launch a row kernel: the warp path with a `_warp_window` window,
    and the CTA path for the rows that do not fit it. `done` is the
    per-column scratch through which a second launch learns which rows
    the first took (allocated only when the window is narrower than the
    row; the C side decides whether it needs the second launch)."""
    num_docs, width, num_slots, batch = shape
    window = _warp_window(width)
    done = torch.empty(batch, dtype=torch.uint8, device=slots.device) if window < width else None
    library.launch(
        *(field.data_ptr() for field in state),
        num_docs,
        width,
        *(field.data_ptr() for field in ops),
        num_slots,
        batch,
        slots.data_ptr(),
        window,
        None if done is None else done.data_ptr(),
        torch.cuda.current_stream(slots.device).cuda_stream,
    )


# -- K1: the unit arena -------------------------------------------------------


def integrate_rows_cuda(state: DocState, ops: OpBatch, slots: torch.Tensor) -> None:
    """Launch the Hopper integrate kernel K1: K op slots into the rows
    `slots` routes to, IN PLACE; columns routed outside [0, num_docs)
    are padding. Checks every tensor and raises on a refused launch."""
    shape = _check_launch(
        state,
        ("id_client", "id_clock", "rank", "origin_rank"),
        ("deleted",),
        (("length", torch.int32), ("overflow", torch.bool)),
        ops,
        slots,
    )
    _launch(LIBRARY, state, ops, slots, shape)


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


def append_run_slots_sparse_fast(
    state: DocState, client, clock, run_len, slots
) -> tuple[DocState, torch.Tensor]:
    """The run-append fast path: one fit pass over K runs and one masked
    fill of each routed row, plain tensor code on every device."""
    return append_run_slots_sparse(state, client, clock, run_len, slots)


# -- K2: the run-length arena -------------------------------------------------


def integrate_rle_rows_cuda(state: RleState, ops: OpBatch, slots: torch.Tensor) -> None:
    """Launch the Hopper RLE integrate kernel K2: K op slots into the
    rows `slots` routes to, IN PLACE; columns routed outside [0,
    num_docs) are padding. Checks every tensor and raises on a refused
    launch."""
    shape = _check_launch(
        state,
        ("run_client", "run_clock", "run_len", "run_rank", "run_orank"),
        ("run_deleted",),
        (("num_runs", torch.int32), ("total_units", torch.int32), ("overflow", torch.bool)),
        ops,
        slots,
    )
    _launch(RLE_LIBRARY, state, ops, slots, shape)


def integrate_op_slots_rle_fast(state: RleState, ops: OpBatch) -> tuple[RleState, torch.Tensor]:
    """Integrate K op slots into every RLE row (ops fields (K, D)), in
    place: K2 on the card, the plain version on the CPU."""
    if not state.run_client.is_cuda:
        return integrate_op_slots_rle(state, ops)
    num_docs = state.run_client.shape[0]
    slots = torch.arange(num_docs, dtype=torch.int32, device=state.run_client.device)
    integrate_rle_rows_cuda(state, ops, slots)
    integrate_op_slots_rle_fast.launches += 1
    return state, op_count(ops)


integrate_op_slots_rle_fast.launches = 0


def integrate_op_slots_rle_sparse_fast(
    state: RleState, ops: OpBatch, slots: torch.Tensor
) -> tuple[RleState, torch.Tensor]:
    """Integrate K op slots over the B RLE rows `slots` routes to (ops
    fields (K, B), num_docs = padding sentinel), in place: K2 on the
    card, the plain version on the CPU."""
    if not state.run_client.is_cuda:
        return integrate_op_slots_rle_sparse(state, ops, slots)
    integrate_rle_rows_cuda(state, ops, slots)
    integrate_op_slots_rle_sparse_fast.launches += 1
    return state, op_count(ops)


integrate_op_slots_rle_sparse_fast.launches = 0


def append_run_slots_rle_sparse_fast(
    state: RleState, client, clock, run_len, slots
) -> tuple[RleState, torch.Tensor]:
    """The RLE run-append fast path (EXTEND the rank-tail entry, APPEND
    the other runs): plain tensor code on every device."""
    return append_run_slots_rle_sparse(state, client, clock, run_len, slots)


# -- on-device compaction -------------------------------------------------------


def compact_doc_rows_fast(state: DocState, slots: torch.Tensor) -> tuple[DocState, torch.Tensor]:
    """The unit arena's tombstone GC over the rows `slots` routes to
    (num_docs = padding sentinel), in place; returns the packed live
    lengths (B,). A single-pass permutation (scatter, cumsum, gather)
    that reads and writes the routed rows once: plain tensor code on
    every device, as the JAX package's dispatcher runs its XLA program
    on every backend."""
    compact_doc_rows_fast.launches += 1
    return compact_doc_rows(state, slots)


compact_doc_rows_fast.launches = 0


def compact_doc_rows_rle_fast(state: RleState, slots: torch.Tensor) -> tuple[RleState, torch.Tensor]:
    """The run-length arena's defragmenter (sort and segment merge) over
    the rows `slots` routes to, in place; returns the packed entry counts
    (B,). Plain tensor code on every device."""
    compact_doc_rows_rle_fast.launches += 1
    return compact_doc_rows_rle(state, slots)


compact_doc_rows_rle_fast.launches = 0
