#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It first builds the port's native codec and text lane with g++ from
`hocuspocus_tpu_torch/native/` (phase `native_build`), then the Hopper
integrate kernels from `hocuspocus_tpu_torch/csrc/` (K1 for the unit
arena, K2 for the run-length arena, one nvcc each, both started
together), holds each kernel against its plain PyTorch version (bit for
bit) at the bench shape and at deployment scale, then drives the merge
plane + serving path (`MergePlane`, `PlaneServing`, `TpuSyncSource`)
over each arena with concurrent Yjs editors through three planes: on
the card with the native text lane, on the card on the Python host
path, and on the CPU on the Python host path, every arena element and
served byte held equal after every flush. Last it drives the served
path over each arena: the port's Hocuspocus core with
`TpuMergeExtension(serve=True)` (the native text lane on, its default)
and 10,240 in-process providers editing 1,024 docs, then two join waves
(phases `server`, `rle_server`), and the same path with
`native_lane=False` (`server_python`, `rle_server_python`),
each path's biggest integrate batch replayed through the kernel and the
plain version (`server_replay`, `rle_server_replay`, ...). Each phase prints
one line; any failure exits nonzero. A kernel phase's `ms` is the
kernels' device time per launch: the launch entry (`integrate_rows_cuda`
/ `integrate_rle_rows_cuda`) is timed with CUDA events, 8 launches back
to back on copies of the input (one on the 100k-row arenas), while the
card spins through the wrappers' host work, so the window holds only the
launches. The replay lines add `wrapper_us`, the host time of one
dispatcher call, and `window_check`, the event time beside
torch.profiler's kernel time. The last two lines are the kernels' JSON
record and the device line. Without a CUDA device, or outside a
checkout, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import gc
import json
import random
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# int32 rate: the data sheet's 67 TFLOP/s fp32 counts an FMA as two
# operations on each SM's 128 fp32 lanes; an SM has 64 int32 lanes
INT32_OPS_PER_S = 67e12 / 4
# int32 operations per occupied unit, counted from the loop bodies of
# hocuspocus_tpu_torch/csrc/integrate.cu: each compare, logical
# combination and add or min/max that a body evaluates for EVERY unit.
# Work done only for units that pass a test (a conditional max, bump or
# store, the skip test inside the conflict window) is left out, so the
# count is a floor.
OPS_DELETE = 5  # id-range test: ==, >=, <, two ands
OPS_ORIGINS = 6  # pass 1, left and right origin: ==, ==, and
OPS_CONFLICT = 3  # pass 2, window test: >, <, and
OPS_SKIPPED = 6  # pass 3: >, <, <, two ands, add
OPS_BUMP = 2  # pass 4, rank and origin rank: >=
OPS_INSERT = OPS_ORIGINS + OPS_CONFLICT + OPS_SKIPPED + OPS_BUMP
# per newly filled unit: off, clock + off, ins + off, off == 0, ins + off - 1, select
OPS_FILL = 7
ROW_BYTES_PER_UNIT = 17  # 4 int32 fields + a bool
# int32 operations per occupied ENTRY, counted the same way, per pass of
# the plain version, hocuspocus_tpu_torch/tpu/kernels_rle.py::
# _integrate_rle_rows (line numbers), which every kernel design is held to:
OPS_RLE_ORIGINS = 11  # :135-141 origin ranks: end add; per origin ==, >=, <, two ands
OPS_RLE_CONFLICT = 16  # :145-159 conflict scan: client_ge; head 4 compares, 3 ands, or; successor add, 3 compares, 3 ands
OPS_RLE_SPLIT = 4  # :167-168 straddle test: <, add, <, and
OPS_RLE_BUMP = 6  # :174-189 shorten the straddled run (4), bump rank and orank: two >=
OPS_RLE_INSERT = OPS_RLE_ORIGINS + OPS_RLE_CONFLICT + OPS_RLE_SPLIT + OPS_RLE_BUMP
OPS_RLE_BOUND = 6  # :207-215 each id bound's scan: ==, <, add, <, two ands
OPS_RLE_COVER = 6  # :224-230 tombstone pass: ==, >=, add, <=, two ands
RLE_BYTES_PER_ENTRY = 21  # 5 int32 fields + a bool
# plane rounds per arena: a round's host work grows with the docs and the
# planes (three since the text lane: about 15 s a round on the card), cut
# so that the whole script keeps to about 13 minutes there
UNIT_PLANE_ROUNDS = 8
RLE_PLANE_ROUNDS = 8
# the served path (phases server, rle_server): BASELINE config 2's 1,024
# docs x 10 clients at capacity 4,096, uncut; only the rounds are cut
# (each round is 10,240 edits through the server core on one host thread)
SERVER_CLIENTS = 10
SERVER_ROUNDS = 6
SERVER_CUTS = {"rounds": "6 rounds of one edit per provider"}
# the served path on the Python host path (native_lane=False), kept driven
# at full width so that its host timings stand beside the lane's; only
# the rounds are cut further
PYTHON_SERVER_ROUNDS = 3
PYTHON_SERVER_CUTS = {"rounds": "3 rounds of one edit per provider"}
# PERF.md's budget for one flush cycle of the plane phases
FLUSH_BUDGET_MS = 50.0
# the main path's parts, in the kernels' record: plane (the lane and the
# Python card planes), server (native lane), server_python
PATHS = ("plane", "server", "server_python")

CLIENTS = np.asarray([7, 0x9000_0001], np.uint32)
NONE = 0xFFFFFFFF


class SmokeFailure(RuntimeError):
    pass


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def emit(tag: str, **fields) -> None:
    print(f"{tag}: " + json.dumps(fields, sort_keys=False), flush=True)


# -- op streams -------------------------------------------------------------


def random_ops(rng, next_clock, num_slots, insert_only=False, run_range=(1, 9)):
    """Causally-valid two-client op stream, vectorised over rows (the
    JAX package's test stream, one slot at a time): (K, D) numpy fields
    in the JAX dtypes. next_clock (2, D) advances in place."""
    d = next_clock.shape[1]
    cols = np.arange(d)
    kind = np.zeros((num_slots, d), np.int32)
    client = np.full((num_slots, d), CLIENTS[0], np.uint32)
    clock = np.zeros((num_slots, d), np.int32)
    run_len = np.zeros((num_slots, d), np.int32)
    lc = np.full((num_slots, d), NONE, np.uint32)
    lk = np.zeros((num_slots, d), np.int32)
    rc = np.full((num_slots, d), NONE, np.uint32)
    rk = np.zeros((num_slots, d), np.int32)
    for k in range(num_slots):
        kk = np.ones(d, np.int32) if insert_only else rng.integers(0, 3, d).astype(np.int32)
        ci = rng.integers(0, 2, d)
        run = rng.integers(run_range[0], run_range[1], d).astype(np.int64)
        own = next_clock[ci, cols]
        known = next_clock > 0
        pick = rng.integers(0, 2, d)
        oi = np.where(known[pick, cols], pick, 1 - pick)
        pick = rng.integers(0, 2, d)
        ri = np.where(known[pick, cols], pick, 1 - pick)
        ins = kk == 1
        dels = (kk == 2) & (own > 0)
        kk[(kk == 2) & ~dels] = 0
        left = ins & known.any(axis=0)
        right = left & (rng.random(d) < 0.3)
        dclock = (rng.random(d) * own).astype(np.int64)
        kind[k] = kk
        client[k] = CLIENTS[ci]
        clock[k] = np.where(ins, own, np.where(dels, dclock, 0))
        run_len[k] = np.where(dels, np.minimum(run, own - dclock), run)
        lc[k] = np.where(left, CLIENTS[oi], NONE)
        lk[k] = np.where(left, (rng.random(d) * next_clock[oi, cols]).astype(np.int64), 0)
        rc[k] = np.where(right, CLIENTS[ri], NONE)
        rk[k] = np.where(right, (rng.random(d) * next_clock[ri, cols]).astype(np.int64), 0)
        next_clock[ci[ins], cols[ins]] += run[ins]
    return kind, client, clock, run_len, lc, lk, rc, rk


# -- helpers on the card ----------------------------------------------------


def clone_state(state):
    return type(state)(*(field.clone() for field in state))


def states_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y.to(x.device)) for x, y in zip(a, b))


def max_abs_err(a, b) -> int:
    return max(
        int((x.long() - y.to(x.device).long()).abs().max()) if x.numel() else 0
        for x, y in zip(a, b)
    )


def event_ms(fn, reps: int, setup=None) -> float:
    """Median time of fn() over `reps` runs, CUDA events around the call
    (host work inside it included: for the plain versions, whose many
    small launches keep the host busy); setup() runs before each
    (untimed)."""
    import torch

    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# A spin kernel queued before a kernel's start event: about 1 ms of the
# card's clock per timed launch, far longer than a wrapper's host work,
# so the launches are already queued when the event fires.
SLEEP_CYCLES = 2_000_000
# Launches timed back to back in one window, each on its own copy of the
# input, where the phase's state is small enough to copy: a lone launch's
# window also holds about 5 µs of the card's own between the start event
# and the kernel, a quarter of a 20 µs kernel; over 8 launches what stays
# is the gap between launches (about 1.6 µs on the H100). The 100k-row
# phases time one launch (a copy is 9 GB).
LAUNCHES_PER_WINDOW = 8


def kernel_times(fn, reps: int, setup=None, launches: int = 1) -> list[float]:
    """Device time in ms of one kernel launch, once per run: setup()
    (untimed) prepares `launches` independent inputs, the card spins
    while the host runs fn(0) .. fn(launches - 1), and the CUDA events
    bracket only their launches, back to back; the window over the
    count."""
    import torch

    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES * launches)
        start.record()
        for i in range(launches):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return times


def kernel_ms(fn, reps: int, setup=None, launches: int = 1) -> float:
    """Median device time of one of fn(i)'s kernel launches (kernel_times)."""
    return float(np.median(kernel_times(fn, reps, setup, launches)))


def window_check(fn, reps: int, setup=None, launches: int = 1, name: str = "integrate") -> dict:
    """The window check: kernel_times' mean beside torch.profiler's mean
    device time per launch of the kernels whose names contain `name`,
    over the same runs (None when the profiler records no device time).
    One untimed run first, so a first launch's one-time cost stays out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if setup is not None:
        setup()
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        times = kernel_times(fn, reps, setup, launches)
    device_us = 0.0
    for event in prof.key_averages():
        if name in event.key:
            us = getattr(event, "device_time_total", None)
            device_us += us if us is not None else getattr(event, "cuda_time_total", 0)
    event_mean = float(np.mean(times))
    profiled = device_us / 1e3 / (reps * launches) if device_us else None
    return {
        "event_ms_mean": event_mean,
        "profiler_ms_mean": profiled,
        "within_10pct": None if profiled is None else abs(event_mean - profiled) <= 0.1 * profiled,
    }


class Copies:
    """`count` copies of a state for kernel_times' back-to-back launches;
    reset() (untimed) sets every copy back to the state."""

    def __init__(self, state, count: int) -> None:
        self.state = state
        self.count = count
        self.items = []

    def reset(self) -> None:
        if not self.items:
            self.items = [clone_state(self.state) for _ in range(self.count)]
        for copy in self.items:
            for dst, src in zip(copy, self.state):
                dst.copy_(src)

    def __getitem__(self, i: int):
        return self.items[i]

    def clear(self) -> None:
        self.items = []


def wrapper_us(fn, reps: int, setup=None) -> float:
    """Median host time in µs of one call of fn() (a dispatcher: checks,
    pointers, the ctypes call, its own launches), the card idle before
    each call and no synchronize inside the window."""
    import torch

    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        started = time.perf_counter()
        fn()
        times.append(time.perf_counter() - started)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def plain_by_slot(state, ops, integrate, field: str):
    """A plain integrate one op slot at a time, in place, recording each
    row's `field` (length, or num_runs) before each slot: the reference
    result plus what the bound needs, (K, B)."""
    import torch

    from hocuspocus_tpu_torch.tpu import kernels as tk

    seen = []
    for k in range(ops.kind.shape[0]):
        seen.append(getattr(state, field).clone())
        integrate(state, tk.OpBatch(*(f[k : k + 1] for f in ops)))
    return torch.stack(seen)


def plain_with_lengths(state, ops):
    from hocuspocus_tpu_torch.tpu import kernels as tk

    return plain_by_slot(state, ops, tk.integrate_op_slots, "length")


def integrate_bound(ops, lengths, len_end) -> tuple[float, str, dict]:
    """Least time for one integrate call on this run's data. Bytes: the
    occupied units read once and written once (17 B each), plus the ops
    and routing. Operations: per op slot and row, what the kernel's
    passes do over the row's occupied units at that point (`lengths`,
    (K, B), from plain_with_lengths): a delete makes one pass, an insert
    that is dropped (origin missing or overflow) makes pass 1 only, an
    applied insert all four plus the fill of its new units. An insert
    counts as applied when it lengthened its row."""
    import torch

    num_slots, batch = ops.kind.shape
    before = lengths.long()
    after = torch.cat([lengths[1:], len_end[None]]).long()
    inserts = ops.kind == 1
    applied = inserts & (after != before)
    per_unit = (
        OPS_DELETE * (ops.kind == 2).long()
        + OPS_INSERT * applied.long()
        + OPS_ORIGINS * (inserts & ~applied).long()
    )
    operations = int((before.clamp(min=0) * per_unit).sum())
    operations += OPS_FILL * int(((after - before) * applied.long()).sum())
    moved = ROW_BYTES_PER_UNIT * int(before[0].sum() + len_end.long().sum())
    moved += 8 * 4 * num_slots * batch + 4 * batch + 2 * 5 * batch
    return _bound(moved, operations)


def _bound(moved: int, operations: int) -> tuple[float, str, dict]:
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = operations / INT32_OPS_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"bytes": moved, "int32_ops": operations}


def plain_rle_with_runs(state, ops):
    from hocuspocus_tpu_torch.tpu import kernels_rle as tr

    return plain_by_slot(state, ops, tr.integrate_op_slots_rle, "num_runs")


def rle_bound(ops, runs, runs_end, entries) -> tuple[float, str, dict]:
    """Least time for one K2 call on this run's data. Bytes: the occupied
    entries read once and written once (21 B each), plus 32 B per op and
    the routing and per-row scalars. Operations: per op slot and row,
    what the kernel's passes do over the row's occupied entries at that
    point (`runs`, (K, B), from plain_rle_with_runs): an applied insert
    makes passes 1-4, a dropped one pass 1 only, a delete that fits the
    two id-bound scans over the entries before it and the tombstone pass
    over the entries after its splits; a delete that does not fit does
    nothing. An insert counts as applied when it added entries."""
    import torch

    num_slots, batch = ops.kind.shape
    before = runs.long().clamp(0, entries)
    after = torch.cat([runs[1:], runs_end[None]]).long().clamp(0, entries)
    inserts = ops.kind == 1
    applied = inserts & (after != before)
    deletes = (ops.kind == 2) & (runs.long() + 2 <= entries)
    per_entry = (
        OPS_RLE_INSERT * applied.long()
        + OPS_RLE_ORIGINS * (inserts & ~applied).long()
        + 2 * OPS_RLE_BOUND * deletes.long()
    )
    operations = int((before * per_entry).sum()) + OPS_RLE_COVER * int((after * deletes.long()).sum())
    moved = RLE_BYTES_PER_ENTRY * int(before[0].sum() + after[-1].sum())
    moved += 8 * 4 * num_slots * batch + 4 * batch + 2 * 9 * batch
    return _bound(moved, operations)


# -- phases -----------------------------------------------------------------


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_native_build():
    """Build the port's native codec and text lane (g++, the checkout's
    `hocuspocus_tpu_torch/native/*.cpp`) and load it; a failed build
    raises out of the smoke."""
    from hocuspocus_tpu_torch import native

    started = time.perf_counter()
    codec = native.get_codec()
    check(codec.__name__ == native.MODULE_NAME, f"native: loaded {codec.__name__}")
    check(hasattr(codec, "lane_drain"), "native: the module has no text lane")
    emit(
        "native_build",
        module=codec.__name__,
        path=native.build_info["path"],
        python_include=native.build_info["include"],
        gxx_seconds=round(native.build_info["seconds"], 3),
        seconds=round(time.perf_counter() - started, 3),
    )


def phase_build():
    """Build K1 and K2, one nvcc each, both started together."""
    from hocuspocus_tpu_torch.tpu.integrate import LIBRARY, RLE_LIBRARY

    started = time.perf_counter()
    libraries = (("build", "integrate_rows", LIBRARY), ("rle_build", "integrate_rle_rows", RLE_LIBRARY))
    with ThreadPoolExecutor(len(libraries)) as pool:
        for future in [pool.submit(lib.get) for _tag, _name, lib in libraries]:
            future.result()
    seconds = round(time.perf_counter() - started, 3)
    gpu = nvidia_smi_line()
    for tag, name, lib in libraries:
        emit(
            tag,
            gpu=gpu,
            kernel=name,
            source=str(lib.source.relative_to(lib.source.parent.parent.parent)),
            seconds=seconds,
            nvcc_seconds=round(lib.build_seconds, 3),
            ptxas=[
                line.strip()
                for line in lib.build_log.splitlines()
                if "registers" in line or "spill" in line or "smem" in line
            ],
        )


def phase_dense(rng, num_docs, capacity, num_slots, reps):
    """K1 at the bench shape: every row routed (slots = arange(D))."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk

    dev = torch.device("cuda")
    next_clock = np.zeros((2, num_docs), np.int64)
    seed_slots = max(capacity // 4 // 16, 1)  # ~25% occupancy, 16-unit runs
    seed_ops = tk.ops_from_numpy(
        random_ops(rng, next_clock, seed_slots, insert_only=True, run_range=(16, 17)), dev
    )
    state = tk.make_empty_state(num_docs, capacity, dev)
    reference = tk.make_empty_state(num_docs, capacity, dev)
    ti.integrate_op_slots_fast(state, seed_ops)
    tk.integrate_op_slots(reference, seed_ops)
    torch.cuda.synchronize()
    check(states_equal(state, reference), "dense seed: kernel and plain states differ")
    del reference, seed_ops

    ops = tk.ops_from_numpy(random_ops(rng, next_clock, num_slots), dev)
    expected = clone_state(state)
    lengths = plain_with_lengths(expected, ops)
    work = clone_state(state)
    _, count = ti.integrate_op_slots_fast(work, ops)
    torch.cuda.synchronize()
    check(int(count) == int(tk.op_count(ops)), "dense: op counts differ")
    check(states_equal(work, expected), "dense: kernel and plain states differ")
    err = max_abs_err(work, expected)
    del work

    copies = Copies(state, LAUNCHES_PER_WINDOW)
    slots = torch.arange(num_docs, dtype=torch.int32, device=dev)
    ms = kernel_ms(
        lambda i: ti.integrate_rows_cuda(copies[i], ops, slots), reps, copies.reset, copies.count
    )
    plain_ms = event_ms(lambda: tk.integrate_op_slots(copies[0], ops), 2, copies.reset)
    bound_ms, bound_by, need = integrate_bound(ops, lengths, expected.length)
    copies.clear()
    emit(
        "dense",
        shape={"D": num_docs, "N": capacity, "K": num_slots},
        bit_identical=True,
        max_abs_err=err,
        mean_occupancy=round(float(state.length.float().mean()) / capacity, 4),
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        **need,
    )
    return state


def _row_checksums(state, chunk=8192):
    """Per-row int64 checksum of every field of either arena (random
    column weights for row fields, a constant per per-row scalar),
    computed in row chunks to bound the temporaries."""
    import torch

    num_docs, width = state[0].shape
    gen = torch.Generator(device="cuda").manual_seed(1234)
    weights = torch.randint(1, 2**31, (width,), generator=gen, device="cuda", dtype=torch.int64)
    out = torch.zeros(num_docs, dtype=torch.int64, device="cuda")
    for start in range(0, num_docs, chunk):
        rows = slice(start, start + chunk)
        for i, field in enumerate(state):
            if field.dim() == 2:
                out[rows] += (field[rows].long() * weights).sum(dim=1)
            else:
                out[rows] += field[rows].long() * (17 + 14 * i)
    return out


def _routed_ops(live, busy, pad, num_docs, cols, device):
    """(K, busy) op fields widened with `pad` noop padding columns, and
    the (busy + pad,) routing vector with the num_docs sentinel."""
    import torch

    from hocuspocus_tpu_torch.tpu import kernels as tk

    num_slots = live[0].shape[0]
    fields = []
    for value, default in zip(live, (0, 0, 0, 0, NONE, 0, NONE, 0)):
        full = np.full((num_slots, busy + pad), default, value.dtype)
        full[:, :busy] = value
        fields.append(full)
    slots_np = np.full(busy + pad, num_docs, np.int32)
    slots_np[:busy] = cols
    return tk.ops_from_numpy(fields, device), torch.from_numpy(slots_np).to(device)


def phase_sparse(rng, seeded, num_docs, busy, pad, num_slots, reps):
    """K1 at deployment scale: a 100k-row arena, `busy` routed rows plus
    `pad` padding columns; unrouted rows must not change."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk

    dev = torch.device("cuda")
    src_rows = seeded.id_client.shape[0]
    tile = torch.arange(num_docs, device=dev) % src_rows
    state = tk.DocState(*(field.index_select(0, tile) for field in seeded))
    arena_gb = sum(f.numel() * f.element_size() for f in state) / 1e9
    cols = np.sort(rng.choice(num_docs, size=busy, replace=False)).astype(np.int32)
    routed = torch.from_numpy(cols).to(dev).long()
    # this run's clocks per (client, routed row): every client's clock
    # continues past the ids its tiled source row already holds
    next_clock = np.zeros((2, busy), np.int64)
    for ci, cid in enumerate(CLIENTS.view(np.int32)):
        rows = tk.gather_doc_rows(state, routed)
        own = torch.where(rows.id_client == int(cid), rows.id_clock + 1, 0)
        next_clock[ci] = own.amax(dim=1).cpu().numpy()
    ops, slots = _routed_ops(random_ops(rng, next_clock, num_slots), busy, pad, num_docs, cols, dev)

    before = tk.gather_doc_rows(state, routed)
    expected = clone_state(before)
    lengths = plain_with_lengths(expected, tk.OpBatch(*(f[:, :busy] for f in ops)))
    checksum_before = _row_checksums(state)
    _, count = ti.integrate_op_slots_sparse_fast(state, ops, slots)
    torch.cuda.synchronize()
    check(int(count) == int(tk.op_count(ops)), "sparse: op counts differ")
    after = tk.gather_doc_rows(state, routed)
    check(states_equal(after, expected), "sparse: routed rows differ from the plain version")
    unrouted = torch.ones(num_docs, dtype=torch.bool, device=dev)
    unrouted[routed] = False
    checksum_after = _row_checksums(state)
    check(
        torch.equal(checksum_before[unrouted], checksum_after[unrouted]),
        "sparse: an unrouted row changed",
    )
    err = max_abs_err(after, expected)

    def restore():
        tk.scatter_doc_rows(state, before, routed)

    ms = kernel_ms(lambda _i: ti.integrate_rows_cuda(state, ops, slots), reps, restore)
    plain_ms = event_ms(lambda: tk.integrate_op_slots_sparse(state, ops, slots), 2, restore)
    restore()
    bound_ms, bound_by, need = integrate_bound(
        tk.OpBatch(*(f[:, :busy] for f in ops)), lengths, expected.length
    )
    emit(
        "sparse",
        shape={"D": num_docs, "N": state.id_client.shape[1], "B": busy, "padding": pad, "K": num_slots},
        arena_gb=round(arena_gb, 3),
        bit_identical=True,
        unrouted_rows_unchanged=True,
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        **need,
    )


def phase_rle_dense(rng, num_docs, entries, num_slots, seed_batches, reps):
    """K2 alone at the bench's RLE shape: every row routed, rows seeded
    with `seed_batches` batches of `num_slots` op slots (bench.py's
    _measure_rle_microbatch), kernel and plain side by side."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk
    from hocuspocus_tpu_torch.tpu import kernels_rle as tr

    dev = torch.device("cuda")
    next_clock = np.zeros((2, num_docs), np.int64)
    state = tr.make_empty_rle_state(num_docs, entries, dev)
    reference = tr.make_empty_rle_state(num_docs, entries, dev)
    for _ in range(seed_batches):
        seed_ops = tk.ops_from_numpy(random_ops(rng, next_clock, num_slots), dev)
        ti.integrate_op_slots_rle_fast(state, seed_ops)
        tr.integrate_op_slots_rle(reference, seed_ops)
    torch.cuda.synchronize()
    check(states_equal(state, reference), "rle_dense seed: kernel and plain states differ")
    del reference

    ops = tk.ops_from_numpy(random_ops(rng, next_clock, num_slots), dev)
    expected = clone_state(state)
    runs = plain_rle_with_runs(expected, ops)
    work = clone_state(state)
    _, count = ti.integrate_op_slots_rle_fast(work, ops)
    torch.cuda.synchronize()
    check(int(count) == int(tk.op_count(ops)), "rle_dense: op counts differ")
    check(states_equal(work, expected), "rle_dense: kernel and plain states differ")
    err = max_abs_err(work, expected)
    del work

    copies = Copies(state, LAUNCHES_PER_WINDOW)
    slots = torch.arange(num_docs, dtype=torch.int32, device=dev)
    ms = kernel_ms(
        lambda i: ti.integrate_rle_rows_cuda(copies[i], ops, slots), reps, copies.reset, copies.count
    )
    plain_ms = event_ms(lambda: tr.integrate_op_slots_rle(copies[0], ops), 2, copies.reset)
    bound_ms, bound_by, need = rle_bound(ops, runs, expected.num_runs, entries)
    copies.clear()
    emit(
        "rle_dense",
        shape={"D": num_docs, "R": entries, "K": num_slots, "seed_batches": seed_batches},
        arena_mb=round(sum(f.numel() * f.element_size() for f in state) / 1e6, 3),
        bit_identical=True,
        max_abs_err=err,
        mean_num_runs=round(float(state.num_runs.float().mean()), 3),
        max_num_runs=int(state.num_runs.max()),
        overflow_rows=int(expected.overflow.sum()),
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        **need,
    )
    return state


def phase_rle_sparse(rng, seeded, num_docs, entries, busy, pad, num_slots, reps):
    """K2 at deployment scale: a `num_docs`-row resident RLE arena of
    `entries` entries a row (the seeded rows tiled into it), `busy`
    routed rows plus `pad` padding columns; unrouted rows must not
    change."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk
    from hocuspocus_tpu_torch.tpu import kernels_rle as tr

    dev = torch.device("cuda")
    src_rows, src_entries = seeded.run_client.shape
    tile = torch.arange(num_docs, device=dev) % src_rows
    state = tr.make_empty_rle_state(num_docs, entries, dev)
    for field, src in zip(state, seeded):
        if field.dim() == 2:
            field[:, :src_entries] = src.index_select(0, tile)
        else:
            field.copy_(src.index_select(0, tile))
    arena_gb = sum(f.numel() * f.element_size() for f in state) / 1e9
    cols = np.sort(rng.choice(num_docs, size=busy, replace=False)).astype(np.int32)
    routed = torch.from_numpy(cols).to(dev).long()
    # this run's clocks per (client, routed row) continue past the ids
    # its tiled source row already holds
    rows = tk.gather_doc_rows(state, routed)
    idx = torch.arange(entries, device=dev)[None, :]
    occupied = idx < rows.num_runs[:, None]
    next_clock = np.zeros((2, busy), np.int64)
    for ci, cid in enumerate(CLIENTS.view(np.int32)):
        mine = occupied & (rows.run_client == int(cid))
        ends = torch.where(mine, rows.run_clock + rows.run_len, 0)
        next_clock[ci] = ends.amax(dim=1).cpu().numpy()
    ops, slots = _routed_ops(random_ops(rng, next_clock, num_slots), busy, pad, num_docs, cols, dev)

    expected = clone_state(rows)
    runs = plain_rle_with_runs(expected, tk.OpBatch(*(f[:, :busy] for f in ops)))
    checksum_before = _row_checksums(state)
    _, count = ti.integrate_op_slots_rle_sparse_fast(state, ops, slots)
    torch.cuda.synchronize()
    check(int(count) == int(tk.op_count(ops)), "rle_sparse: op counts differ")
    after = tk.gather_doc_rows(state, routed)
    check(states_equal(after, expected), "rle_sparse: routed rows differ from the plain version")
    unrouted = torch.ones(num_docs, dtype=torch.bool, device=dev)
    unrouted[routed] = False
    checksum_after = _row_checksums(state)
    check(
        torch.equal(checksum_before[unrouted], checksum_after[unrouted]),
        "rle_sparse: an unrouted row changed",
    )
    err = max_abs_err(after, expected)

    def restore():
        tk.scatter_doc_rows(state, rows, routed)

    ms = kernel_ms(lambda _i: ti.integrate_rle_rows_cuda(state, ops, slots), reps, restore)
    plain_ms = event_ms(lambda: tr.integrate_op_slots_rle_sparse(state, ops, slots), 2, restore)
    restore()
    bound_ms, bound_by, need = rle_bound(
        tk.OpBatch(*(f[:, :busy] for f in ops)), runs, expected.num_runs, entries
    )
    emit(
        "rle_sparse",
        shape={"D": num_docs, "R": entries, "B": busy, "padding": pad, "K": num_slots},
        arena_gb=round(arena_gb, 3),
        bit_identical=True,
        unrouted_rows_unchanged=True,
        max_abs_err=err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        **need,
    )


# -- the plane end to end ----------------------------------------------------

WORDS = ["alpha ", "béta ", "γ", "zz ", "e", "plane "]


def _edit(rng, text, append_only: bool) -> None:
    length = len(text)
    if append_only:
        text.insert(length, WORDS[rng.integers(0, len(WORDS))])
    elif length > 8 and rng.random() < 0.35:
        pos = int(rng.integers(0, length - 1))
        text.delete(pos, min(int(rng.integers(1, 4)), length - pos))
    else:
        text.insert(int(rng.integers(0, length + 1)), WORDS[rng.integers(0, len(WORDS))])


class Recorder:
    """Keeps the inputs of the main path's integrate batch with the most
    ops, for the kernel-vs-plain replay at the plane's own shapes.

    Inside the timed flush it only clones the ops and slots of the first
    integrate call of the flush (device copies, no host sync). Between
    flushes, outside the timed window, `after_flush` counts that batch's
    ops and snapshots the arena, which is the next flush's input. The
    replay holds kernel and plain on that snapshot; it is the call's
    exact input unless an earlier drain of the same flush appended to
    one of its rows (the append path of the call's own drain writes
    other rows)."""

    def __init__(self, module, dense_name: str, sparse_name: str) -> None:
        self.module = module
        self.names = (dense_name, sparse_name)
        self.best = None
        self.before = None  # the arena as the current flush found it
        self.pending = None  # (ops, slots) of this flush's first call
        self.dense = getattr(module, dense_name)
        self.sparse = getattr(module, sparse_name)

    def _keep(self, ops, slots):
        if self.pending is None:
            self.pending = (
                type(ops)(*(f.clone() for f in ops)),
                None if slots is None else slots.clone(),
            )

    def after_flush(self, state) -> None:
        from hocuspocus_tpu_torch.tpu.kernels import op_count

        if self.pending is not None and self.before is not None:
            ops, slots = self.pending
            count = int(op_count(ops))
            if self.best is None or count > self.best[0]:
                self.best = (count, self.before, ops, slots)
        self.pending = None
        self.before = clone_state(state)

    def __enter__(self):
        def dense(state, ops):
            if state[0].is_cuda:
                self._keep(ops, None)
            return self.dense(state, ops)

        def sparse(state, ops, slots):
            if state[0].is_cuda:
                self._keep(ops, slots)
            return self.sparse(state, ops, slots)

        setattr(self.module, self.names[0], dense)
        setattr(self.module, self.names[1], sparse)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.names[0], self.dense)
        setattr(self.module, self.names[1], self.sparse)


def run_plane(rng, devices, num_docs, capacity, clients, rounds, on_flush=None, arena="unit",
              lanes=None, launch_count=None):
    """Drive MergePlane(arena=...) + PlaneServing on each device in
    `devices` with the same concurrent Yjs stream: `clients` replicas per doc, every
    editor edits its own replica before it sees the others' edits, and
    the updates reach the planes shuffled. `lanes[i]` puts every doc of
    plane i on the native text lane (the default: no lane). Before every
    flush the broadcast windows must match across planes byte for byte;
    after it, for every doc, the bytes TpuSyncSource serves cold and for
    a stale state vector must rebuild the converged text, and match
    across planes byte for byte. `launch_count()`, when given, is read
    around each plane's flush, and so are the garbage collector's
    collections. Returns (planes, per-plane per-round flush seconds,
    per-plane per-round collections, checks, per-plane launches)."""
    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_vector
    from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing, TpuSyncSource

    planes = [
        MergePlane(num_docs=num_docs, capacity=capacity, device=d, arena=arena) for d in devices
    ]
    servings = [PlaneServing(p) for p in planes]
    names = [f"doc-{i}" for i in range(num_docs)]
    for plane, lane in zip(planes, lanes or [False] * len(planes)):
        if lane:
            plane.enable_lane()
            for name in names:
                check(plane.register_lane(name) is not None, f"{name}: no lane slot")
    replicas, outboxes, joiners = [], [], []
    remote = object()  # origin of relayed applies: replicas do not re-send them
    for _ in names:
        ids: set[int] = set()
        while len(ids) < clients:
            ids.add(int(rng.integers(1, 2**32)))
        docs, boxes = [], []
        for cid in sorted(ids):
            doc = Doc()
            doc.client_id = cid
            box: list = []
            doc.on(
                "update",
                lambda update, origin, *rest, box=box: origin is remote or box.append(update),
            )
            docs.append(doc)
            boxes.append(box)
        replicas.append(docs)
        outboxes.append(boxes)
        joiners.append(Doc())  # a reconnecting client, synced only by stale serves
    flush_seconds = [[] for _ in planes]
    flush_gcs = [[] for _ in planes]
    launches = [0 for _ in planes]
    served_bytes = 0
    for round_no in range(rounds):
        for i, name in enumerate(names):
            docs, boxes = replicas[i], outboxes[i]
            if round_no == 0 or rng.random() < 0.25:
                editors = [0]  # one typist at the end: the append fast path
                append_only = True
            else:
                editors = list(np.flatnonzero(rng.random(clients) < 0.3)) or [
                    int(rng.integers(0, clients))
                ]
                append_only = False
            for e in editors:
                for _ in range(int(rng.integers(1, 3))):
                    _edit(rng, docs[e].get_text("t"), append_only)
            # deliver until quiet: every editor's updates go to the
            # planes (shuffled) and to every other replica
            while any(boxes):
                sent = [(j, u) for j, box in enumerate(boxes) for u in box]
                for box in boxes:
                    box.clear()
                order = rng.permutation(len(sent))
                for plane in planes:
                    for k in order:
                        plane.enqueue_update(name, sent[k][1])
                for j, doc in enumerate(docs):
                    for src, update in sent:
                        if src != j:
                            apply_update(doc, update, remote)
        windows = [serving.build_broadcast_pairs(names) for serving in servings]
        for pairs, failed in windows:
            check(not failed, f"round {round_no}: window encodes failed for {failed}")
            check(dict(pairs) == dict(windows[0][0]), f"round {round_no}: windows differ across planes")
        # the card planes take turns flushing first
        order = list(range(len(planes)))
        if round_no % 2:
            order[0], order[1] = order[1], order[0]
        for k in order:
            before = launch_count() if launch_count is not None else 0
            gc_before = sum(g["collections"] for g in gc.get_stats())
            started = time.perf_counter()
            planes[k].flush()
            flush_seconds[k].append(time.perf_counter() - started)
            flush_gcs[k].append(sum(g["collections"] for g in gc.get_stats()) - gc_before)
            if launch_count is not None:
                launches[k] += launch_count() - before
        for serving in servings:
            serving.refresh()
        if on_flush is not None:
            on_flush(planes)
        for i, name in enumerate(names):
            docs = replicas[i]
            want = docs[0].get_text("t").to_string()
            check(
                all(d.get_text("t").to_string() == want for d in docs[1:]),
                f"{name}: replicas did not converge",
            )
            stale_sv = encode_state_vector(joiners[i])
            cold = [TpuSyncSource(s, name, docs[0]).encode_state_as_update(None) for s in servings]
            stale = [
                TpuSyncSource(s, name, docs[0]).encode_state_as_update(stale_sv) for s in servings
            ]
            check(cold[0] is not None and stale[0] is not None, f"{name}: plane did not serve")
            check(all(c == cold[0] for c in cold), f"{name}: cold serves differ across planes")
            check(all(s == stale[0] for s in stale), f"{name}: stale serves differ across planes")
            rebuilt = Doc()
            apply_update(rebuilt, cold[0])
            check(rebuilt.get_text("t").to_string() == want, f"{name}: cold serve text differs")
            apply_update(joiners[i], stale[0])
            check(joiners[i].get_text("t").to_string() == want, f"{name}: stale serve text differs")
            served_bytes += len(cold[0]) + len(stale[0])
    return planes, flush_seconds, flush_gcs, {"served_bytes": served_bytes}, launches


# per arena: the tag prefix, the plane's dispatch attributes the recorder
# wraps, and the dispatchers whose launches the main path counts
ARENAS = {
    "unit": {
        "tag": "",
        "wrap": ("integrate_op_slots_fast", "integrate_op_slots_sparse_fast"),
    },
    "rle": {
        "tag": "rle_",
        "wrap": ("integrate_op_slots_rle_fast", "integrate_op_slots_rle_sparse_fast"),
    },
}


def phase_plane(rng, arena, num_docs, capacity, clients, rounds):
    """The main path over one arena: BASELINE config 2 through
    MergePlane(arena=...) on the card with every doc on the native text
    lane (the served path's default host path), beside a card plane on
    the Python host path and a CPU plane on the Python host path. The
    three arenas must agree element for element and the served bytes
    byte for byte after every flush; the two card planes' flush times and
    stages are reported side by side. The kernel's launch counts are set
    to 0 just before and read just after."""
    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    spec = ARENAS[arena]
    tag = spec["tag"] + "plane"
    dense_name, sparse_name = spec["wrap"]
    arena_checks = []
    stages = {"lane": [], "python": []}
    peaks = {"num_runs": 0, "total_units": 0}
    recorder = Recorder(mp, dense_name, sparse_name)

    def compare(planes):
        lane, python, cpu = planes
        stages["lane"].append(dict(lane.flush_stats))
        stages["python"].append(dict(python.flush_stats))
        check(states_equal(cpu.state, lane.state), f"{tag}: lane (CUDA) and CPU arenas differ")
        check(states_equal(cpu.state, python.state), f"{tag}: Python (CUDA) and CPU arenas differ")
        arena_checks.append(True)
        if arena == "rle":
            peaks["num_runs"] = max(peaks["num_runs"], int(lane.state.num_runs.max()))
            peaks["total_units"] = max(peaks["total_units"], int(lane.state.total_units.max()))
        recorder.after_flush(lane.state)

    dense_fn, sparse_fn = getattr(ti, dense_name), getattr(ti, sparse_name)
    started = time.perf_counter()
    dense_fn.launches = sparse_fn.launches = 0
    with recorder:
        planes, flush_s, flush_gcs, extra, by_plane = run_plane(
            rng, ["cuda", "cuda", "cpu"], num_docs, capacity, clients, rounds,
            on_flush=compare, arena=arena, lanes=[True, False, False],
            launch_count=lambda: dense_fn.launches + sparse_fn.launches,
        )
    launches = {dense_name: dense_fn.launches, sparse_name: sparse_fn.launches}
    total_launches = sum(launches.values())
    lane = planes[0]
    counters = lane.counters
    retired = {k: v for k, v in counters.items() if k.startswith("docs_retired_")}
    check(by_plane[0] > 0, f"{tag}: the integrate kernel never launched from the lane plane")
    check(by_plane[1] > 0, f"{tag}: the integrate kernel never launched from the Python plane")
    check(counters["flush_fast_ops"] > 0, f"{tag}: no op took the append fast path")
    check(counters["flush_slow_ops"] > 0, f"{tag}: no op took the integrate path")
    check(counters["cpu_fallbacks"] == 0, f"{tag}: CPU fallbacks happened")
    check(not any(retired.values()), f"{tag}: docs retired {retired}")
    check(all(lane.docs[f"doc-{i}"].lane_slot is not None for i in range(num_docs)),
          f"{tag}: a doc left the native lane")
    for other in planes[1:]:
        check(counters == other.counters, f"{tag}: the planes' counters differ")

    def timing(k, key):
        # with a flush per round the p99 is near the maximum: every
        # round's flush is listed, with its stages and the collections
        # the garbage collector ran inside it, and the flushes over the
        # budget are counted
        flush_ms = np.asarray(flush_s[k]) * 1e3
        stage_names = ("build_ms", "upload_ms", "dispatch_ms", "device_sync_ms")
        return {
            "flush_samples": len(flush_ms),
            "flush_p50_ms": float(np.percentile(flush_ms, 50)),
            "flush_p99_ms": float(np.percentile(flush_ms, 99)),
            "flush_max_ms": float(flush_ms.max()),
            "flushes_over_budget": int((flush_ms > FLUSH_BUDGET_MS).sum()),
            "flush_stage_p50_ms": {
                stage: float(np.median([s[stage] for s in stages[key]])) for stage in stage_names
            },
            "rounds": [
                {
                    "ms": float(ms),
                    "first": (r % 2 == 0) == (k == 0),
                    "gc": gcs,
                    "batches": st["batches"],
                    **{stage: st[stage] for stage in stage_names},
                }
                for r, (ms, gcs, st) in enumerate(zip(flush_ms, flush_gcs[k], stages[key]))
            ],
            "integrate_launches": by_plane[k],
        }

    if arena == "rle":
        extra = {
            "peak_num_runs": peaks["num_runs"],
            "peak_total_units": peaks["total_units"],
            "entries_per_unit": round(peaks["num_runs"] / max(peaks["total_units"], 1), 6),
            **extra,
        }
    emit(
        tag,
        config="BASELINE config 2: 1k Y.Text docs, 10 clients each, random-position insert/delete",
        arena=arena,
        docs=num_docs,
        capacity=capacity,
        clients=clients,
        rounds=rounds,
        seconds=round(time.perf_counter() - started, 3),
        integrate_launches=launches,
        flush_fast_ops=counters["flush_fast_ops"],
        flush_slow_ops=counters["flush_slow_ops"],
        flush_batches_dense=counters["flush_batches_dense"],
        flush_batches_sparse=counters["flush_batches_sparse"],
        flush_batches_fast=counters["flush_batches_fast"],
        cpu_fallbacks=counters["cpu_fallbacks"],
        docs_retired=retired,
        sync_serves=counters["sync_serves"],
        lane_plane=timing(0, "lane"),
        python_plane=timing(1, "python"),
        fast_path_fraction=round(
            counters["flush_fast_ops"]
            / max(counters["flush_fast_ops"] + counters["flush_slow_ops"], 1),
            6,
        ),
        arena_equal_checks=len(arena_checks),
        planes_bytes_equal=True,
        **extra,
    )
    return total_launches, recorder.best


def phase_replay(recorded, arena, reps):
    """The integrate batch of the main path with the most ops, replayed:
    kernel vs plain on the same inputs at the plane's own shape."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk
    from hocuspocus_tpu_torch.tpu import kernels_rle as tr

    tag = ARENAS[arena]["tag"] + "replay"
    if arena == "rle":
        launch, plain_dense, plain_sparse = (
            ti.integrate_rle_rows_cuda, tr.integrate_op_slots_rle, tr.integrate_op_slots_rle_sparse
        )
    else:
        launch, plain_dense, plain_sparse = (
            ti.integrate_rows_cuda, tk.integrate_op_slots, tk.integrate_op_slots_sparse
        )
    check(recorded is not None, f"{tag}: no integrate batch was recorded")
    _count, state0, ops, slots = recorded
    num_docs, width = state0[0].shape
    dense = slots is None
    if dense:
        rows = torch.arange(num_docs, device=state0[0].device)
        slots = rows.to(torch.int32)
    else:
        rows = slots.long()[slots.long() < num_docs]
    live = slots.long() < num_docs
    sub_ops = tk.OpBatch(*(f[:, live] for f in ops))
    expected = tk.gather_doc_rows(state0, rows)
    if arena == "rle":
        stats = plain_rle_with_runs(expected, sub_ops)
        bound = rle_bound(sub_ops, stats, expected.num_runs, width)
    else:
        stats = plain_with_lengths(expected, sub_ops)
        bound = integrate_bound(sub_ops, stats, expected.length)
    work = clone_state(state0)
    launch(work, ops, slots)
    torch.cuda.synchronize()
    got = tk.gather_doc_rows(work, rows)
    check(states_equal(got, expected), f"{tag}: kernel and plain rows differ")
    err = max_abs_err(got, expected)
    copies = Copies(state0, LAUNCHES_PER_WINDOW)

    def run(i):
        launch(copies[i], ops, slots)

    ms = kernel_ms(run, reps, copies.reset, copies.count)
    window = window_check(run, reps, copies.reset, copies.count)
    # the same window around a one-element PyTorch kernel: what the
    # events add to a launch's own duration
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    window_reference = window_check(
        lambda _i: one.fill_(1), reps, launches=copies.count, name="FillFunctor"
    )
    dense_name, sparse_name = ARENAS[arena]["wrap"]
    if dense:
        dispatch = getattr(ti, dense_name)
        host_us = wrapper_us(lambda: dispatch(copies[0], ops), reps, copies.reset)
        plain_ms = event_ms(lambda: plain_dense(copies[0], ops), 3, copies.reset)
    else:
        dispatch = getattr(ti, sparse_name)
        host_us = wrapper_us(lambda: dispatch(copies[0], ops, slots), reps, copies.reset)
        plain_ms = event_ms(lambda: plain_sparse(copies[0], ops, slots), 3, copies.reset)
    copies.clear()
    bound_ms, bound_by, need = bound
    emit(
        tag,
        shape={"D": num_docs, "N" if arena == "unit" else "R": width,
               "K": ops.kind.shape[0], "B": ops.kind.shape[1]},
        bit_identical=True,
        ms=ms,
        wrapper_us=host_us,
        window_check=window,
        window_reference=window_reference,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        **need,
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_served_replay(recorded, arena, suffix=""):
    """The served path's integrate batch with the most ops, replayed
    through the dispatcher the plane calls (the kernel) and through the
    plain version, each on its own copy of the same arena snapshot: the
    whole arena must agree element for element."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk
    from hocuspocus_tpu_torch.tpu import kernels_rle as tr

    tag = ARENAS[arena]["tag"] + "server" + suffix + "_replay"
    check(recorded is not None, f"{tag}: no integrate batch was recorded")
    count, state0, ops, slots = recorded
    dense_name, sparse_name = ARENAS[arena]["wrap"]
    if arena == "rle":
        plain_dense, plain_sparse = tr.integrate_op_slots_rle, tr.integrate_op_slots_rle_sparse
    else:
        plain_dense, plain_sparse = tk.integrate_op_slots, tk.integrate_op_slots_sparse
    kernel, plain = clone_state(state0), clone_state(state0)
    if slots is None:
        kernel, _ = getattr(ti, dense_name)(kernel, ops)
        plain, _ = plain_dense(plain, ops)
    else:
        kernel, _ = getattr(ti, sparse_name)(kernel, ops, slots)
        plain, _ = plain_sparse(plain, ops, slots)
    torch.cuda.synchronize()
    err = max_abs_err(kernel, plain)
    check(states_equal(kernel, plain) and err == 0, f"{tag}: kernel and plain arenas differ")
    num_docs, width = state0[0].shape
    emit(
        tag,
        shape={"D": num_docs, "N" if arena == "unit" else "R": width,
               "K": ops.kind.shape[0], "B": ops.kind.shape[1]},
        layout="dense" if slots is None else "sparse",
        ops=count,
        bit_identical=True,
        max_abs_err=err,
    )
    return err


# -- the served path: the port's server with TpuMergeExtension --------------


def percentiles_ms(seconds) -> dict:
    values = np.asarray(seconds, np.float64) * 1e3
    if not values.size:
        return {"n": 0, "p50_ms": None, "p99_ms": None}
    return {
        "n": int(values.size),
        "p50_ms": float(np.percentile(values, 50)),
        "p99_ms": float(np.percentile(values, 99)),
    }


def _server_edit(rng, text) -> bool:
    """One random-position edit of `text` (a delete a third of the time
    once it holds some text); True when it inserted."""
    length = len(text)
    if length > 8 and rng.random() < 0.35:
        pos = int(rng.integers(0, length - 1))
        text.delete(pos, min(int(rng.integers(1, 4)), length - pos))
        return False
    text.insert(int(rng.integers(0, length + 1)), WORDS[rng.integers(0, len(WORDS))])
    return True


class EditClock:
    """Edit -> observe latency on the providers' clocks: an insert by one
    provider of a doc is observed when another provider of the same doc
    (the doc's first provider, or its second for the first's own edits)
    holds the insert's last clock."""

    def __init__(self, idle) -> None:
        self.pending: dict = {}  # observer provider -> [(client, clock, t_edit)]
        self.waiting = 0
        self.samples: list = []
        self.idle = idle  # an asyncio.Event, set while nothing is pending
        idle.set()

    def watch(self, provider) -> None:
        self.pending[provider] = []
        provider.document.on("update", lambda *_args, p=provider: self._check(p))

    def expect(self, observer, editor) -> None:
        doc = editor.document
        clock = doc.store.get_state_vector()[doc.client_id]
        self.pending[observer].append((doc.client_id, clock, time.perf_counter()))
        self.waiting += 1
        self.idle.clear()

    def _check(self, observer) -> None:
        waiting = self.pending.get(observer)
        if not waiting:
            return
        now = time.perf_counter()
        sv = observer.document.store.get_state_vector()
        keep = []
        for client, clock, t_edit in waiting:
            if sv.get(client, 0) >= clock:
                self.samples.append(now - t_edit)
            else:
                keep.append((client, clock, t_edit))
        self.waiting -= len(waiting) - len(keep)
        self.pending[observer] = keep
        if not self.waiting:
            self.idle.set()


async def _converge(pairs, deadline: float, what: str) -> None:
    """Wait until every (provider, server Document) pair holds one text."""

    left = list(pairs)
    while left:
        left = [
            (p, doc) for p, doc in left
            if p.document.get_text("t").to_string() != doc.get_text("t").to_string()
        ]
        if not left:
            return
        check(time.perf_counter() < deadline, f"{what}: {len(left)} providers never converged")
        await asyncio.sleep(0.02)


class HostSeams:
    """Wall time of the served path's host calls, on whichever thread
    makes them. The lane's C++ never lets the interpreter lock go, so a
    `lane.*` call's wall time is the time it holds the lock; the Python
    host path's seams (`enqueue_update`, `broadcast_windows`, `drain`)
    let it go every `sys.getswitchinterval()`. `flush_wait` is each
    flush's wait from its executor submit to its start on the worker
    thread; `flush_wall` and `flush_cpu` are the flush's own wall and
    thread CPU time there, so their difference is the time the flush
    thread spent off the CPU (the lock, or a blocking device wait).
    `gc<generation>.<loop|worker>` is each garbage collection's time, by
    the thread that ran it; a collection holds the lock throughout."""

    def __init__(self) -> None:
        self.samples = collections.defaultdict(list)
        self._gc_started = 0.0

    def collected(self, phase, info) -> None:
        """The `gc.callbacks` hook."""
        if phase == "start":
            self._gc_started = time.perf_counter()
            return
        where = "loop" if threading.current_thread() is threading.main_thread() else "worker"
        key = f"gc{info['generation']}.{where}"
        self.samples[key].append(time.perf_counter() - self._gc_started)

    def timed(self, key, fn):
        samples = self.samples[key]

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                samples.append(time.perf_counter() - t0)

        return call

    def reset(self) -> None:
        for samples in self.samples.values():
            samples.clear()

    def summary(self) -> dict:
        out = {}
        for key, samples in sorted(self.samples.items()):
            if samples:
                ms = np.asarray(samples) * 1e3
                out[key] = {
                    "n": len(ms),
                    "total_ms": float(ms.sum()),
                    "p50_ms": float(np.percentile(ms, 50)),
                    "p99_ms": float(np.percentile(ms, 99)),
                    "max_ms": float(ms.max()),
                }
        return out


class _TimedCodec:
    """The native module with every function timed under `lane.<name>`."""

    def __init__(self, codec, seams: HostSeams) -> None:
        self._codec, self._seams = codec, seams

    def __getattr__(self, name):
        fn = self._seams.timed(f"lane.{name}", getattr(self._codec, name))
        setattr(self, name, fn)
        return fn


class _TimedExecutor(ThreadPoolExecutor):
    """The loop's default executor, timing each flush from its submit to
    its start on a worker thread."""

    def __init__(self, seams: HostSeams) -> None:
        super().__init__(thread_name_prefix="flush")
        self._waits = seams.samples["flush_wait"]

    def submit(self, fn, /, *args, **kwargs):
        if "_flush_now" not in getattr(fn, "__qualname__", ""):
            return super().submit(fn, *args, **kwargs)
        submitted = time.perf_counter()
        waits = self._waits

        def run():
            waits.append(time.perf_counter() - submitted)
            return fn(*args, **kwargs)

        return super().submit(run)


async def run_server(rng, arena, num_docs, capacity, clients, rounds, device="cuda",
                     profile_kernels=False, recorder=None, native_lane=True):
    """The served path over one arena: the port's Hocuspocus core with
    TpuMergeExtension(serve=True, every scheduling knob at its default)
    and `clients` HocuspocusProviders per doc, each on an in-process
    socket of its own (one browser tab each). Each round every
    provider makes one random-position edit, all of a doc's edits before
    any is delivered, and the round waits until every doc has converged.
    Then two waves of one late joiner per doc, each on a socket of its
    own: the first is served from device state, the second from the
    sync cache. A `recorder` (Recorder) keeps the traffic's biggest
    integrate batch. Last, one more edit per doc is flushed on the loop
    thread with the loop held (`idle_flush`). `native_lane` is the
    extension's option (on by default, as there). HostSeams times the
    host calls through the traffic (`host_traffic`) and the join waves
    (`host_joins`). Returns (the extension, the phase's numbers)."""
    import contextlib

    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_vector
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import TpuMergeExtension
    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

    reset_device_lane()
    seams = HostSeams()
    asyncio.get_running_loop().set_default_executor(_TimedExecutor(seams))
    started = time.perf_counter()
    ext = TpuMergeExtension(
        num_docs=num_docs, capacity=capacity, serve=True, arena=arena, device=device,
        native_lane=native_lane,
    )
    core = Hocuspocus(Configuration(quiet=True, extensions=[ext]))
    await core.ensure_configured()
    await core.hooks("on_listen", Payload(instance=core, configuration=core.configuration, port=None))
    await ext.warmup_task
    check(ext.plane.compile_watch.warmed, f"{arena} server: the warm grid did not finish")
    warm_seconds = time.perf_counter() - started

    plane = ext.plane
    cycles = []  # (seconds, flush_stats) of every flush that integrated ops
    real_flush = plane.flush
    flush_wall, flush_cpu = seams.samples["flush_wall"], seams.samples["flush_cpu"]

    def timed_flush(max_batches=None):
        t0, c0 = time.perf_counter(), time.thread_time()
        count = real_flush(max_batches)
        wall = time.perf_counter() - t0
        flush_wall.append(wall)
        flush_cpu.append(time.thread_time() - c0)
        if count:
            cycles.append((wall, dict(plane.flush_stats)))
        if recorder is not None:
            recorder.after_flush(plane.state)
        return count

    plane.flush = timed_flush
    plane.enqueue_update = seams.timed("enqueue_update", plane.enqueue_update)
    plane._drain_ops = seams.timed("drain", plane._drain_ops)
    ext.serving.build_broadcast_pairs = seams.timed(
        "broadcast_windows", ext.serving.build_broadcast_pairs
    )
    if plane._lane_codec is not None:
        plane._lane_codec = _TimedCodec(plane._lane_codec, seams)
    names = [f"doc-{i}" for i in range(num_docs)]
    groups = []
    for name in names:
        group = []
        for _client in range(clients):
            provider = HocuspocusProvider(
                name=name, websocket_provider=InProcessProviderSocket(core)
            )
            provider.attach()
            group.append(provider)
        groups.append(group)
    everyone = [p for group in groups for p in group]
    await asyncio.wait_for(_all_synced(everyone), 600)
    setup_seconds = time.perf_counter() - started

    dense_name, sparse_name = ARENAS[arena]["wrap"]
    dense_fn, sparse_fn = getattr(ti, dense_name), getattr(ti, sparse_name)
    clock = EditClock(asyncio.Event())
    for group in groups:
        clock.watch(group[0])
        clock.watch(group[1])
    base = {key: plane.counters[key] for key in ("flush_fast_ops", "flush_slow_ops")}
    if recorder is not None:
        recorder.before = clone_state(plane.state)
    dense_fn.launches = sparse_fn.launches = 0
    seams.reset()
    gc.callbacks.append(seams.collected)
    traffic_started = time.perf_counter()
    profiler = None
    if profile_kernels:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CUDA])
        profiler.__enter__()
    recording = recorder if recorder is not None else contextlib.nullcontext()
    try:
        with recording:
            for _round in range(rounds):
                for d, group in enumerate(groups):
                    for j, provider in enumerate(group):
                        if _server_edit(rng, provider.document.get_text("t")):
                            clock.expect(group[1] if j == 0 else group[0], provider)
                    if d % 16 == 15:
                        await asyncio.sleep(0)
                await asyncio.wait_for(clock.idle.wait(), 300)
                await _converge(
                    [(p, core.documents[p.name]) for p in everyone],
                    time.perf_counter() + 120, f"{arena} server",
                )
            # the traffic ends when the card has integrated all of it: nothing
            # queued and no flush cycle in flight (its counters grow per batch)
            deadline = time.perf_counter() + 120
            while plane.pending_ops() > 0 or ext._flush_inflight:
                check(time.perf_counter() < deadline, f"{arena} server: the queues never drained")
                await asyncio.sleep(0.005)
            traffic_seconds = time.perf_counter() - traffic_started
            integrated = sum(plane.counters[key] - base[key] for key in base)
            host_traffic = seams.summary()
            seams.reset()
            joins, joiners = await _join_waves(core, names, plane)
            host_joins = seams.summary()
    finally:
        gc.callbacks.remove(seams.collected)
        if profiler is not None:
            profiler.__exit__(None, None, None)
    profiled_seconds = time.perf_counter() - traffic_started
    launches = {dense_name: dense_fn.launches, sparse_name: sparse_fn.launches}
    idle_flush = await _idle_flush(ext, core, groups, rng, real_flush)

    # every provider, joiners included, holds its server document's text
    await _converge(
        [(p, core.documents[p.name]) for p in everyone + joiners],
        time.perf_counter() + 120, f"{arena} server",
    )
    # the bytes served for an empty state vector rebuild every doc
    for name in names:
        document = core.documents[name]
        served = await document.sync_source.encode_state_as_update_async(None)
        check(served is not None, f"{arena} server: {name} was not served from the plane")
        rebuilt = Doc()
        apply_update(rebuilt, served)
        check(
            rebuilt.get_text("t").to_string() == document.get_text("t").to_string(),
            f"{arena} server: {name}: served bytes rebuild another text",
        )
        check(
            encode_state_vector(rebuilt) == encode_state_vector(document),
            f"{arena} server: {name}: served bytes rebuild another state vector",
        )
    kernel_ms = None
    if profiler is not None:
        kernel_us = sum(
            getattr(event, "device_time_total", 0) or 0
            for event in profiler.key_averages()
            if "integrate" in event.key and "kernel" in event.key
        )
        kernel_ms = kernel_us / 1e3 if kernel_us else None
    counters = dict(plane.counters)
    served_docs = sum(name in ext._docs for name in names)
    lane_docs = sum(
        name in plane.docs and plane.docs[name].lane_slot is not None for name in names
    )
    lane = ext.lane.snapshot()["counters"] if ext.lane is not None else None
    governor = ext.governor.snapshot()["counters"] if ext.governor is not None else None
    warm = plane.compile_watch
    for p in everyone + joiners:
        p.destroy()
        p.websocket_provider.destroy()
    await core.hooks("on_destroy", Payload(instance=core))
    stats = [s for _t, s in cycles]
    return ext, {
        "warm_seconds": round(warm_seconds, 3),
        "setup_seconds": round(setup_seconds, 3),
        "traffic_seconds": round(traffic_seconds, 3),
        "seconds": round(time.perf_counter() - started, 3),
        "edit_observe": percentiles_ms(clock.samples),
        "join_waves": joins,
        "flush_cycles": percentiles_ms([t for t, _s in cycles]),
        "flush_stage_p50_ms": {
            key: float(np.median([s[key] for s in stats])) if stats else None
            for key in ("build_ms", "upload_ms", "dispatch_ms", "device_sync_ms")
        },
        "flush_stage_p99_ms": {
            key: float(np.percentile([s[key] for s in stats], 99)) if stats else None
            for key in ("build_ms", "upload_ms", "dispatch_ms", "device_sync_ms")
        },
        "ops_integrated": integrated,
        "ops_per_s": integrated / traffic_seconds if traffic_seconds else None,
        "integrate_launches": launches,
        "profiled_seconds": round(profiled_seconds, 3),
        "kernel_device_ms": kernel_ms,
        "kernel_device_share": None if kernel_ms is None else kernel_ms / 1e3 / profiled_seconds,
        "idle_flush": idle_flush,
        "switch_interval_ms": sys.getswitchinterval() * 1e3,
        "host_traffic": host_traffic,
        "host_joins": host_joins,
        "peak_resident_providers": len(everyone) + len(joiners),
        "served_docs": served_docs,
        "native_lane": ext.native_lane,
        "lane_docs": lane_docs,
        "counters": counters,
        "lane": lane,
        "governor": governor,
        "warm_launches": {"first": warm.first_launches, "unwarmed": warm.unwarmed_launches},
    }


async def _idle_flush(ext, core, groups, rng, flush) -> dict:
    """One more edit by one provider of every doc, held in the plane's
    queues (holding `flush_lock` keeps every flush cycle off them), then
    flushed on the loop thread while the loop waits for it: the served
    path's flush engine on a batch the size of a served cycle's, with no
    other Python thread wanting the interpreter lock. Its stages set
    beside the served cycles' tell the engine's own time from the time
    it waits for the loop thread."""

    plane = ext.plane
    editors = [group[-1] for group in groups]
    async with plane.flush_lock:
        for d, provider in enumerate(editors):
            _server_edit(rng, provider.document.get_text("t"))
            if d % 16 == 15:
                await asyncio.sleep(0)
        await _converge(
            [(p, core.documents[p.name]) for p in editors],
            time.perf_counter() + 120, "idle flush",
        )
        queued = plane.pending_ops()
        started = time.perf_counter()
        flush(None)
        seconds = time.perf_counter() - started
        stats = dict(plane.flush_stats)
        ext.serving.refresh()
        ext._validate_served()
    return {
        "ops": queued,
        "ms": seconds * 1e3,
        "batches": stats["batches"],
        "stages_ms": {
            key: stats[key] for key in ("build_ms", "upload_ms", "dispatch_ms", "device_sync_ms")
        },
    }


async def _join_waves(core, names, plane):
    """Two waves of one late joiner per doc, each on a socket of its own:
    (per-wave join -> synced numbers, the joiners)."""

    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket

    joins = []
    joiners = []
    for wave in range(2):
        serves_before = plane.counters["sync_serves"]
        hits_before = plane.counters["sync_cache_hits"]
        synced_at = {}
        wave_joiners = []
        t_join = time.perf_counter()
        for name in names:
            provider = HocuspocusProvider(name=name, websocket_provider=InProcessProviderSocket(core))
            provider.on(
                "synced",
                lambda payload, p=provider: payload.get("state")
                and synced_at.setdefault(p, time.perf_counter()),
            )
            provider.attach()
            wave_joiners.append(provider)
        await asyncio.wait_for(_all_synced(wave_joiners), 300)
        joins.append(
            {
                "wave": wave + 1,
                **percentiles_ms([synced_at[p] - t_join for p in wave_joiners]),
                "sync_serves": plane.counters["sync_serves"] - serves_before,
                "sync_cache_hits": plane.counters["sync_cache_hits"] - hits_before,
            }
        )
        joiners += wave_joiners
    return joins, joiners


async def _all_synced(providers) -> None:
    from hocuspocus_tpu_torch.aio import await_synced

    await await_synced(providers, timeout=600, what="providers")


def phase_server(rng, arena, num_docs, capacity, clients, rounds, cuts, native_lane=True):
    """The served path on the card over one arena (run_server), with the
    checks that hold it: every provider converged, the served bytes
    rebuild every doc, broadcasts went through the plane, every join was
    served from it, nothing fell back to the CPU or retired (no lane
    demote either), every doc is still served, every doc is on the
    native text lane when it is on (`native_lane=False`: the
    `*_server_python` phases, none), and the arena's kernel launched
    from this path. Then the path's biggest integrate batch is replayed
    through the kernel and the plain version (phase_served_replay).
    Returns (launches, max_abs_err of the replay)."""
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    suffix = "" if native_lane else "_python"
    tag = ARENAS[arena]["tag"] + "server" + suffix
    recorder = Recorder(mp, *ARENAS[arena]["wrap"])
    _ext, out = asyncio.run(
        run_server(
            rng, arena, num_docs, capacity, clients, rounds,
            profile_kernels=True, recorder=recorder, native_lane=native_lane,
        )
    )
    counters = out["counters"]
    retired = {k: v for k, v in counters.items() if k.startswith("docs_retired_")}
    joins = 2 * num_docs
    launches = sum(out["integrate_launches"].values())
    check(counters["plane_broadcasts"] > 0, f"{tag}: no broadcast went through the plane")
    check(counters["sync_serves"] >= joins, f"{tag}: {counters['sync_serves']} sync serves for {joins} joins")
    check(counters["cpu_fallbacks"] == 0, f"{tag}: {counters['cpu_fallbacks']} CPU fallbacks")
    check(not any(retired.values()), f"{tag}: docs retired {retired}")
    check(out["served_docs"] == num_docs, f"{tag}: {out['served_docs']} of {num_docs} docs still served")
    check(launches > 0, f"{tag}: the integrate kernel never launched from the server path")
    check(out["native_lane"] is native_lane, f"{tag}: native_lane is {out['native_lane']}")
    lane_want = num_docs if native_lane else 0
    check(out["lane_docs"] == lane_want, f"{tag}: {out['lane_docs']} of {num_docs} docs on the lane")
    emit(
        tag,
        gpu=nvidia_smi_line(),
        config="BASELINE config 2: 1k Y.Text docs, 10 clients each, random-position insert/delete",
        arena=arena,
        docs=num_docs,
        capacity=capacity,
        clients=clients,
        rounds=rounds,
        cuts=cuts,
        joins=joins,
        docs_retired=retired,
        **{k: v for k, v in out.items() if k != "counters"},
        sync_serves=counters["sync_serves"],
        sync_cache_hits=counters["sync_cache_hits"],
        plane_broadcasts=counters["plane_broadcasts"],
        cpu_fallbacks=counters["cpu_fallbacks"],
        flush_fast_ops=counters["flush_fast_ops"],
        flush_slow_ops=counters["flush_slow_ops"],
    )
    err = phase_served_replay(recorder.best, arena, suffix)
    recorder.best = recorder.before = None
    return launches, err


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import hocuspocus_tpu_torch.tpu  # noqa: F401
    except ImportError as error:
        print(f"chip_smoke: run from the root of a checkout ({error})", file=sys.stderr)
        return 2

    started = time.perf_counter()
    random.seed(args.seed)  # the CRDT engine draws replacement client ids here
    rng = np.random.default_rng(args.seed)
    results = {"unit": {}, "rle": {}}
    try:
        phase_native_build()
        phase_build()
        seeded = phase_dense(rng, num_docs=8192, capacity=5632, num_slots=64, reps=5)
        phase_sparse(rng, seeded, num_docs=100_000, busy=1024, pad=32, num_slots=16, reps=5)
        del seeded
        torch.cuda.empty_cache()
        seeded = phase_rle_dense(
            rng, num_docs=8192, entries=1024, num_slots=8, seed_batches=1024 // 3 // 8, reps=5
        )
        phase_rle_sparse(
            rng, seeded, num_docs=100_000, entries=4096, busy=1024, pad=32, num_slots=16, reps=5
        )
        del seeded
        torch.cuda.empty_cache()
        for arena, rounds in (("unit", UNIT_PLANE_ROUNDS), ("rle", RLE_PLANE_ROUNDS)):
            launches, recorded = phase_plane(
                rng, arena, num_docs=1024, capacity=4096, clients=10, rounds=rounds
            )
            results[arena]["plane"] = launches
            results[arena].update(phase_replay(recorded, arena, reps=10))
            del recorded
        for arena in ("unit", "rle"):
            results[arena]["server"], results[arena]["server_err"] = phase_server(
                rng, arena, num_docs=1024, capacity=4096, clients=SERVER_CLIENTS,
                rounds=SERVER_ROUNDS, cuts=SERVER_CUTS,
            )
        for arena in ("unit", "rle"):
            # the earlier served path (Python host path), kept driven
            results[arena]["server_python"], results[arena]["server_python_err"] = phase_server(
                rng, arena, num_docs=1024, capacity=4096, clients=SERVER_CLIENTS,
                rounds=PYTHON_SERVER_ROUNDS, cuts=PYTHON_SERVER_CUTS, native_lane=False,
            )
        smi = nvidia_smi_line()
    except SmokeFailure as failure:
        print(f"chip_smoke: FAILED: {failure}", file=sys.stderr)
        return 1
    emit("total", seconds=round(time.perf_counter() - started, 3))
    print(smi, flush=True)
    kernels = (
        ("integrate_rows", "unit", "integrate.cu", "hocuspocus_tpu/tpu/pallas_kernels.py:34"),
        ("integrate_rle_rows", "rle", "integrate_rle.cu", "hocuspocus_tpu/tpu/pallas_kernels_rle.py:35"),
    )
    record = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": f"hocuspocus_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(results[arena][path] for path in PATHS),
                "launches_by_path": {path: results[arena][path] for path in PATHS},
                "max_abs_err": max(
                    results[arena]["max_abs_err"],
                    results[arena]["server_err"],
                    results[arena]["server_python_err"],
                ),
                "ms": results[arena]["ms"],
                "plain_ms": results[arena]["plain_ms"],
                "bound_ms": results[arena]["bound_ms"],
                "bound_by": results[arena]["bound_by"],
                "library_ms": None,
            }
            for name, arena, source, replaces in kernels
        ]
    }
    print(json.dumps(record), flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
