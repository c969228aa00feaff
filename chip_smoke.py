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
over each arena with concurrent Yjs editors through two planes on the
card, one with the native text lane and one on the Python host path,
every arena element and served byte held equal after every flush. Then
it drives the served
path over each arena: the port's Hocuspocus core with
`TpuMergeExtension(serve=True)` (the native text lane on, its default)
and 10 in-process providers a doc editing 512 docs, then two join waves
(phases `server`, `rle_server`), and the same path with
`native_lane=False` (`server_python`, `rle_server_python`),
each path's biggest integrate batch replayed through the kernel and the
plain version (`server_replay`, `rle_server_replay`, ...). Then the JAX
CLI's `--tpu-serve --metrics --wal-dir D` deployment over each arena
(`supervised_server`, `rle_supervised_server`: the supervised plane with
eviction and hydration, `Metrics` scraped and held to the books, the
99 Hz profiler's top stacks, every doc replayed from the WAL) and the
self-compacting plane (`compact_plane`, `rle_compact_plane`). Last,
BASELINE config 4's production topology, two served planes on the card
with the port's Redis extension between them over its mini-redis
(`cluster_server`, unit arena), the same Y.Text docs as config 2 through
the edge tier, two stateless edges in front of two merge cells over the
relay bus with a hot doc's follower and a drain under traffic
(`edge_server`, unit arena), and configs 3 and 1, Tiptap documents
loaded through the Webhook and the transformer behind Logger, SQLite and
History on the run-length plane (`rle_tiptap_server`), each with its
replay. Then the port's entry points: `cli_server` starts `python -m
hocuspocus_tpu_torch.cli --tpu-serve --metrics --wal-dir D` in a process
of its own and drives it over websockets from here (1,024 docs, SIGTERM's
drain, a second process replaying the WAL), and `loadgen` runs the
scenario runner (`smoke`, `replication_lag` at 1,024 docs, `edge_fanout`,
`edge_handoff`, `mega_audience`, `multi_device_storm` and
`diurnal_autoscale` at their defaults) and `python
-m hocuspocus_tpu_torch.loadgen --scenario smoke`. Then the CLI's
`--tpu-serve --tpu-devices 4` deployment in process, four supervised
per-device merge cells on the card, each with its own lane, through a
skew round that makes the rebalancer migrate docs and a late cell whose
breaker opens and closes alone (`multi_device_server`, unit arena, with
its replay), and the same deployment under `--fleet-autoscale
--fleet-warm-spares 2` through diurnal_autoscale's day with fresh
sessions opening docs as it rises, the fleet controller activating
parked cells and parking them by night with their docs migrated under
the edits (`fleet_server`, with its replay). Last, where the
smoke's own 850 s budget leaves room, `supervised_server_full` runs the
unit supervised phase once more with all 1,024 docs driven, in a child
process (`--supervised-docs 1024`), and reports how it ended without
failing the smoke. Each phase prints
one line; any failure of the others exits nonzero. A kernel phase's `ms` is the
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
import contextlib
import gc
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
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
# planes (three since the text lane), so the rounds were cut to 8, and to 4
# for the entry points' phases; the 50 ms flush budget is read per flush
# over these
UNIT_PLANE_ROUNDS = 4
RLE_PLANE_ROUNDS = 4
# the plane phases' planes: the card with the text lane, the card on the
# Python host path (a third, CPU plane on the Python host path was cut for
# time, the ROADMAP's next cut; the two card planes are held against each
# other, and the replays hold the kernel against the plain version)
PLANE_DEVICES = ("cuda", "cuda")
PLANE_LANES = (True, False)
PLANE_CUTS = {
    "twin": "the CPU plane on the Python host path dropped for time",
    "rounds": "4 rounds (8 before the CLI and loadgen phases)",
}
# the served path (phases server, rle_server): BASELINE config 2's docs x
# 10 clients at capacity 4,096; the docs and rounds are cut (each round is
# one edit a provider through the server core on one host thread)
SERVER_DOCS = 512
SERVER_CLIENTS = 10
SERVER_ROUNDS = 1
SERVER_CUTS = {
    "docs": "512 docs (1,024 before the CLI and loadgen phases)",
    "rounds": "1 round of one edit per provider (6 before the supervised phases)",
}
# the served path on the Python host path (native_lane=False), kept driven
# beside the lane's; its docs and rounds are cut
PYTHON_SERVER_DOCS = 256
PYTHON_SERVER_ROUNDS = 1
PYTHON_SERVER_JOIN_WAVES = 1
PYTHON_SERVER_CUTS = {
    "docs": "256 docs (1,024 before the CLI and loadgen phases)",
    "rounds": "1 round of one edit per provider (3 before the supervised phases)",
    "join_waves": "1 join wave, one joiner a doc (2 before Metrics and the WAL joined the supervised phases)",
}
# PERF.md's budget for one flush cycle of the plane phases
FLUSH_BUDGET_MS = 50.0
# the main path's parts, in the kernels' record: plane (the lane and the
# Python card planes), server (native lane), server_python
PATHS = (
    "plane", "server", "server_python", "supervised_server", "compact_plane",
    "cluster_server", "edge_server", "tiptap_server", "cli_server", "loadgen", "multi_device_server",
    "fleet_server",
)

CLIENTS = np.asarray([7, 0x9000_0001], np.uint32)
NONE = 0xFFFFFFFF


class SmokeFailure(RuntimeError):
    pass


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


# (tag, perf_counter) of every emitted line: main's `phase_clock` line
# gives each line the seconds since the line before it
EMITTED = []


def emit(tag: str, **fields) -> None:
    EMITTED.append((tag, time.perf_counter()))
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

    def __init__(self, module, dense_name: str, sparse_name: str, gate=None) -> None:
        self.module = module
        self.names = (dense_name, sparse_name)
        # with two planes on the card, `gate()` is true only inside the
        # recorded plane's flush (the other plane's calls are not kept)
        self.gate = gate
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
        def kept(state) -> bool:
            return state[0].is_cuda and (self.gate is None or self.gate())

        def dense(state, ops):
            if kept(state):
                self._keep(ops, None)
            return self.dense(state, ops)

        def sparse(state, ops, slots):
            if kept(state):
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
        # the kernels' names in a torch.profiler trace (csrc/integrate.cu)
        "kernels": ("integrate_warp_kernel", "integrate_block_kernel"),
    },
    "rle": {
        "tag": "rle_",
        "wrap": ("integrate_op_slots_rle_fast", "integrate_op_slots_rle_sparse_fast"),
        "kernels": ("integrate_rle_warp_kernel", "integrate_rle_block_kernel"),
    },
}


def phase_plane(rng, arena, num_docs, capacity, clients, rounds):
    """The main path over one arena: BASELINE config 2 through
    MergePlane(arena=...) on the card with every doc on the native text
    lane (the served path's default host path), beside a card plane on
    the Python host path (PLANE_DEVICES). The arenas must agree element
    for element and the served bytes byte for byte after every flush; the two card planes' flush times and
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
        lane, python = planes[:2]
        stages["lane"].append(dict(lane.flush_stats))
        stages["python"].append(dict(python.flush_stats))
        for other in planes[1:]:
            check(states_equal(other.state, lane.state),
                  f"{tag}: lane (CUDA) and {other.device} Python arenas differ")
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
            rng, list(PLANE_DEVICES), num_docs, capacity, clients, rounds,
            on_flush=compare, arena=arena, lanes=list(PLANE_LANES),
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
        planes=[f"{d}{' + lane' if lane else ''}" for d, lane in zip(PLANE_DEVICES, PLANE_LANES)],
        cuts=PLANE_CUTS,
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


def phase_served_replay(recorded, arena, suffix="", path="server"):
    """The served path's integrate batch with the most ops, replayed
    through the dispatcher the plane calls (the kernel) and through the
    plain version, each on its own copy of the same arena snapshot: the
    whole arena must agree element for element."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk
    from hocuspocus_tpu_torch.tpu import kernels_rle as tr

    tag = ARENAS[arena]["tag"] + path + suffix + "_replay"
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
                     profile_kernels=False, recorder=None, native_lane=True, join_waves=2):
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
            joins, joiners = await _join_waves(core, names, plane, waves=join_waves)
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
    kernel_ms = _kernel_device_ms(profiler)
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


def _kernel_device_ms(profiler):
    """The integrate kernels' device time in a torch.profiler capture
    (None without a capture or a kernel)."""
    if profiler is None:
        return None
    kernel_us = sum(
        getattr(event, "device_time_total", 0) or 0
        for event in profiler.key_averages()
        if "integrate" in event.key and "kernel" in event.key
    )
    return kernel_us / 1e3 if kernel_us else None


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


async def _join_waves(core, names, plane, waves=2):
    """`waves` waves of one late joiner per doc, each on a socket of its
    own: (per-wave join -> synced numbers, the joiners)."""

    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket

    joins = []
    joiners = []
    for wave in range(waves):
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


def phase_server(rng, arena, num_docs, capacity, clients, rounds, cuts, native_lane=True,
                 join_waves=2):
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
            join_waves=join_waves,
        )
    )
    counters = out["counters"]
    retired = {k: v for k, v in counters.items() if k.startswith("docs_retired_")}
    joins = join_waves * num_docs
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


# -- the supervised, self-compacting served plane ------------------------------

# the JAX package's CLI defaults (hocuspocus_tpu/cli.py): the runtime's init
# within 30 s, a canary every 5 s, the breaker open after 3 failures,
# compaction at 75% of a row, hydration rounds of 64 docs
SUPERVISOR_DEFAULTS = {
    "init_timeout": 30.0,
    "watchdog_interval": 5.0,
    "breaker_threshold": 3,
    "compact_threshold": 0.75,
    "hydrate_batch": 64,
}
# eviction after 2 s idle: the JAX package evicts 16 docs a maintenance
# tick of a quarter of this, so 1,024 docs leave in about 40 s (100 s at
# 5 s), the 256 driven ones in about 10 s. A doc back from the storm may idle out again before the check
# loop sees it served (a gen-2 pause of the loop lasts 2-3 s): such a doc
# is checked as it evicts
EVICT_IDLE_SECS = 2.0
SUPERVISED_ROUNDS = 1
# one /debug/profile capture (torch.profiler, CPU and CUDA) in the unit
# phase, at the quiet wait's end; taken again only where it could not
# have seen its probe (_device_capture), every attempt reported
DEVICE_PROFILE_ARENA = "unit"
DEVICE_PROFILE_SECS = 1.0
DEVICE_PROFILE_ATTEMPTS = 3
# docs driven on the 1,024-row plane (the CLI's --tpu-docs): 256, for the
# CLI and loadgen phases' time; on a slow host 10 providers a doc for
# 1,024 docs in the server's process have starved the supervisor's canary
# of the interpreter lock until three overruns in a row tripped the
# breaker, so the 1,024-doc run is kept beside it, reported and not gated
# (phase_supervised_full)
SUPERVISED_DRIVEN = 256
SUPERVISED_CUTS = {
    "rounds": "1 round of one edit per provider",
    "docs": "256 of the plane's 1,024 docs driven (1,024 before the CLI and loadgen phases)",
}
# the unit phase once more with all 1,024 docs driven, in a process of its
# own after every gated phase: reported, never gated (supervised_server_full)
SUPERVISED_FULL_DRIVEN = 1024
SMOKE_CLOCK_S = 850.0  # the smoke's own time budget
SUPERVISED_FULL_MIN_S = 240.0  # what the run needs of the budget left to start


# the JAX CLI's `--metrics --wal-dir D` (hocuspocus_tpu/cli.py:513-558):
# the sampling profiler at --profile-hz 99, Metrics with the CLI's SLO
# defaults, Durability with --wal-fsync tick
PROFILE_HZ = 99
METRICS_DEFAULTS = {"slo_e2e_p99_ms": 50.0, "slo_error_rate": 0.001, "slo_fleet_e2e_ms": 250.0}
WAL_FSYNC = "tick"
PROFILE_TOP = 15  # collapsed stacks printed per thread
PROFILE_FRAMES = 12  # leaf-side frames kept of each printed stack


async def scrape(metrics, path: str, **query):
    """One request through `Metrics.on_request`, as the websocket server
    routes it: (HTTP status, body text)."""
    from types import SimpleNamespace

    from hocuspocus_tpu_torch.server.types import Payload

    data = Payload(request=SimpleNamespace(rel_url=SimpleNamespace(path=path, query=query)))
    try:
        await metrics.on_request(data)
    except Exception as served:
        response = getattr(served, "response", None)
        if response is None:
            raise
        return response.status, response.body.decode("utf-8")
    raise SmokeFailure(f"Metrics did not answer {path}")


def parse_prometheus(text: str, what: str) -> dict:
    """Prometheus text exposition 0.0.4 -> {(name, ((label, value), ...)): value}.
    Fails on any line that is neither a comment nor a sample."""
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        match = sample.match(line)
        check(match is not None, f"{what}: not Prometheus text: {line[:200]!r}")
        labels = tuple(sorted(label.findall(match.group(3) or "")))
        key = (match.group(1), labels)
        check(key not in series, f"{what}: series {key} twice")
        series[key] = float(match.group(4))
    return series


def _compile_series() -> dict:
    """The device watch's first-launch series, {(site, shape): count}."""
    from hocuspocus_tpu_torch.observability.device_watch import compile_metrics

    events = compile_metrics()[1]
    return {
        (labels["site"], labels["shape"]): value
        for labels, value in ((dict(key), v) for key, v in events._values.items())
        if labels.get("kind") == "compile"
    }


async def _checked_scrape(tag, metrics, plane, supervisor, min_appends, grid, compiles0) -> dict:
    """Scrape /metrics with the plane's flushes held off, and hold the
    text to the books: it parses; every plane counter gauge equals
    `plane.counters` (a scrape during which a counter moved is taken
    again); the supervisor reads READY and the breaker closed; the WAL
    appended at least `min_appends` records; the first launches since
    the phase began are warm-grid shapes (the canary's is the grid's
    first), as many as the plane's watch counted. Returns the series."""
    from hocuspocus_tpu_torch.observability.device_watch import shape_label
    from hocuspocus_tpu_torch.tpu.supervisor import BREAKER_CODES, STATE_CODES, STATE_READY

    for _attempt in range(20):
        async with plane.flush_lock:
            with plane._step_lock:
                before = dict(plane.counters)
                status, text = await scrape(metrics, "/metrics")
                after = dict(plane.counters)
        if before == after:
            break
        await asyncio.sleep(0.01)
    check(before == after, f"{tag}: the plane's counters moved during every scrape")
    check(status == 200, f"{tag}: /metrics answered {status}")
    series = parse_prometheus(text, f"{tag} /metrics")
    for key, value in after.items():
        metric = f"hocuspocus_tpu_plane_{key.removeprefix('plane_')}"
        got = series.get((metric, ()))
        check(got == float(value), f"{tag}: /metrics {metric} {got} against the counter {value}")
    state = series.get(("hocuspocus_tpu_supervisor_state", ()))
    check(state == STATE_CODES[STATE_READY] == supervisor.state_code(), f"{tag}: supervisor state {state}")
    breaker = series.get(("hocuspocus_tpu_supervisor_breaker_state", ()))
    check(breaker == BREAKER_CODES["closed"], f"{tag}: breaker state {breaker}")
    appended = series.get(("hocuspocus_wal_appended_records", ()))
    check(min_appends is None or (appended is not None and appended >= min_appends),
          f"{tag}: the WAL appended {appended} records for {min_appends} edits")
    warm = {(site, shape_label(shape)) for site, shape in map(plane._warm_site, grid)}
    fresh = {
        key: value - compiles0.get(key, 0.0)
        for key, value in _compile_series().items()
        if value > compiles0.get(key, 0.0)
    }
    scraped = {
        (dict(labels)["site"], dict(labels)["shape"]): value
        for (name, labels), value in series.items()
        if name == "hocuspocus_tpu_compile_events_total" and dict(labels).get("kind") == "compile"
    }
    check(set(fresh) <= warm, f"{tag}: first launches off the warm grid: {sorted(set(fresh) - warm)}")
    check(sum(fresh.values()) == plane.compile_watch.fresh_compiles,
          f"{tag}: {sum(fresh.values())} first launches on /metrics, the watch counted "
          f"{plane.compile_watch.fresh_compiles}")
    check(scraped == _compile_series(), f"{tag}: /metrics shows other first-launch series")
    return series


def profile_tops(collapsed: str, roots=("MainThread", "flush_N")) -> dict:
    """Per thread label: its samples and its PROFILE_TOP heaviest
    collapsed stacks with their share of the thread's samples (the stack
    cut to its PROFILE_FRAMES leaf-side frames)."""
    by_root = collections.defaultdict(list)
    for line in collapsed.splitlines():
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        by_root[stack.split(";", 1)[0]].append((int(count), stack))
    out = {}
    for root in roots:
        rows = sorted(by_root.get(root, ()), reverse=True)
        total = sum(n for n, _stack in rows)
        out[root] = {
            "samples": total,
            "top": [
                {"share": round(n / total, 4), "samples": n,
                 "stack": ";".join(stack.split(";")[-PROFILE_FRAMES:])}
                for n, stack in rows[:PROFILE_TOP]
            ],
        }
    return out


async def _until_sampled(profiler, root: str = "flush_N", timeout: float = 5.0) -> None:
    """Hold a profile window open until the sampler has walked the
    threads with `root` among them: on a loaded host its 99 Hz thread
    waits for the interpreter lock and can miss a window of a few tenths
    of a second (the phase at a few docs on the CPU). On the card the
    windows last seconds and this returns at once."""
    deadline = time.perf_counter() + timeout
    while f"\n{root};" not in "\n" + profiler.collapsed() and time.perf_counter() < deadline:
        await asyncio.sleep(0.01)


def _gc2_share(seams, seconds: float) -> dict:
    """Gen-2 collections in a window, as HostSeams times them."""
    summary = seams.summary()
    total_ms = sum(v["total_ms"] for k, v in summary.items() if k.startswith("gc2."))
    n = sum(v["n"] for k, v in summary.items() if k.startswith("gc2."))
    return {"n": n, "seconds": total_ms / 1e3, "share": total_ms / 1e3 / seconds if seconds else None}


async def run_supervised_server(rng, arena, num_docs, capacity, clients, rounds,
                                evict_idle_secs, device=None, recorder=None, device_profile_secs=None,
                                durable=True, driven=None):
    """The JAX CLI's default deployment over one arena: the port's
    Hocuspocus core with SupervisedTpuMergeExtension(serve=True) at the
    CLI's defaults (SUPERVISOR_DEFAULTS, text lane and governor on, no
    `device`: the card) and eviction after `evict_idle_secs`, `clients`
    providers per doc on in-process sockets. Four steps: (1) wait for
    READY (the runtime factory builds the plane, g++ and nvcc under the
    init deadline); (2) the served rounds, as run_server's; (3) a quiet
    wait until every doc has evicted to a host snapshot; (4) one edit a
    doc, the catch-up storm: each cold doc's edit rides the CPU fan-out
    while its doc queues for hydration, then a wave of one fresh provider
    per doc. The kernel launch counts are set to 0 once READY and read
    after the join wave.

    The deployment is the JAX CLI's `--tpu-serve --metrics --wal-dir D`:
    the sampling profiler at 99 Hz, `Metrics` and `Durability` (a fresh
    WAL directory, group commit each tick) beside the plane. /metrics is
    scraped and held to the books at the quiet wait's end and after the
    join wave (_checked_scrape); at the quiet wait's end every doc's log
    must be its eviction checkpoint alone; after the phase a fresh
    WalManager replays every doc into an empty Doc, which must equal the
    served doc. `device_profile_secs` takes one /debug/profile capture of
    that many seconds at the quiet wait's end (_device_capture). The profiler's top stacks
    of the loop and flush threads are kept for the rounds and for the
    storm with its join wave, each beside its gen-2 share. `durable=False`
    leaves Durability out (the CLI without `--wal-dir`), to split the
    WAL's cost from the rest. `driven` docs (all `num_docs` when None)
    get the providers; the plane keeps `num_docs` rows. Returns (the
    extension, the phase's numbers)."""
    import contextlib

    from hocuspocus_tpu_torch.observability import Metrics, get_profiler
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.storage import REC_SNAPSHOT, Durability
    from hocuspocus_tpu_torch.tpu import SupervisedTpuMergeExtension
    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane
    from hocuspocus_tpu_torch.tpu.supervisor import STATE_INITIALIZING, STATE_READY

    tag = ARENAS[arena]["tag"] + "supervised_server"
    reset_device_lane()
    seams = HostSeams()
    asyncio.get_running_loop().set_default_executor(_TimedExecutor(seams))
    started = time.perf_counter()
    ext = SupervisedTpuMergeExtension(
        num_docs=num_docs, capacity=capacity, serve=True, arena=arena,
        evict_idle_secs=evict_idle_secs, **SUPERVISOR_DEFAULTS,
        **({} if device is None else {"device": device}),
    )
    canaries = []
    ext.supervisor.on_canary.append(canaries.append)
    profiler = get_profiler().configure(hz=PROFILE_HZ)
    metrics = Metrics(**METRICS_DEFAULTS)
    extensions = [metrics, ext]
    if durable:
        wal_dir = tempfile.mkdtemp(prefix="chip-smoke-wal-")
        durability = Durability(wal_dir=wal_dir, fsync=WAL_FSYNC)
        extensions.insert(1, durability)
    compiles0 = _compile_series()
    core = Hocuspocus(Configuration(quiet=True, extensions=extensions))
    await core.ensure_configured()
    await core.hooks("on_listen", Payload(instance=core, configuration=core.configuration, port=None))
    # (1) READY: anything else (init overdue, a failed init) fails the run
    deadline = time.perf_counter() + 120
    while ext.supervisor.state != STATE_READY:
        check(
            ext.supervisor.state == STATE_INITIALIZING,
            f"{tag}: the supervisor is {ext.supervisor.state}: {ext.health_status()}",
        )
        check(time.perf_counter() < deadline, f"{tag}: the plane never attached")
        await asyncio.sleep(0.02)
    runtime = ext.runtime
    await runtime.warmup_task
    check(runtime.plane.compile_watch.warmed, f"{tag}: the warm grid did not finish")
    ready_seconds = time.perf_counter() - started
    plane, manager = runtime.plane, runtime.residency
    grid = plane.warmup_shapes() + plane.warmup_aux_shapes()
    check(manager is not None and runtime.native_lane, f"{tag}: residency or the lane is off")
    # a sync answered by the CPU document is a fallback (`cpu_fallbacks`);
    # one whose doc was evicted while the request waited, or waits in the
    # hydration queue, is eviction's, any other is the plane's
    from hocuspocus_tpu_torch.tpu.serving import TpuSyncSource

    fallbacks = {"evicted": 0, "other": []}
    real_counted = TpuSyncSource._counted

    def counted(source, payload):
        if payload is None:
            if manager.is_evicted(source.name) or source.name in manager._queued:
                fallbacks["evicted"] += 1
            else:
                fallbacks["other"].append(source.name)
        return real_counted(source, payload)

    TpuSyncSource._counted = counted
    dense_name, sparse_name = ARENAS[arena]["wrap"]
    dense_fn, sparse_fn = getattr(ti, dense_name), getattr(ti, sparse_name)
    dense_fn.launches = sparse_fn.launches = 0

    cycles, hydration_rounds = [], []
    real_flush = plane.flush
    real_publish = manager._publish_stats

    def publish(**extra):
        # the hydration drain publishes each round's batch size once
        if "last_hydration_batch" in extra:
            hydration_rounds.append((extra["last_hydration_batch"], time.perf_counter()))
        return real_publish(**extra)

    manager._publish_stats = publish

    def timed_flush(max_batches=None):
        inflight = manager.inflight
        t0 = time.perf_counter()
        count = real_flush(max_batches)
        wall = time.perf_counter() - t0
        if count and not inflight:
            cycles.append(wall)
        if recorder is not None:
            recorder.after_flush(plane.state)
        return count

    plane.flush = timed_flush
    names = [f"doc-{i}" for i in range(num_docs if driven is None else driven)]
    groups = []
    for name in names:
        group = []
        for _client in range(clients):
            provider = HocuspocusProvider(name=name, websocket_provider=InProcessProviderSocket(core))
            provider.attach()
            group.append(provider)
        groups.append(group)
    everyone = [p for group in groups for p in group]
    await asyncio.wait_for(_all_synced(everyone), 600)
    setup_seconds = time.perf_counter() - started

    # (2) the served rounds
    clock = EditClock(asyncio.Event())
    for group in groups:
        clock.watch(group[0])
        clock.watch(group[1])
    if recorder is not None:
        recorder.before = clone_state(plane.state)
    recording = recorder if recorder is not None else contextlib.nullcontext()
    counters0 = dict(plane.counters)
    sent = 0
    capture = None
    profiles = {}
    with recording:
        profiler.reset()
        seams.reset()
        gc.callbacks.append(seams.collected)
        traffic_started = time.perf_counter()
        for _round in range(rounds):
            for d, group in enumerate(groups):
                for j, provider in enumerate(group):
                    if _server_edit(rng, provider.document.get_text("t")):
                        sent += 1
                        clock.expect(group[1] if j == 0 else group[0], provider)
                if d % 16 == 15:
                    await asyncio.sleep(0)
            await asyncio.wait_for(clock.idle.wait(), 300)
            await _converge(
                [(p, core.documents[p.name]) for p in everyone],
                time.perf_counter() + 120, tag,
            )
        traffic_seconds = time.perf_counter() - traffic_started
        gc.callbacks.remove(seams.collected)
        await _until_sampled(profiler)
        profiles["traffic"] = {
            **profile_tops(profiler.collapsed()),
            "gc2": _gc2_share(seams, traffic_seconds),
            "seconds": round(traffic_seconds, 3),
        }
        traffic_samples = len(clock.samples)
        traffic_counters = {
            key: plane.counters[key] - counters0[key]
            for key in ("docs_evicted", "docs_hydrated", "docs_compacted", "plane_broadcasts")
        }

        # (3) quiet: every doc evicts (16 a maintenance tick, the JAX
        # package's evict_batch), the CPU documents serve meanwhile
        quiet_started = time.perf_counter()
        deadline = quiet_started + evict_idle_secs + 4 * len(names) / manager.evict_batch * manager.maintenance_interval + 60
        while any(runtime.is_served(name) for name in names):
            check(ext.supervisor.state == STATE_READY, f"{tag}: {_books(ext)}")
            check(time.perf_counter() < deadline, f"{tag}: {sum(map(runtime.is_served, names))} docs never evicted")
            await asyncio.sleep(0.05)
        quiet_seconds = time.perf_counter() - quiet_started
        evicted = sum(manager.is_evicted(name) for name in names)
        check(evicted == len(names), f"{tag}: {evicted} of {len(names)} docs evicted: {_books(ext)}")
        check(not any(name in plane.docs for name in names), f"{tag}: an evicted doc kept its rows")
        # every doc's log is its eviction checkpoint alone (the snapshot
        # subsumes the history), and /metrics agrees with the books
        checkpoints = None
        if durable:
            await durability.wal.flush()
            checkpoints = 0
            for name in names:
                records, report = await durability.wal.replay(name)
                check(len(records) == 1 and records[0][0] == REC_SNAPSHOT and not report["torn_tail_records"],
                      f"{tag}: {name}'s log is {[r for r, _p in records]} after its eviction, not one checkpoint")
                checkpoints += 1
        quiet_scrape = await _checked_scrape(
            tag, metrics, plane, ext.supervisor, sent if durable else None, grid, compiles0
        )
        if device_profile_secs:
            capture = await _device_capture(
                tag, metrics, plane, device_profile_secs, (dense_fn, sparse_fn), ARENAS[arena]["kernels"]
            )

        # (4) the catch-up storm: one edit a doc, observed on the CPU fan-out.
        # Every doc must come back on the plane and the lane with served
        # bytes rebuilding it; each is checked the moment it is seen served
        # (synchronously, so no eviction can come between), or, if it idles
        # out again first, just before it evicts
        pending = set(names)
        early_failures = []
        real_evict = manager.evict

        async def checked_evict(name, document):
            if name in pending and runtime.is_served(name):
                try:
                    _check_served(tag, core, plane, name)
                except SmokeFailure as failure:
                    early_failures.append(str(failure))
                pending.discard(name)
            return await real_evict(name, document)

        manager.evict = checked_evict
        hydrated0 = plane.counters["docs_hydrated"]
        storm_rounds0 = len(hydration_rounds)
        profiler.reset()
        seams.reset()
        gc.callbacks.append(seams.collected)
        storm_started = time.perf_counter()
        for d, group in enumerate(groups):
            text = group[0].document.get_text("t")
            text.insert(int(rng.integers(0, len(text) + 1)), WORDS[rng.integers(0, len(WORDS))])
            sent += 1
            clock.expect(group[1], group[0])
            if d % 16 == 15:
                await asyncio.sleep(0)
        await asyncio.wait_for(clock.idle.wait(), 300)
        storm_samples = clock.samples[traffic_samples:]
        deadline = time.perf_counter() + 120
        while pending:
            check(not early_failures, early_failures[:1])
            check(ext.supervisor.state == STATE_READY, f"{tag}: {_books(ext)}")
            check(time.perf_counter() < deadline, f"{tag}: {len(pending)} docs not hydrated: {_books(ext)}")
            back = [name for name in pending if runtime.is_served(name)]
            for name in back:
                _check_served(tag, core, plane, name)
            pending.difference_update(back)
            await asyncio.sleep(0.005)
        check(not early_failures, early_failures[:1])
        manager.evict = real_evict
        hydrate_seconds = time.perf_counter() - storm_started
        storm_rounds = [n for n, _t in hydration_rounds[storm_rounds0:]]
        hydrated = plane.counters["docs_hydrated"] - hydrated0
        joins, joiners = await _join_waves(core, names, plane, waves=1)
        storm_seconds = time.perf_counter() - storm_started
        gc.callbacks.remove(seams.collected)
        await _until_sampled(profiler)
        status, body = await scrape(metrics, "/debug/profile/cpu")
        check(status == 200, f"{tag}: /debug/profile/cpu answered {status}")
        cpu_profile = json.loads(body)
        check(cpu_profile["stats"]["samples"] > 0, f"{tag}: the sampling profiler took no sample")
        profiles["storm_and_joins"] = {
            **profile_tops(cpu_profile["collapsed"]),
            "gc2": _gc2_share(seams, storm_seconds),
            "seconds": round(storm_seconds, 3),
        }
        join_scrape = await _checked_scrape(
            tag, metrics, plane, ext.supervisor, sent if durable else None, grid, compiles0
        )
    launches = {dense_name: dense_fn.launches, sparse_name: sparse_fn.launches}
    await _converge(
        [(p, core.documents[p.name]) for p in everyone + joiners],
        time.perf_counter() + 120, tag,
    )
    health = ext.health_status()
    counters = dict(plane.counters)
    supervisor = {
        "state": ext.supervisor.state,
        "counters": dict(ext.supervisor.counters),
        "breaker_transitions": dict(ext.supervisor.breaker.transitions),
        "transitions": dict(ext.supervisor.transitions),
        "init_seconds": ext.supervisor.init_elapsed,
    }
    TpuSyncSource._counted = real_counted
    # one canary launch held against the plain version (not counted)
    canary_err = _canary_vs_plain(plane, arena, dense_name, sparse_name)
    served = {name: _fingerprint(core.documents[name]) for name in names}
    acked_dir = None
    if durable:
        # every served edit was shown to a peer, and a broadcast waits for
        # its group commit: once no commit is pending or running, the log
        # as a crash now would leave it must rebuild every doc (replayed
        # below, once the deployment no longer holds the loop)
        acked_dir, acked_wait = await _copy_acked_wal(tag, durability.wal, wal_dir)
    for p in everyone + joiners:
        p.destroy()
        p.websocket_provider.destroy()
    # the teardown as the CLI's own ends it when its drain is skipped:
    # on_destroy, whose WAL flush is bounded at 5 s
    await core.hooks("on_destroy", Payload(instance=core))
    # the sampler lives as long as the deployment: later phases run without it
    profiler.stop()
    # a fresh WalManager over the same directory rebuilds every doc
    wal = wal_acked = None
    if durable:
        wal = await _replay_wal(tag, wal_dir, served)
        shutil.rmtree(wal_dir, ignore_errors=True)
        wal_acked = await _replay_wal(f"{tag} (before the teardown)", acked_dir, served)
        wal_acked["idle_wait_s"] = acked_wait
        shutil.rmtree(acked_dir, ignore_errors=True)
    return ext, {
        "init_seconds": supervisor["init_seconds"],
        "ready_seconds": round(ready_seconds, 3),
        "setup_seconds": round(setup_seconds, 3),
        "traffic_seconds": round(traffic_seconds, 3),
        "seconds": round(time.perf_counter() - started, 3),
        "edit_observe": percentiles_ms(clock.samples[:traffic_samples]),
        "traffic_residency": traffic_counters,
        "flush_cycles": percentiles_ms(cycles),
        "quiet_seconds": round(quiet_seconds, 3),
        "evicted": evicted,
        "storm_edit_observe": percentiles_ms(storm_samples),
        "storm_hydrated": hydrated,
        "storm_hydrate_seconds": round(hydrate_seconds, 3),
        "storm_rounds": len(storm_rounds),
        "storm_round_docs": storm_rounds,
        "join_wave": joins[0],
        "canaries": len(canaries),
        "canary_latency": {
            **percentiles_ms(canaries),
            "max_ms": float(max(canaries) * 1e3) if canaries else None,
        },
        "canary_max_abs_err": canary_err,
        "integrate_launches": launches,
        "residency_stats": dict(plane.residency_stats),
        "memory_stats": plane.memory_stats(),
        "health_degraded": health["degraded"],
        "cpu_fallbacks_by_cause": {"evicted": fallbacks["evicted"], "other": len(fallbacks["other"])},
        "cpu_fallback_docs_other": fallbacks["other"][:8],
        "supervisor": supervisor,
        "edits_sent": sent,
        "wal_checkpoints": checkpoints,
        "wal_acked": wal_acked,
        "wal": wal,
        "wal_stats": durability.wal_stats() if durable else None,
        "scrapes": {
            "quiet": {
                "series": len(quiet_scrape),
                "wal_appended_records": quiet_scrape.get(("hocuspocus_wal_appended_records", ())),
            },
            "joins": {
                "series": len(join_scrape),
                "wal_appended_records": join_scrape.get(("hocuspocus_wal_appended_records", ())),
            },
        },
        "profiles": profiles,
        "profiler_stats": cpu_profile["stats"],
        "device_profile": None if capture is None else {
            "seconds": capture["seconds"],
            "activities": capture["activities"],
            "device_events": capture["device_events"],
            "attempts": capture["attempts"],
            "kernels": capture["kernels"],
        },
        "counters": counters,
    }


def _trace_file_names(artifact, names) -> bool:
    """Whether the Chrome trace a capture wrote holds a kernel event
    (category "kernel") named by one of `names`."""
    try:
        with open(artifact) as f:
            events = json.load(f).get("traceEvents", [])
    except (OSError, ValueError):
        return False
    return any(
        event.get("cat") == "kernel" and any(name in str(event.get("name", "")) for name in names)
        for event in events
    )


async def _device_capture(tag, metrics, plane, secs, dispatchers, names) -> dict:
    """`/debug/profile?secs=` captures while the plane is quiet, each with
    one canary probe, taken as the supervisor's watchdog takes it (the
    flush lock, the loop's executor): a K1/K2 launch the trace must name.
    The window opens when the profiler reports itself on, which can be
    seconds after the request (the first start sets up the tracer), and
    the probe is taken a quarter of the window later: the host-side flag
    can come on before the device tracer does, and under the phase's load
    the flush lock and the executor have held a probe back for tenths of
    a second, so a later probe could end after the window, where it
    cannot be in its trace. Each attempt records its device events,
    whether the answer's kernels and the Chrome trace file name a kernel
    of `names`, the probe's launches as its wrapper counted them, and
    when the probe began and ended, in seconds after the window opened.
    On the card the probe must launch its kernel. An attempt is taken
    again, up to DEVICE_PROFILE_ATTEMPTS times, where its trace holds no
    device event at all, its probe ended outside the window, or its
    wrapper launched the kernel and the trace holds the probe's readback
    but no record of the kernel (a lost record: the full smoke has shown
    it about once in three runs, a quiet plane never); the last attempt
    must name a kernel of `names`. The probes' launches are the
    captures', not the deployment's: the dispatchers' counts are put
    back. Returns the last capture's answer with every attempt (on the
    CPU: one capture, host ops only)."""
    import torch

    def profiling() -> bool:
        return getattr(torch.autograd.profiler, "_is_profiler_enabled", True)

    attempts = []
    on_card = plane.device.type == "cuda"
    for _attempt in range(DEVICE_PROFILE_ATTEMPTS):
        counts = [fn.launches for fn in dispatchers]
        capture = asyncio.ensure_future(scrape(metrics, "/debug/profile", secs=str(secs)))
        await asyncio.sleep(0)  # the capture's first step starts the profiler
        while not profiling() and not capture.done():
            await asyncio.sleep(0)
        opened = time.perf_counter()
        await asyncio.sleep(secs / 4)
        async with plane.flush_lock:
            probe_began_s = time.perf_counter() - opened
            await asyncio.get_running_loop().run_in_executor(None, plane.canary_probe)
            probe_ended_s = time.perf_counter() - opened
        launched = sum(fn.launches for fn in dispatchers) - sum(counts)
        for fn, count in zip(dispatchers, counts):
            fn.launches = count
        status, body = await capture
        check(status == 200, f"{tag}: /debug/profile answered {status}: {body[:300]}")
        payload = json.loads(body)
        check("error" not in payload, f"{tag}: /debug/profile: {payload.get('error')}")
        named = any(name in k for k in payload["kernels"] for name in names)
        attempts.append({"device_events": payload["device_events"], "names_kernel": named,
                         "trace_file_names_kernel": _trace_file_names(payload["artifact"], names),
                         "probe_launches": launched,
                         "probe_s": [round(probe_began_s, 4), round(probe_ended_s, 4)]})
        if not on_card:
            break
        check(launched >= 1, f"{tag}: the capture's canary probe launched no kernel: {attempts}")
        if payload["device_events"] and probe_ended_s < secs and named:
            break
    if on_card:
        check(attempts[-1]["names_kernel"],
              f"{tag}: the torch.profiler capture names no kernel of {names}: "
              f"{payload['kernels'][:20]} (attempts: {attempts})")
    return {**payload, "attempts": attempts}


def _fingerprint(document) -> tuple:
    """A doc's text and state vector."""
    from hocuspocus_tpu_torch.crdt import encode_state_vector

    return document.get_text("t").to_string(), encode_state_vector(document)


async def _replay_wal(tag, wal_dir, served) -> dict:
    """A fresh WalManager over `wal_dir` replays each doc's log into an
    empty Doc, which must equal `served[name]`. Returns the replay's
    seconds, records and the bytes on disk."""
    from hocuspocus_tpu_torch.crdt import Doc, apply_update
    from hocuspocus_tpu_torch.storage import WalManager

    on_disk = sum(
        os.path.getsize(os.path.join(root, name))
        for root, _dirs, files in os.walk(wal_dir) for name in files
    )
    wal = WalManager(wal_dir, fsync=WAL_FSYNC)
    t0 = time.perf_counter()
    records = 0
    for name, fingerprint in served.items():
        doc = Doc()
        replayed, report = await wal.replay(name)
        check(not report["torn_tail_records"] and not report["corrupt_records"],
              f"{tag}: {name}'s log replays with damage: {report}")
        for _rec_type, payload in replayed:
            apply_update(doc, payload)
        records += len(replayed)
        got = _fingerprint(doc)
        check(got == fingerprint,
              f"{tag}: {name}: the WAL replays another doc: {len(replayed)} records, text "
              f"{len(got[0])} against {len(fingerprint[0])} units, state vector "
              f"{got[1].hex()} against {fingerprint[1].hex()}")
    seconds = time.perf_counter() - t0
    wal.close()
    return {"docs": len(served), "records": records, "seconds": round(seconds, 3), "bytes_on_disk": on_disk}


async def _copy_acked_wal(tag, wal, wal_dir, timeout=60.0) -> tuple:
    """The log as a crash would leave it while the deployment still runs:
    once `wal` has no commit pending or running (waited for, not forced),
    its directory is copied in one step of the loop, so no commit can
    start meanwhile. Returns (the copy's path, the seconds waited)."""
    started = time.perf_counter()
    while wal._pending or (wal._flush_task is not None and not wal._flush_task.done()):
        check(time.perf_counter() - started < timeout,
              f"{tag}: the WAL kept a commit pending or running for {timeout} s")
        await asyncio.sleep(0.01)
    waited = round(time.perf_counter() - started, 3)
    copy = wal_dir.rstrip(os.sep) + "-acked"
    shutil.copytree(wal_dir, copy)
    return copy, waited


def _check_served(tag, core, plane, name) -> None:
    """`name` is on the plane and the lane, and the bytes its sync source
    serves for an empty state vector rebuild its server document."""
    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_vector

    doc = plane.docs.get(name)
    check(doc is not None and doc.lane_slot is not None and not doc.retired,
          f"{tag}: {name} is not back on the lane")
    document = core.documents[name]
    served = document.sync_source.encode_state_as_update(None)
    check(served is not None, f"{tag}: {name} was not served from the plane")
    rebuilt = Doc()
    apply_update(rebuilt, served)
    check(rebuilt.get_text("t").to_string() == document.get_text("t").to_string(),
          f"{tag}: {name}: served bytes rebuild another text")
    check(encode_state_vector(rebuilt) == encode_state_vector(document),
          f"{tag}: {name}: served bytes rebuild another state vector")


def _books(ext) -> str:
    """The supervised phase's books, for a failure's message."""
    plane = ext.plane
    keys = ("docs_evicted", "docs_hydrated", "hydrations_declined", "cpu_fallbacks",
            "docs_compacted", "compactions_declined")
    return json.dumps({
        "supervisor": ext.health_status(),
        "plane": None if plane is None else {k: plane.counters[k] for k in keys},
        "retired": None if plane is None else {
            k: v for k, v in plane.counters.items() if k.startswith("docs_retired_") and v
        },
        "lane": None if ext.runtime is None else ext.runtime.lane.snapshot()["counters"],
    })


def _canary_vs_plain(plane, arena, dense_name, sparse_name) -> int:
    """The canary's launch, the sparse dispatcher at (K_max, 1) with one
    padding column, on a copy of the arena, against the plain version on
    another copy: the max abs difference over the arena (0 when equal)."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk
    from hocuspocus_tpu_torch.tpu import kernels_rle as tr

    k_max = plane._k_buckets()[-1]
    plain = tr.integrate_op_slots_rle_sparse if arena == "rle" else tk.integrate_op_slots_sparse
    dispatcher = getattr(ti, sparse_name)
    launches = dispatcher.launches
    with plane._step_lock, plane.device_scope():
        kernel, reference = clone_state(plane.state), clone_state(plane.state)
        dispatcher(kernel, plane._noop_ops(k_max, 1), plane._padding_slots(1))
        plain(reference, plane._noop_ops(k_max, 1), plane._padding_slots(1))
        if plane.device.type == "cuda":
            torch.cuda.synchronize()
    dispatcher.launches = launches  # a comparison launch, not the path's
    return max_abs_err(kernel, reference)


def phase_supervised_server(rng, arena, num_docs, capacity, clients, rounds, evict_idle_secs, cuts,
                            driven=None, device_profile=True):
    """The supervised served path on the card (run_supervised_server),
    with the checks that hold it: READY, every doc evicted then back on
    the plane and the lane, the served bytes rebuild each doc, no CPU
    fallback and no retired doc, no breaker trip, at least one canary,
    `health_status()["degraded"]` false, and the arena's kernel launched.
    Then the path's biggest integrate batch is replayed through the
    kernel and the plain version. Returns (launches, max_abs_err over
    the replay and the canary)."""
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    tag = ARENAS[arena]["tag"] + "supervised_server"
    recorder = Recorder(mp, *ARENAS[arena]["wrap"])
    profile_secs = DEVICE_PROFILE_SECS if device_profile and arena == DEVICE_PROFILE_ARENA else None
    _ext, out = asyncio.run(
        run_supervised_server(rng, arena, num_docs, capacity, clients, rounds,
                              evict_idle_secs, recorder=recorder, device_profile_secs=profile_secs,
                              driven=driven)
    )
    driven = num_docs if driven is None else driven
    counters = out["counters"]
    supervisor = out["supervisor"]
    retired = {k: v for k, v in counters.items() if k.startswith("docs_retired_")}
    launches = sum(out["integrate_launches"].values())
    # the sampling profiler's split of the loop and flush threads
    emit(f"{tag}_profile", gpu=nvidia_smi_line(), hz=PROFILE_HZ, stats=out["profiler_stats"],
         **out["profiles"])
    emit(
        tag,
        gpu=nvidia_smi_line(),
        config="BASELINE config 2: 1k Y.Text docs, 10 clients each, random-position insert/delete",
        deployment={**SUPERVISOR_DEFAULTS, "evict_idle_secs": evict_idle_secs,
                    "native_lane": True, "governor": True},
        arena=arena,
        docs=num_docs,
        driven=driven,
        capacity=capacity,
        clients=clients,
        rounds=rounds,
        cuts=cuts,
        docs_retired=retired,
        **{k: v for k, v in out.items() if k not in ("counters", "profiles")},
        cpu_fallbacks=counters["cpu_fallbacks"],
        docs_evicted=counters["docs_evicted"],
        docs_hydrated=counters["docs_hydrated"],
        hydrations_declined=counters["hydrations_declined"],
        sync_serves=counters["sync_serves"],
    )
    check(supervisor["state"] == "ready", f"{tag}: the supervisor ended {supervisor['state']}")
    check(out["cpu_fallbacks_by_cause"]["other"] == 0,
          f"{tag}: CPU fallbacks outside eviction: {out['cpu_fallback_docs_other']}")
    check(not any(retired.values()), f"{tag}: docs retired {retired}")
    check(supervisor["counters"]["degrades"] == 0 and not supervisor["breaker_transitions"],
          f"{tag}: the breaker tripped: {supervisor}")
    check(supervisor["counters"]["canary_probes"] >= 1 and out["canaries"] >= 1,
          f"{tag}: no canary ran: {supervisor}")
    # a canary that raised is a card fault (the supervisor stops serving on
    # it); the failures left are overruns of the deadline, which the
    # breaker counts and which are printed
    check(supervisor["counters"]["canary_errors"] == 0 and supervisor["counters"]["card_faults"] == 0,
          f"{tag}: a canary raised: {supervisor}")
    check(not out["health_degraded"], f"{tag}: health_status() reports degraded")
    check(out["evicted"] == driven, f"{tag}: {out['evicted']} evictions")
    check(out["storm_hydrated"] >= driven, f"{tag}: {out['storm_hydrated']} hydrations in the storm")
    check(launches > 0, f"{tag}: the integrate kernel never launched from the supervised path")
    check(out["canary_max_abs_err"] == 0, f"{tag}: the canary's launch differs from the plain version")
    check(out["wal_checkpoints"] == driven and out["wal"]["docs"] == driven
          and out["wal_acked"]["docs"] == driven,
          f"{tag}: {out['wal_checkpoints']} checkpoints, {out['wal']['docs']} docs replayed after "
          f"the teardown, {out['wal_acked']['docs']} before it")
    err = phase_served_replay(recorder.best, arena, path="supervised_server")
    recorder.best = recorder.before = None
    return launches, max(err, out["canary_max_abs_err"])


def phase_supervised_full(seed, started):
    """The unit supervised phase as it ran before its cut, all
    SUPERVISED_FULL_DRIVEN docs driven (10 providers each), in a child
    process (`chip_smoke.py --supervised-docs N`) so that what it leaves
    behind when it fails cannot touch the card's other phases. Reported,
    never gated: on a slow host 10,240 providers in one interpreter have
    starved the supervisor's canary until the breaker opened. It runs
    only where the smoke's budget (SMOKE_CLOCK_S) has
    SUPERVISED_FULL_MIN_S left, and is cut at what is left; its line
    says whether it ran, how it ended and, from the child's own line,
    the numbers that tell the two faults apart (canary latencies, the
    breaker, the WAL before and after the teardown)."""
    import torch

    left = SMOKE_CLOCK_S - (time.perf_counter() - started)
    if left < SUPERVISED_FULL_MIN_S:
        emit("supervised_server_full", ran=False, driven=SUPERVISED_FULL_DRIVEN,
             reason=f"{left:.1f} s of the smoke's {SMOKE_CLOCK_S:.0f} s left, "
                    f"{SUPERVISED_FULL_MIN_S:.0f} s needed")
        return
    torch.cuda.empty_cache()  # the earlier phases' arenas, before another process takes the card
    t0 = time.perf_counter()
    command = [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
               "--supervised-docs", str(SUPERVISED_FULL_DRIVEN)]
    try:
        proc = subprocess.run(command, cwd=ROOT, capture_output=True, text=True, timeout=left - 20)
        exit_code, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as expired:
        exit_code = None
        stdout = (expired.stdout or b"").decode() if isinstance(expired.stdout, bytes) else (expired.stdout or "")
        stderr = f"cut at {left - 20:.1f} s"
    line = next((json.loads(raw.split(": ", 1)[1]) for raw in stdout.splitlines()
                 if raw.startswith("supervised_server: ")), None)
    failure = next((raw for raw in stderr.splitlines() if raw.startswith("chip_smoke: FAILED")),
                   None if exit_code == 0 else stderr[-2000:])
    keys = ("seconds", "setup_seconds", "traffic_seconds", "edit_observe", "flush_cycles",
            "quiet_seconds", "evicted", "storm_hydrated", "join_wave", "canaries",
            "canary_latency", "supervisor", "cpu_fallbacks_by_cause", "docs_retired",
            "health_degraded", "wal_checkpoints", "wal_acked", "wal", "integrate_launches")
    emit("supervised_server_full", ran=True, driven=SUPERVISED_FULL_DRIVEN, exit_code=exit_code,
         ok=exit_code == 0, failure=None if failure is None else failure[:2000],
         seconds=round(time.perf_counter() - t0, 3),
         line=None if line is None else {k: line.get(k) for k in keys})


# -- Redis fan-out between two served planes (BASELINE config 4) ---------------

CLUSTER_PROVIDERS = 2  # providers of a doc on each instance
CLUSTER_DOCS = 256
CLUSTER_ROUNDS = 1
CLUSTER_CUTS = {
    "docs": "100k docs cut to 256 (to 1,024 before the CLI and loadgen phases, to 512 before "
            "the edge phase, which carries a Redis bus at 1,024 docs)",
    "rounds": "1 round (2 before the CLI and loadgen phases)",
    "rate": "50 ops/s/doc cut to one edit per provider per round: one host thread "
            "runs both servers and all their clients",
}
CLUSTER_MAP_KEYS = 7
# a config 4 doc holds two sequences, its Y.Text and its Y.Array, and each
# takes an arena row once the doc leaves the text lane (Map items stay on
# the host): the plane has four rows per doc, as the JAX package's config 4
# bench sizes it (benchmarks/config4_redis_fanout.py `num_docs * 4`)
CLUSTER_ROWS_PER_DOC = 4
# mini-redis's bounded queue per subscriber, in frames: a real Redis
# drops a pub/sub client past its default output buffer hard limit of
# 32 MB (`client-output-buffer-limit pubsub 32mb 8mb 60`), 65,536 frames
# of 512 bytes; mini-redis's own default (1,024) drops an instance's
# subscriber while its loop thread runs 4,096 clients
CLUSTER_SUBSCRIBER_QUEUE = 65536


def _cluster_edit(rng, doc) -> str:
    """BASELINE config 4's mix (benchmarks/config4_redis_fanout.py): a
    third each a Y.Text insert, a Y.Map LWW set over 7 keys and a Y.Array
    push, the kind and the values drawn from `rng`."""
    kind = int(rng.integers(0, 3))
    if kind == 0:
        text = doc.get_text("t")
        text.insert(int(rng.integers(0, len(text) + 1)), "z")
        return "text"
    if kind == 1:
        doc.get_map("meta").set(f"k{int(rng.integers(0, CLUSTER_MAP_KEYS))}", int(rng.integers(0, 1 << 20)))
        return "map"
    doc.get_array("events").push([int(rng.integers(0, 1 << 20))])
    return "array"


def _mixed_state(doc) -> tuple:
    return (
        doc.get_text("t").to_string(),
        doc.get_map("meta").to_json(),
        doc.get_array("events").to_json(),
    )


async def _converge_mixed(pairs, deadline: float, what: str) -> None:
    """Wait until every (provider doc, server doc) pair holds one state."""
    left = list(pairs)
    while left:
        left = [(a, b) for a, b in left if _mixed_state(a) != _mixed_state(b)]
        if not left:
            return
        check(time.perf_counter() < deadline, f"{what}: {len(left)} docs never converged")
        await asyncio.sleep(0.02)


async def run_cluster_server(rng, num_docs, capacity, providers=CLUSTER_PROVIDERS,
                             rounds=CLUSTER_ROUNDS, device="cuda", recorder=None):
    """BASELINE config 4's production topology (tests/extensions/
    test_redis.py's serve-mode test, benchmarks/config4_redis_fanout.py):
    the port's MiniRedis on loopback and two port Hocuspocus cores `a` and
    `b`, each with `Redis(port=..., identifier=...)` and
    `TpuMergeExtension(serve=True)` at its other defaults on `device`
    (two planes on one card, one device lane), `providers` providers of
    every doc on each instance, each on an in-process socket of its own.

    Settle: the docs load on `a` first and take one Map write each, which
    demotes each doc off the text lane; once every doc is capturing on
    `a` again (the rebuild landed) the providers of `b` join, `b` loads
    each doc from `a` through Redis, demotes and rebuilds it the same
    way, and the phase waits until every doc is capturing on both. Then
    `rounds` rounds of one config 4 edit per provider (_cluster_edit),
    each edit timed to a provider on the other instance and to one on its
    own; then a wave of one late joiner per doc on `b`, synced from `b`'s
    plane. The kernel launch counts are set to 0 after the settle and
    read after the join wave (no torch.profiler capture: over the rounds'
    ~4,000 flush cycles of small launches its trace processing takes
    minutes). `recorder` keeps `b`'s
    biggest integrate batch. Returns the phase's numbers."""
    import contextlib

    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_vector
    from hocuspocus_tpu_torch.extensions import Redis
    from hocuspocus_tpu_torch.net.mini_redis import MiniRedis
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
    redis = await MiniRedis(subscriber_queue_limit=CLUSTER_SUBSCRIBER_QUEUE).start()
    sides = ("a", "b")
    exts = {
        side: TpuMergeExtension(
            num_docs=CLUSTER_ROWS_PER_DOC * num_docs, capacity=capacity, serve=True, device=device
        )
        for side in sides
    }
    redises = {side: Redis(port=redis.port, identifier=f"cluster-{side}") for side in sides}
    cores = {
        side: Hocuspocus(Configuration(quiet=True, extensions=[redises[side], exts[side]]))
        for side in sides
    }
    for side in sides:
        await cores[side].ensure_configured()
        await cores[side].hooks(
            "on_listen", Payload(instance=cores[side], configuration=cores[side].configuration, port=None)
        )
    for side in sides:
        await exts[side].warmup_task
        check(exts[side].plane.compile_watch.warmed, f"cluster_server: {side}'s warm grid did not finish")
    warm_seconds = time.perf_counter() - started

    recording_flush = threading.local()
    if recorder is not None:
        recorder.gate = lambda: getattr(recording_flush, "on", False)
    cycles = {side: [] for side in sides}
    flush_wall, flush_cpu = seams.samples["flush_wall"], seams.samples["flush_cpu"]
    for side in sides:
        plane = exts[side].plane
        real_flush = plane.flush

        def timed_flush(max_batches=None, real_flush=real_flush, side=side, plane=plane):
            recording_flush.on = side == "b"
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                count = real_flush(max_batches)
            finally:
                recording_flush.on = False
            wall = time.perf_counter() - t0
            flush_wall.append(wall)
            flush_cpu.append(time.thread_time() - c0)
            if count:
                cycles[side].append(wall)
            if recorder is not None and side == "b":
                recorder.after_flush(plane.state)
            return count

        plane.flush = timed_flush
    anti_entropy = {side: collections.Counter() for side in sides}
    for side in sides:
        publish = redises[side].publish_first_sync_step

        async def counted(name, document, publish=publish, side=side):
            anti_entropy[side][name] += 1
            await publish(name, document)

        redises[side].publish_first_sync_step = counted

    names = [f"mix-{i}" for i in range(num_docs)]

    def connect(side):
        groups = []
        for name in names:
            group = []
            for _ in range(providers):
                provider = HocuspocusProvider(
                    name=name, websocket_provider=InProcessProviderSocket(cores[side])
                )
                provider.attach()
                group.append(provider)
            groups.append(group)
        return groups

    def capturing(side):
        return sum(exts[side].is_capturing(name) for name in names)

    async def until_capturing(side_list, what):
        deadline = time.perf_counter() + 300
        while any(capturing(side) < num_docs for side in side_list):
            check(time.perf_counter() < deadline,
                  f"cluster_server: {what}: capturing {[capturing(s) for s in side_list]} of {num_docs}")
            await asyncio.sleep(0.02)

    groups_a = connect("a")
    await asyncio.wait_for(_all_synced([p for g in groups_a for p in g]), 600)
    for d, group in enumerate(groups_a):
        group[0].document.get_map("meta").set("settle", d)
        if d % 16 == 15:
            await asyncio.sleep(0)
    await until_capturing(["a"], "settle on a")
    groups_b = connect("b")
    everyone = [p for g in groups_a + groups_b for p in g]
    await asyncio.wait_for(_all_synced(everyone), 600)
    # b loaded each doc's Map item from a as a remote update, which the
    # text lane keeps: its own first Map write demotes it
    for d, group in enumerate(groups_b):
        group[0].document.get_map("meta").set("settle-b", d)
        if d % 16 == 15:
            await asyncio.sleep(0)
    await _converge_mixed(
        [(p.document, cores[side].documents[p.name]) for side, gs in (("a", groups_a), ("b", groups_b))
         for g in gs for p in g],
        time.perf_counter() + 300, "cluster_server settle",
    )
    await until_capturing(sides, "settle on both")
    setup_seconds = time.perf_counter() - started
    settle_counters = {side: dict(exts[side].plane.counters) for side in sides}
    settle_lane_docs = {
        side: sum(exts[side].plane.docs[name].lane_slot is not None for name in names)
        for side in sides
    }
    check(not any(settle_lane_docs.values()), f"cluster_server: lane docs after the settle {settle_lane_docs}")

    dense_name, sparse_name = ARENAS["unit"]["wrap"]
    dense_fn, sparse_fn = getattr(ti, dense_name), getattr(ti, sparse_name)
    cross = EditClock(asyncio.Event())
    same = EditClock(asyncio.Event())
    for g in groups_a + groups_b:
        for p in g:
            cross.watch(p)
            same.watch(p)
    base = {side: {k: exts[side].plane.counters[k] for k in ("flush_fast_ops", "flush_slow_ops")}
            for side in sides}
    replication0 = {side: dict(redises[side].replication_stats) for side in sides}
    pub0 = {side: dict(getattr(redises[side].pub, "counters", {})) for side in sides}
    if recorder is not None:
        recorder.before = clone_state(exts["b"].plane.state)
    for side in sides:
        anti_entropy[side].clear()
    redis_delivered0 = redis.counters["delivered"]
    dense_fn.launches = sparse_fn.launches = 0
    seams.reset()
    gc.callbacks.append(seams.collected)
    kinds = collections.Counter()
    traffic_started = time.perf_counter()
    recording = recorder if recorder is not None else contextlib.nullcontext()
    try:
        with recording:
            for _round in range(rounds):
                for d in range(num_docs):
                    group = groups_a[d] + groups_b[d]
                    for j, provider in enumerate(group):
                        kinds[_cluster_edit(rng, provider.document)] += 1
                        # the other instance's first provider, and this one's other
                        other = group[providers if j < providers else 0]
                        mate = group[j + 1 if j % providers == 0 else j - 1]
                        cross.expect(other, provider)
                        same.expect(mate, provider)
                    if d % 16 == 15:
                        await asyncio.sleep(0)
                await asyncio.wait_for(cross.idle.wait(), 300)
                await asyncio.wait_for(same.idle.wait(), 300)
            await _converge_mixed(
                [(p.document, cores[side].documents[p.name])
                 for side, gs in (("a", groups_a), ("b", groups_b)) for g in gs for p in g],
                time.perf_counter() + 300, "cluster_server rounds",
            )
            deadline = time.perf_counter() + 120
            while any(exts[s].plane.pending_ops() > 0 or exts[s]._flush_inflight for s in sides):
                check(time.perf_counter() < deadline, "cluster_server: the queues never drained")
                await asyncio.sleep(0.005)
            traffic_seconds = time.perf_counter() - traffic_started
            integrated = {
                side: sum(exts[side].plane.counters[k] - base[side][k] for k in base[side])
                for side in sides
            }
            exchanges = {side: dict(anti_entropy[side]) for side in sides}
            replication = {
                side: {k: v - replication0[side].get(k, 0)
                       for k, v in redises[side].replication_stats.items()}
                for side in sides
            }
            pub = {
                side: {k: v - pub0[side].get(k, 0)
                       for k, v in getattr(redises[side].pub, "counters", {}).items()
                       if k != "max_batch"}
                for side in sides
            }
            host_traffic = seams.summary()
            gc_traffic = _gc2_share(seams, traffic_seconds)
            seams.reset()
            joins, joiners = await _join_waves(cores["b"], names, exts["b"].plane, waves=1)
            host_joins = seams.summary()
    finally:
        gc.callbacks.remove(seams.collected)
    launches = {dense_name: dense_fn.launches, sparse_name: sparse_fn.launches}
    await _converge_mixed(
        [(p.document, cores["b"].documents[p.name]) for p in joiners],
        time.perf_counter() + 120, "cluster_server joiners",
    )
    # every doc converged on both instances, to the editors' state
    for d, name in enumerate(names):
        want = _mixed_state(groups_a[d][0].document)
        for side in sides:
            check(_mixed_state(cores[side].documents[name]) == want,
                  f"cluster_server: {name} differs on {side}")
    # the bytes b serves for an empty state vector rebuild each joiner's doc
    for provider in joiners:
        document = cores["b"].documents[provider.name]
        check(document.sync_source is not None,
              f"cluster_server: {provider.name} left b's plane: {exts['b'].plane.counters}")
        served = await document.sync_source.encode_state_as_update_async(None)
        check(served is not None, f"cluster_server: {provider.name} was not served from b's plane")
        rebuilt = Doc()
        apply_update(rebuilt, served)
        check(_mixed_state(rebuilt) == _mixed_state(provider.document),
              f"cluster_server: {provider.name}: served bytes rebuild another doc")
        check(encode_state_vector(rebuilt) == encode_state_vector(provider.document),
              f"cluster_server: {provider.name}: served bytes rebuild another state vector")
    counters = {side: dict(exts[side].plane.counters) for side in sides}
    served_docs = {side: sum(exts[side].is_served(name) for name in names) for side in sides}
    for p in everyone + joiners:
        p.destroy()
        p.websocket_provider.destroy()
    for side in sides:
        await cores[side].hooks("on_destroy", Payload(instance=cores[side]))
    redis_counters = dict(redis.counters)
    await redis.stop()
    rate = redises["a"].plane_anti_entropy_seconds
    return {
        "warm_seconds": round(warm_seconds, 3),
        "setup_seconds": round(setup_seconds, 3),
        "traffic_seconds": round(traffic_seconds, 3),
        "seconds": round(time.perf_counter() - started, 3),
        "edits": dict(kinds),
        "edit_observe_cross": percentiles_ms(cross.samples),
        "edit_observe_same": percentiles_ms(same.samples),
        "join_waves": joins,
        "ops_integrated": integrated,
        "ops_per_s": {s: integrated[s] / traffic_seconds if traffic_seconds else None for s in sides},
        "flush_cycles": {side: percentiles_ms(cycles[side]) for side in sides},
        "integrate_launches": launches,
        "anti_entropy": {
            "rate_s": rate,
            "limit_per_doc": int(traffic_seconds / rate) + 1,
            "max_per_doc": {s: max(exchanges[s].values(), default=0) for s in sides},
            "docs": {s: len(exchanges[s]) for s in sides},
        },
        # in the rounds: mini-redis's deliveries, each extension's frames
        # published, received and saved by coalescing, its client's lane
        "redis": {"delivered": redis_counters["delivered"] - redis_delivered0,
                  "slow_disconnects": redis_counters["slow_disconnects"]},
        "replication": replication,
        "publish_lane": pub,
        "gc2_traffic": gc_traffic,
        "host_traffic": host_traffic,
        "host_joins": host_joins,
        "served_docs": served_docs,
        "settle_lane_docs": settle_lane_docs,
        "settle_counters": {
            side: {k: settle_counters[side][k] for k in ("cpu_fallbacks", "docs_retired_lane_demote")}
            for side in sides
        },
        "counters": counters,
        "peak_resident_providers": len(everyone) + len(joiners),
    }


def phase_cluster_server(rng, num_docs, capacity, cuts):
    """The two-instance Redis topology on the card (run_cluster_server),
    with its checks: every doc converged on both instances, no CPU
    fallback and no unsupported retire on either plane, every doc served
    by both, broadcasts through both planes, the served bytes rebuild each
    joiner's doc, anti-entropy within its rate, and K1 launched. Then b's
    biggest integrate batch is replayed through the kernel and the plain
    version. Returns (launches, max_abs_err of the replay)."""
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    tag = "cluster_server"
    recorder = Recorder(mp, *ARENAS["unit"]["wrap"])
    out = asyncio.run(run_cluster_server(rng, num_docs, capacity, recorder=recorder))
    counters = out["counters"]
    launches = sum(out["integrate_launches"].values())
    emit(
        tag,
        gpu=nvidia_smi_line(),
        config="BASELINE config 4: mixed Text/Map/Array docs behind Redis fan-out, two serve-mode "
               "instances (tests/extensions/test_redis.py, benchmarks/config4_redis_fanout.py)",
        arena="unit",
        docs=num_docs,
        rows=CLUSTER_ROWS_PER_DOC * num_docs,
        capacity=capacity,
        providers_per_instance=CLUSTER_PROVIDERS,
        rounds=CLUSTER_ROUNDS,
        cuts=cuts,
        **{k: v for k, v in out.items() if k != "counters"},
        plane_counters={
            side: {k: counters[side][k] for k in (
                "cpu_fallbacks", "docs_retired_unsupported", "docs_retired_lane_demote",
                "plane_broadcasts", "sync_serves", "sync_cache_hits",
                "flush_fast_ops", "flush_slow_ops")}
            for side in counters
        },
    )
    for side, c in counters.items():
        check(c["cpu_fallbacks"] == 0, f"{tag}: {c['cpu_fallbacks']} CPU fallbacks on {side}")
        check(c["docs_retired_unsupported"] == 0, f"{tag}: unsupported retires on {side}")
        check(c["plane_broadcasts"] > 0, f"{tag}: no broadcast went through {side}'s plane")
        check(out["served_docs"][side] == num_docs,
              f"{tag}: {out['served_docs'][side]} of {num_docs} docs served on {side}")
    ae = out["anti_entropy"]
    for side, most in ae["max_per_doc"].items():
        check(most <= ae["limit_per_doc"],
              f"{tag}: {most} anti-entropy exchanges for one doc on {side} (limit {ae['limit_per_doc']})")
    check(out["join_waves"][0]["n"] == num_docs, f"{tag}: {out['join_waves']}")
    check(out["redis"]["slow_disconnects"] == 0,
          f"{tag}: mini-redis dropped {out['redis']['slow_disconnects']} slow subscribers")
    check(launches > 0, f"{tag}: K1 never launched from the cluster path")
    err = phase_served_replay(recorder.best, "unit", path="cluster_server")
    recorder.best = recorder.before = None
    return launches, err


# -- the edge tier: stateless edges in front of two merge cells -----------------

EDGE_DOCS = 1024
EDGE_CELLS = 2
EDGE_EDGES = 2
# a cell's plane holds every doc, so the survivor of the drain serves them all
EDGE_ROWS = 1024
EDGE_JOIN_CHUNK = 64  # joins at once: a burst past mini-redis's queue drops frames (ROADMAP Queue C)
EDGE_WATERMARK = 8  # the gateway's replica watermark (its default, 256, cut to fit 64 readers)
EDGE_HOT_READERS = 64  # readers of the hot doc on edge 1: audience 66 over the watermark
EDGE_DRAIN_TIMEOUT_S = 10.0  # as loadgen's drain_cell
EDGE_CUTS = {
    "docs": "1k docs as config 2, 1 writer and 1 reader a doc (10 clients in config 2), "
            "joined 64 at a time",
    "rounds": "one config 2 edit a writer per round: before the drain, under it, after it",
    "watermark": "replica watermark 256 cut to 8, so 64 readers of one doc grow a follower",
}


async def run_edge_server(rng, num_docs, capacity, device="cuda", recorder=None,
                          rows=EDGE_ROWS, chunk=EDGE_JOIN_CHUNK, watermark=EDGE_WATERMARK,
                          hot_readers=EDGE_HOT_READERS):
    """The split front door (hocuspocus_tpu_torch/edge/, the JAX package's
    tests/edge/test_edge_e2e.py topology): the port's MiniRedis as the
    relay bus; two cell servers, each `CellIngressExtension` +
    `TpuMergeExtension(serve=True, compact_threshold=0.75)` on `device`
    (a unit-arena plane of `rows` rows, two planes on one card, one device
    lane; the residency manager gives the replica seams); two
    `EdgeServer`s with `EdgeGatewayExtension(replica_watermark=...)`.

    Each doc has a writer on edge 0 and a reader on edge 1, each on an
    in-process socket of its own, joined `chunk` at a time, and starts
    with one word. A round is one BASELINE config 2 edit a writer, each
    timed to its reader (edit -> observe across edges). Then `hot_readers` more readers of doc 0 on
    edge 1 push its audience past the watermark: the owner cell streams
    it to a follower, bootstrapped through the owner's
    `ResidencyManager.replica_snapshot`, and one more edit of doc 0 is
    timed to every hot reader. Then the cell holding doc 0 drains
    (`Server.drain`, as loadgen's `drain_cell`) while a round runs, and
    its docs re-establish on the survivor; one more round follows.
    From round 1 on, each kernel launch is counted at its wrapper under
    the cell whose flush made it. `recorder` keeps the survivor's
    biggest integrate batch. Returns the phase's numbers."""
    import contextlib

    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_as_update
    from hocuspocus_tpu_torch.edge import CellIngressExtension, EdgeGatewayExtension, EdgeServer
    from hocuspocus_tpu_torch.net.mini_redis import MiniRedis
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
    from hocuspocus_tpu_torch.server import Configuration, Server
    from hocuspocus_tpu_torch.tpu import TpuMergeExtension
    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

    reset_device_lane()
    started = time.perf_counter()
    redis = await MiniRedis(subscriber_queue_limit=CLUSTER_SUBSCRIBER_QUEUE).start()
    exts, ingresses, cells, edges, gateways = [], [], [], [], []
    for i in range(EDGE_CELLS):
        ext = TpuMergeExtension(
            num_docs=rows, capacity=capacity, serve=True, device=device, compact_threshold=0.75
        )
        ingress = CellIngressExtension(
            cell_id=f"smoke-cell-{i}", port=redis.port, announce_interval_s=0.25
        )
        server = Server(Configuration(quiet=True, extensions=[ingress, ext]))
        await server.listen(port=0)
        exts.append(ext)
        ingresses.append(ingress)
        cells.append(server)
    for i in range(EDGE_EDGES):
        gateway = EdgeGatewayExtension(
            edge_id=f"smoke-edge-{i}", port=redis.port, replica_watermark=watermark
        )
        server = EdgeServer(Configuration(quiet=True, extensions=[gateway]))
        await server.listen(port=0)
        edges.append(server)
        gateways.append(gateway.gateway)
    for ext in exts:
        await ext.warmup_task
        check(ext.plane.compile_watch.warmed, "edge_server: a cell's warm grid did not finish")
    deadline = time.perf_counter() + 30
    for gateway in gateways:
        while len(gateway.router.healthy_cells()) < EDGE_CELLS:
            check(time.perf_counter() < deadline, f"edge_server: {gateway.edge_id} never saw both cells")
            await asyncio.sleep(0.02)
    warm_seconds = time.perf_counter() - started

    # per-cell launch counts and the recorder's gate: each cell's flush
    # (the lane's and a serve's own, on whichever thread) marks its
    # thread, and each launch of a wrapper the plane calls is counted
    # under that mark where it launches (a card tensor), so concurrent
    # flushes of the two cells cannot credit one with the other's
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    dense_name, sparse_name = ARENAS["unit"]["wrap"]
    dense_fn, sparse_fn = getattr(ti, dense_name), getattr(ti, sparse_name)
    flushing = threading.local()
    # cell index -> launches; None: a launch outside every cell's flush
    cell_launches = collections.Counter()
    counting = {"on": False}
    for i, ext in enumerate(exts):
        plane = ext.plane
        real_flush = plane.flush

        def marked_flush(max_batches=None, real_flush=real_flush, i=i, plane=plane):
            flushing.cell = i
            try:
                count = real_flush(max_batches)
            finally:
                flushing.cell = None
            if recorder is not None and i == recorder.cell:
                recorder.after_flush(plane.state)
            return count

        plane.flush = marked_flush
    if recorder is not None:
        recorder.gate = lambda: getattr(flushing, "cell", None) == recorder.cell

    @contextlib.contextmanager
    def counted_by_cell():
        """Wrap the plane's integrate wrappers (the recorder's, when it
        is on) for the measured rounds; restored on the way out."""
        current = {name: getattr(mp, name) for name in (dense_name, sparse_name)}

        def counted(fn):
            def call(state, *args):
                out = fn(state, *args)
                if counting["on"] and state.id_client.is_cuda:
                    cell_launches[getattr(flushing, "cell", None)] += 1
                return out
            return call

        for name, fn in current.items():
            setattr(mp, name, counted(fn))
        try:
            yield
        finally:
            for name, fn in current.items():
                setattr(mp, name, fn)

    names = [f"edge-{i}" for i in range(num_docs)]
    closes = collections.Counter()

    def provider(edge, name):
        p = HocuspocusProvider(name=name, websocket_provider=InProcessProviderSocket(edges[edge]))
        p.on("close", lambda *_a, **_k: closes.update(["close"]))
        p.on("authentication_failed", lambda *_a, **_k: closes.update(["denied"]))
        return p

    async def join(edge, doc_names) -> tuple:
        """`chunk` at a time: (providers, join -> synced seconds)."""
        out, waits = [], []
        for s in range(0, len(doc_names), chunk):
            wave = [provider(edge, name) for name in doc_names[s:s + chunk]]
            synced_at = {}
            t_join = time.perf_counter()
            for p in wave:
                p.on("synced", lambda payload, p=p: payload.get("state")
                     and synced_at.setdefault(p, time.perf_counter()))
                p.attach()
            await asyncio.wait_for(_all_synced(wave), 300)
            waits += [synced_at.get(p, time.perf_counter()) - t_join for p in wave]
            out += wave
        return out, waits

    writers, writer_joins = await join(0, names)
    readers, reader_joins = await join(1, names)

    def converged(pairs) -> list:
        return [(a, b) for a, b in pairs
                if encode_state_as_update(a.document) != encode_state_as_update(b.document)]

    async def until_converged(pairs, what, timeout=300):
        deadline = time.perf_counter() + timeout
        left = converged(pairs)
        while left:
            check(time.perf_counter() < deadline, f"edge_server: {what}: {len(left)} docs never converged")
            await asyncio.sleep(0.02)
            left = converged(left)

    pairs = list(zip(writers, readers))
    # each doc starts with one word: a first edit of an empty doc is an
    # append, which the append path takes, so without it a cell whose docs
    # see only round 1 (the drained one) could run no K1 at all
    for d, writer in enumerate(writers):
        writer.document.get_text("t").insert(0, WORDS[d % len(WORDS)])
        if d % 16 == 15:
            await asyncio.sleep(0)
    await until_converged(pairs, "the first words")

    async def until_idle(what):
        """No op queued and no flush in flight on either plane."""
        deadline = time.perf_counter() + 120
        while any(ext.plane.pending_ops() > 0 or ext._flush_inflight for ext in exts):
            check(time.perf_counter() < deadline, f"edge_server: {what}: the queues never drained")
            await asyncio.sleep(0.005)

    # the counts start at 0 with no flush in flight, so each cell's flush
    # counts only launches of the measured rounds
    await until_idle("the first words")
    setup_seconds = time.perf_counter() - started
    clock = EditClock(asyncio.Event())
    for p in readers:
        clock.watch(p)

    async def edit_round(what):
        for d, (writer, reader) in enumerate(pairs):
            _server_edit(rng, writer.document.get_text("t"))
            clock.expect(reader, writer)
            if d % 16 == 15:
                await asyncio.sleep(0)
        await asyncio.wait_for(clock.idle.wait(), 300)
        await until_converged(pairs, what)

    base = [{k: ext.plane.counters[k] for k in ("flush_fast_ops", "flush_slow_ops")} for ext in exts]
    dense_fn.launches = sparse_fn.launches = 0
    counting["on"] = True
    recording = recorder if recorder is not None else contextlib.nullcontext()
    with recording, counted_by_cell():
        t_round = time.perf_counter()
        await edit_round("round 1")
        round_seconds = time.perf_counter() - t_round

        # the hot doc: an audience past the watermark grows a follower
        hot = names[0]
        owner_index = next(i for i, c in enumerate(cells) if hot in c.hocuspocus.documents)
        follower_index = 1 - owner_index
        served0 = [dict(ext.residency.replica_serves) for ext in exts]
        fallbacks0 = [ext.plane.counters["cpu_fallbacks"] for ext in exts]
        t_hot = time.perf_counter()
        hot_audience, hot_joins = await join(1, [hot] * hot_readers)
        owner_replicas = ingresses[owner_index].replicas
        follower_replicas = ingresses[follower_index].replicas
        deadline = time.perf_counter() + 60
        while not follower_replicas.following.get(hot, {}).get("synced"):
            check(time.perf_counter() < deadline,
                  f"edge_server: no follower of the hot doc: {owner_replicas.stats()} "
                  f"{follower_replicas.stats()}")
            await asyncio.sleep(0.02)
        follow_seconds = time.perf_counter() - t_hot
        hot_clock = EditClock(asyncio.Event())
        for p in hot_audience:
            hot_clock.watch(p)
        _server_edit(rng, writers[0].document.get_text("t"))
        for p in hot_audience:
            hot_clock.expect(p, writers[0])
        await asyncio.wait_for(hot_clock.idle.wait(), 120)
        await until_converged([(writers[0], p) for p in hot_audience + [readers[0]]], "hot doc")
        owner_doc = cells[owner_index].hocuspocus.documents[hot]
        follower_doc = cells[follower_index].hocuspocus.documents.get(hot)
        deadline = time.perf_counter() + 60
        while follower_doc is None or encode_state_as_update(follower_doc) != encode_state_as_update(owner_doc):
            check(time.perf_counter() < deadline,
                  "edge_server: the follower's copy of the hot doc differs from the owner's")
            await asyncio.sleep(0.02)
            follower_doc = cells[follower_index].hocuspocus.documents.get(hot)
        hot_state = {
            "owner": ingresses[owner_index].cell_id,
            "follower": ingresses[follower_index].cell_id,
            # the bootstraps and catch-ups each cell's plane served through
            # its replica seams, and its CPU fallbacks meanwhile
            "replica_serves": {
                ingresses[i].cell_id: {k: v - served0[i][k] for k, v in exts[i].residency.replica_serves.items()}
                for i in range(EDGE_CELLS)
            },
            "cpu_fallbacks": {ingresses[i].cell_id: exts[i].plane.counters["cpu_fallbacks"] - fallbacks0[i]
                              for i in range(EDGE_CELLS)},
            "owner_replicas": owner_replicas.stats()["counters"],
            "follower_replicas": follower_replicas.stats()["counters"],
            "follow_seconds": round(follow_seconds, 3),
            "edit_observe": percentiles_ms(hot_clock.samples),
        }
        for p in hot_audience:
            p.destroy()
            p.websocket_provider.destroy()

        # the drain under traffic: the hot doc's owner announces departure,
        # edges remap its docs to the survivor and replay their resync
        drained, survivor = owner_index, follower_index
        if recorder is not None:
            recorder.cell = survivor
        drained_docs = sorted(cells[drained].hocuspocus.documents)
        t_drain = time.perf_counter()
        drain_task = asyncio.ensure_future(cells[drained].drain(timeout_secs=EDGE_DRAIN_TIMEOUT_S))
        await edit_round("the round under the drain")
        outcome = await drain_task
        deadline = time.perf_counter() + 120
        while any(name not in cells[survivor].hocuspocus.documents for name in names):
            check(time.perf_counter() < deadline,
                  f"edge_server: {sum(n not in cells[survivor].hocuspocus.documents for n in names)} "
                  "docs never re-established on the survivor")
            await asyncio.sleep(0.02)
        handoff_seconds = time.perf_counter() - t_drain
        await edit_round("the round after the drain")
        await until_idle("the last round")
    counting["on"] = False
    integrated = [
        sum(ext.plane.counters[k] - base[i][k] for k in base[i]) for i, ext in enumerate(exts)
    ]
    launches = {dense_name: dense_fn.launches, sparse_name: sparse_fn.launches}
    # nothing acknowledged was lost: the survivor holds every writer's doc
    # byte for byte, and the bytes its plane serves a joiner rebuild it
    survivor_docs = cells[survivor].hocuspocus.documents
    rebuilt_ok = 0
    for writer in writers:
        document = survivor_docs[writer.name]
        check(encode_state_as_update(document) == encode_state_as_update(writer.document),
              f"edge_server: {writer.name} on the survivor differs from its writer")
        check(document.sync_source is not None,
              f"edge_server: {writer.name} left the survivor's plane: {exts[survivor].plane.counters}")
        served = await document.sync_source.encode_state_as_update_async(None)
        check(served is not None, f"edge_server: {writer.name} was not served from the survivor's plane")
        rebuilt = Doc()
        apply_update(rebuilt, served)
        check(encode_state_as_update(rebuilt) == encode_state_as_update(writer.document),
              f"edge_server: {writer.name}: served bytes rebuild another doc")
        rebuilt_ok += 1
    counters = [dict(ext.plane.counters) for ext in exts]
    served_docs = [sum(ext.is_served(name) for name in names) for ext in exts]
    gateway_counters = {g.edge_id: dict(g.counters) for g in gateways}
    redis_counters = dict(redis.counters)
    ingress_counters = {x.cell_id: dict(x.counters) for x in ingresses}
    for p in writers + readers:
        p.destroy()
        p.websocket_provider.destroy()
    await asyncio.sleep(0)
    for server in edges + cells:
        await server.destroy()
    await redis.stop()
    return {
        "warm_seconds": round(warm_seconds, 3),
        "setup_seconds": round(setup_seconds, 3),
        "round_seconds": round(round_seconds, 3),
        "seconds": round(time.perf_counter() - started, 3),
        "edit_observe_across_edges": percentiles_ms(clock.samples),
        "join_synced_writers": percentiles_ms(writer_joins),
        "join_synced_readers": percentiles_ms(reader_joins),
        "join_synced_hot": percentiles_ms(hot_joins),
        "hot_doc": hot_state,
        "drain": {
            "cell": ingresses[drained].cell_id,
            "docs": len(drained_docs),
            "stored": outcome.get("stored"),
            "duration_s": outcome.get("duration_s"),
            "handoff_seconds": round(handoff_seconds, 3),
        },
        "client_closes": dict(closes),
        "ops_integrated": {ingresses[i].cell_id: integrated[i] for i in range(EDGE_CELLS)},
        "integrate_launches": launches,
        "cell_launches": {ingresses[i].cell_id: cell_launches[i] for i in range(EDGE_CELLS)},
        "launches_outside_flush": cell_launches[None],
        "k1_ops": {ingresses[i].cell_id: exts[i].plane.counters["flush_slow_ops"] - base[i]["flush_slow_ops"]
                   for i in range(EDGE_CELLS)},
        "served_docs": {ingresses[i].cell_id: served_docs[i] for i in range(EDGE_CELLS)},
        "rebuilt": rebuilt_ok,
        "survivor": ingresses[survivor].cell_id,
        "gateways": gateway_counters,
        "ingress": ingress_counters,
        "redis": {"delivered": redis_counters["delivered"],
                  "slow_disconnects": redis_counters["slow_disconnects"],
                  "dropped_slow": redis_counters["dropped_slow"]},
        "counters": {ingresses[i].cell_id: counters[i] for i in range(EDGE_CELLS)},
    }


def phase_edge_server(rng, num_docs, capacity, cuts):
    """The edge tier on the card (run_edge_server), with its checks: every
    reader byte-identical to its writer after each step, the follower's
    copy of the hot doc byte-identical to the owner's and bootstrapped
    from the owner's plane (replica_snapshot served, no CPU fallback),
    nothing acknowledged lost across the drain and no client-visible
    disconnect, ops integrated and no CPU fallback on both planes, every
    doc served by the survivor and its served bytes rebuilding every doc,
    no relay overflow and no mini-redis drop, K1 launched on both cells
    with ops of their own (each launch counted at the wrapper under the
    cell whose flush made it). Then the survivor's biggest integrate
    batch is replayed through the kernel and the plain version. Returns
    (launches, max_abs_err of the replay)."""
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    tag = "edge_server"
    recorder = Recorder(mp, *ARENAS["unit"]["wrap"])
    recorder.cell = None
    out = asyncio.run(run_edge_server(rng, num_docs, capacity, recorder=recorder))
    counters = out["counters"]
    launches = sum(out["integrate_launches"].values())
    emit(
        tag,
        gpu=nvidia_smi_line(),
        config="BASELINE config 2's Y.Text edits through the split front door: 2 stateless edges, "
               "2 merge cells (tests/edge/test_edge_e2e.py's topology)",
        arena="unit",
        docs=num_docs,
        rows=EDGE_ROWS,
        capacity=capacity,
        watermark=EDGE_WATERMARK,
        cuts=cuts,
        **{k: v for k, v in out.items() if k != "counters"},
        plane_counters={
            cell: {k: c[k] for k in (
                "cpu_fallbacks", "docs_retired_unsupported", "plane_broadcasts", "sync_serves",
                "flush_fast_ops", "flush_slow_ops")}
            for cell, c in counters.items()
        },
    )
    for cell, c in counters.items():
        check(c["cpu_fallbacks"] == 0, f"{tag}: {c['cpu_fallbacks']} CPU fallbacks on {cell}")
        check(c["docs_retired_unsupported"] == 0, f"{tag}: unsupported retires on {cell}")
        check(out["ops_integrated"][cell] > 0, f"{tag}: no op integrated on {cell}")
        check(out["cell_launches"][cell] > 0, f"{tag}: K1 never launched on {cell}")
        check(out["k1_ops"][cell] > 0, f"{tag}: no op integrated through K1 on {cell}")
    check(out["launches_outside_flush"] == 0,
          f"{tag}: {out['launches_outside_flush']} K1 launches outside both cells' flushes")
    check(sum(out["cell_launches"].values()) == launches,
          f"{tag}: the cells' launches {out['cell_launches']} do not add up to the wrappers' {launches}")
    check(out["served_docs"][out["survivor"]] == num_docs,
          f"{tag}: {out['served_docs'][out['survivor']]} of {num_docs} docs served by the survivor")
    check(out["rebuilt"] == num_docs, f"{tag}: {out['rebuilt']} of {num_docs} docs rebuilt")
    hot = out["hot_doc"]
    check(hot["replica_serves"][hot["owner"]]["snapshot"] >= 1,
          f"{tag}: the owner's plane did not serve the follower's bootstrap: {hot}")
    check(not any(hot["cpu_fallbacks"].values()), f"{tag}: the hot doc's step fell back to the CPU: {hot}")
    check(not out["client_closes"], f"{tag}: client-visible disconnects: {out['client_closes']}")
    for edge, c in out["gateways"].items():
        check(c.get("relay_overflows", 0) == 0, f"{tag}: {c['relay_overflows']} relay overflows on {edge}")
        check(c.get("handoffs", 0) >= 1, f"{tag}: {edge} handed nothing off in the drain")
    check(out["redis"]["slow_disconnects"] == 0 and out["redis"]["dropped_slow"] == 0,
          f"{tag}: mini-redis dropped frames: {out['redis']}")
    check(launches > 0, f"{tag}: K1 never launched from the edge path")
    err = phase_served_replay(recorder.best, "unit", path="edge_server")
    recorder.best = recorder.before = None
    return launches, err


# -- per-device merge cells: the CLI's --tpu-serve --tpu-devices 4 ------------

MULTI_DOCS = 1024
MULTI_CELLS = 4
MULTI_ROWS = 512  # a cell's rows: 4 x 512 hold the 1,024 docs twice over
MULTI_EDITORS = 2
MULTI_JOIN_CHUNK = 64  # docs joined at once (both editors of each)
# the mega doc's appends: multi_device_storm's 64 storm-phase inserts, but
# of 24-80 units instead of its 256-512, which would fill the 4,096-unit
# row in about 11 inserts and retire the doc to its CPU document before the
# rebalancer saw its work; 64 of these keep about 3.3k units in the row
MULTI_MEGA_INSERTS = 64
MULTI_MEGA_UNITS = (24, 80)
# multi_device_storm's rebalancer (hocuspocus_tpu_torch/loadgen/scenarios.py)
MULTI_REBALANCE = {"rebalance_interval_s": 0.25, "rebalance_ratio": 1.5,
                   "rebalance_min_units": 64.0, "migrate_batch": 4}
# the CLI's supervisor and residency defaults, but the watchdog's cadence cut
# from 5 s to 1 s and the canary deadline (the cadence by default) to 3 s, so
# that the late cell's three overruns fit the phase
MULTI_SUPERVISOR = {"init_timeout": 60.0, "watchdog_interval": 1.0, "canary_deadline": 3.0,
                    "breaker_threshold": 3, "compact_threshold": 0.75, "hydrate_batch": 64}
# the late cell's probe sleeps twice the deadline: it overruns one tick, and
# the next two find it still outstanding, so the breaker opens in three ticks
MULTI_LATE_DEADLINES = 2.0
MULTI_CUTS = {
    "docs": "1k docs as config 2, 2 editors a doc (10 clients in config 2), joined 64 docs at a time",
    "rounds": "one config 2 edit an editor a round: before the skew, under the late cell, after it",
    "watchdog": "the CLI's 5 s watchdog cadence cut to 1 s, its canary deadline to 3 s",
    "devices": "4 cells wrapped onto the one card the machine has, each with its own lane",
    "mega": "multi_device_storm's mega inserts of 256-512 units cut to 24-80, so the doc fits its row",
}


class CellLaunches:
    """K1 launches counted per cell of a cell plane. Each cell's flush
    (the lane's, a serve's, a hydration's, on whichever thread) and each
    canary mark their thread, and while `counted()` is entered each
    launch of a wrapper the planes call is counted under that mark where
    it launches (a card tensor): `flush_launches[cell]` (None: outside
    every flush and canary), `canary_launches[cell]`; `flushes[cell]`
    counts flush calls. Counting runs from `start()` until `on` is
    cleared; `recorder`, when given, keeps its cell's biggest batch."""

    def __init__(self, cells, recorder=None) -> None:
        from hocuspocus_tpu_torch.tpu import integrate as ti

        self.names = ARENAS["unit"]["wrap"]
        self.fns = [getattr(ti, name) for name in self.names]
        self.marking = threading.local()
        self.flush_launches = collections.Counter()
        self.canary_launches = collections.Counter()
        self.flushes = collections.Counter()
        self.on = False
        for i, cell in enumerate(cells):
            self._mark(i, cell.plane, recorder)
        if recorder is not None:
            recorder.gate = lambda: getattr(self.marking, "site", None) == ("flush", recorder.cell)

    def _mark(self, i, plane, recorder) -> None:
        marking = self.marking
        real_flush, real_probe = plane.flush, plane.canary_probe

        def marked_flush(max_batches=None):
            outer = getattr(marking, "site", None)
            marking.site = ("flush", i)
            try:
                count = real_flush(max_batches)
            finally:
                marking.site = outer
            if self.on:
                self.flushes[i] += 1
            if recorder is not None and i == recorder.cell:
                recorder.after_flush(plane.state)
            return count

        def marked_probe():
            marking.site = ("canary", i)
            try:
                return real_probe()
            finally:
                marking.site = None

        plane.flush, plane.canary_probe = marked_flush, marked_probe

    def start(self) -> None:
        for fn in self.fns:
            fn.launches = 0
        self.on = True

    @contextlib.contextmanager
    def counted(self):
        from hocuspocus_tpu_torch.tpu import merge_plane as mp

        current = {name: getattr(mp, name) for name in self.names}

        def counting(fn):
            def call(state, *args):
                out = fn(state, *args)
                if self.on and state.id_client.is_cuda:
                    site = getattr(self.marking, "site", None)
                    if site is not None and site[0] == "canary":
                        self.canary_launches[site[1]] += 1
                    else:
                        self.flush_launches[None if site is None else site[1]] += 1
                return out
            return call

        for name, fn in current.items():
            setattr(mp, name, counting(fn))
        try:
            yield
        finally:
            for name, fn in current.items():
                setattr(mp, name, fn)

    def wrapper_launches(self) -> dict:
        return {name: fn.launches for name, fn in zip(self.names, self.fns)}

    def by_cell(self, cells: int) -> dict:
        return {
            "cell_launches": {str(i): self.flush_launches[i] for i in range(cells)},
            "canary_launches": {str(i): self.canary_launches[i] for i in range(cells)},
            "launches_outside_flush": self.flush_launches[None],
            "cell_flushes": {str(i): self.flushes[i] for i in range(cells)},
        }


class CellHarness:
    """The in-process clients and books that the cell-plane phases share
    (multi_device_server, fleet_server) over a core and its cell runtime:
    providers on in-process sockets of their own, counting client-visible
    closes (`closes`); joins `chunk` docs at a time; the convergence and
    idle waits over `editors` (doc -> its providers); each migration
    timed from its start to the doc hydrated on its target (`migrations`,
    `note_hydrated`); each CPU fallback of a doc a cell held recorded as
    (cell, doc, window, during a migration, retire reason) (`fallbacks`);
    and the served-bytes rebuild of every doc. `window` names the part of
    the phase that runs."""

    def __init__(self, tag, core, runtime, chunk) -> None:
        self.tag, self.core, self.runtime, self.chunk = tag, core, runtime, chunk
        self.cells = runtime.cells
        self.window = "join"
        self.migrating = 0
        self.closes = collections.Counter()
        self.editors = {}
        self.fallbacks = []
        self.migrations = []
        for i, cell in enumerate(self.cells):
            self._record_fallbacks(i, cell)
        real_migrate = runtime.migrate_doc

        async def timed_migrate(name, src, dst):
            t0 = time.perf_counter()
            self.migrating += 1
            try:
                moved = await real_migrate(name, src, dst)
            finally:
                self.migrating -= 1
            if moved:
                self.migrations.append({"doc": name, "src": src, "dst": dst, "window": self.window,
                                        "started": t0, "hydrated": None})
            return moved

        runtime.migrate_doc = timed_migrate

    def _record_fallbacks(self, i, cell) -> None:
        real_fallback = cell._fallback_to_cpu

        def recorded_fallback(document):
            if document.name in cell._docs:
                plane_doc = cell.plane.docs.get(document.name)
                self.fallbacks.append((i, document.name, self.window, self.migrating > 0,
                                       None if plane_doc is None else plane_doc.retire_reason))
            return real_fallback(document)

        cell._fallback_to_cpu = recorded_fallback

    def note_hydrated(self) -> None:
        now = time.perf_counter()
        for move in self.migrations:
            if move["hydrated"] is None and move["doc"] in self.cells[move["dst"]]._docs:
                move["hydrated"] = now

    async def until_hydrated(self, timeout=60) -> None:
        deadline = time.perf_counter() + timeout
        while True:
            self.note_hydrated()
            if all(move["hydrated"] is not None for move in self.migrations):
                return
            check(time.perf_counter() < deadline, f"{self.tag}: a migrated doc never hydrated on its target")
            await asyncio.sleep(0.005)

    def migration_ms(self, moves=None) -> dict:
        """evict -> hydrated percentiles of `moves` (indices), or of all."""
        chosen = self.migrations if moves is None else [self.migrations[m] for m in moves]
        return percentiles_ms([m["hydrated"] - m["started"] for m in chosen if m["hydrated"] is not None])

    def provider(self, name):
        from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket

        p = HocuspocusProvider(name=name, websocket_provider=InProcessProviderSocket(self.core))
        p.on("close", lambda *_a, **_k: self.closes.update(["close"]))
        p.on("authentication_failed", lambda *_a, **_k: self.closes.update(["denied"]))
        return p

    async def join(self, doc_names, per_doc) -> tuple:
        """`chunk` docs at a time: (providers by doc, join -> synced seconds)."""
        out, waits = {}, []
        for s in range(0, len(doc_names), self.chunk):
            wave = [(name, self.provider(name)) for name in doc_names[s:s + self.chunk] for _ in range(per_doc)]
            synced_at = {}
            t_join = time.perf_counter()
            for _name, p in wave:
                p.on("synced", lambda payload, p=p: payload.get("state")
                     and synced_at.setdefault(p, time.perf_counter()))
                p.attach()
            await asyncio.wait_for(_all_synced([p for _n, p in wave]), 300)
            waits += [synced_at.get(p, time.perf_counter()) - t_join for _n, p in wave]
            for name, p in wave:
                out.setdefault(name, []).append(p)
        return out, waits

    def diverged(self, groups) -> list:
        from hocuspocus_tpu_torch.crdt import encode_state_as_update

        out = []
        for name, group in groups.items():
            states = {encode_state_as_update(p.document) for p in group}
            server = self.core.documents.get(name)
            if server is not None:
                states.add(encode_state_as_update(server))
            if len(states) != 1:
                out.append(name)
        return out

    async def until_converged(self, what, groups=None, timeout=300) -> None:
        groups = self.editors if groups is None else groups
        deadline = time.perf_counter() + timeout
        left = self.diverged(groups)
        while left:
            check(time.perf_counter() < deadline, f"{self.tag}: {what}: {len(left)} docs never converged: {left[:4]}")
            await asyncio.sleep(0.02)
            left = self.diverged({name: groups[name] for name in left})

    async def until_idle(self, what) -> None:
        deadline = time.perf_counter() + 120
        while any(cell.plane.pending_ops() > 0 or cell._flush_inflight for cell in self.cells):
            check(time.perf_counter() < deadline, f"{self.tag}: {what}: the queues never drained")
            await asyncio.sleep(0.005)

    async def first_words(self, names) -> None:
        """One word a doc by its first editor, every doc converged and the
        queues drained."""
        for d, name in enumerate(names):
            self.editors[name][0].document.get_text("t").insert(0, WORDS[d % len(WORDS)])
            if d % 16 == 15:
                await asyncio.sleep(0)
        await self.until_converged("the first words")
        await self.until_idle("the first words")

    async def rebuild(self, names, skip=()) -> tuple:
        """Each doc of `names` not in `skip` served from a cell, its served
        bytes rebuilding the server's document: (docs rebuilt, docs by
        serving cell)."""
        from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_as_update

        rebuilt = 0
        served_by = collections.Counter()
        for name in names:
            if name in skip:
                continue
            document = self.core.documents[name]
            check(document.sync_source is not None, f"{self.tag}: {name} is not served by a cell: "
                                                    f"{self.fallbacks[-4:]}")
            served = await document.sync_source.encode_state_as_update_async(None)
            check(served is not None, f"{self.tag}: {name} was not served from its cell")
            doc = Doc()
            apply_update(doc, served)
            check(encode_state_as_update(doc) == encode_state_as_update(document),
                  f"{self.tag}: {name}: served bytes rebuild another doc")
            rebuilt += 1
            served_by[self.runtime.cell_index_for(name)] += 1
        return rebuilt, served_by

    @staticmethod
    def destroy(*groups_by_doc) -> None:
        for groups in groups_by_doc:
            for group in groups.values():
                for p in group:
                    p.destroy()
                    p.websocket_provider.destroy()


async def run_multi_device_server(rng, num_docs, capacity, device=None, recorder=None,
                                  rows=MULTI_ROWS, chunk=MULTI_JOIN_CHUNK,
                                  mega_inserts=MULTI_MEGA_INSERTS, mega_units=MULTI_MEGA_UNITS,
                                  supervisor=None):
    """The CLI's `--tpu-serve --tpu-devices 4` deployment in process: the
    port's Hocuspocus core with `Metrics` and
    `SupervisedTpuMergeExtension(devices=4)` (no `device`: the card), four
    unit-arena cells of `rows` rows each with its own lane
    (`get_device_lane(i)`) and timer phase, the rebalancer at
    multi_device_storm's cadence (MULTI_REBALANCE).

    Each doc has MULTI_EDITORS editors on in-process sockets of their own,
    joined `chunk` docs at a time, and starts with one word. Round 1 is
    one config 2 edit an editor. The skew round: doc 0 takes
    `mega_inserts` appends of `mega_units` units (multi_device_storm's
    mega doc), one after every few other docs' one edit, and the
    rebalancer must migrate docs off the hot cell. The late-cell round:
    one cell's `plane.canary_probe` sleeps past the canary deadline until
    its breaker opens (fault injection here, nothing in the package), a
    round of edits runs while its docs are on the CPU documents, then the
    probe is restored and the cell restored and re-onboarded. A last
    round, then a fresh joiner for every doc. From round 1 on each K1
    launch is counted at its wrapper under the cell whose flush (or
    canary) made it; `recorder` keeps cell 0's biggest integrate batch.
    Each CPU fallback is attributed: the late cell's docs in its window,
    a migration's CPU snapshot, or the mega doc outgrowing its row.
    Returns the phase's numbers."""
    from hocuspocus_tpu_torch.observability import Metrics
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import SupervisedTpuMergeExtension
    from hocuspocus_tpu_torch.tpu.scheduler import get_device_lane, reset_device_lane
    from hocuspocus_tpu_torch.tpu.supervisor import STATE_DEGRADED, STATE_INITIALIZING, STATE_READY

    tag = "multi_device_server"
    supervisor = dict(MULTI_SUPERVISOR if supervisor is None else supervisor)
    reset_device_lane()
    started = time.perf_counter()
    ext = SupervisedTpuMergeExtension(
        devices=MULTI_CELLS, num_docs=rows, capacity=capacity, serve=True, arena="unit",
        **supervisor, **MULTI_REBALANCE, **({} if device is None else {"device": device}),
    )
    metrics = Metrics(**METRICS_DEFAULTS)
    core = Hocuspocus(Configuration(quiet=True, extensions=[metrics, ext]))
    await core.ensure_configured()
    await core.hooks("on_listen", Payload(instance=core, configuration=core.configuration, port=None))
    deadline = time.perf_counter() + 180
    while ext.supervisor.state != STATE_READY:
        check(ext.supervisor.state == STATE_INITIALIZING,
              f"{tag}: the supervisor is {ext.supervisor.state}: {ext.health_status()}")
        check(time.perf_counter() < deadline, f"{tag}: the cells never attached")
        await asyncio.sleep(0.02)
    runtime = ext.runtime
    cells = runtime.cells
    check(len(cells) == MULTI_CELLS, f"{tag}: {len(cells)} cells")
    for cell in cells:
        await cell.warmup_task
        check(cell.plane.compile_watch.warmed, f"{tag}: a cell's warm grid did not finish")
    lanes = [cell.lane for cell in cells]
    check(lanes == [get_device_lane(i) for i in range(MULTI_CELLS)] and len(set(map(id, lanes))) == MULTI_CELLS,
          f"{tag}: the cells do not each admit through a lane of their own")
    ready_seconds = time.perf_counter() - started

    counts = CellLaunches(cells, recorder)
    h = CellHarness(tag, core, runtime, chunk)
    names = [f"multi-{i}" for i in range(num_docs)]
    editors, editor_joins = await h.join(names, MULTI_EDITORS)
    h.editors = editors
    await h.first_words(names)
    setup_seconds = time.perf_counter() - started

    clocks = {}

    async def edit_round(what, docs=None):
        """One config 2 edit an editor of every doc, each insert timed to
        the doc's other editor; then every doc converged."""
        clock = clocks[what] = EditClock(asyncio.Event())
        for group in editors.values():
            for p in group:
                clock.watch(p)
        for d, name in enumerate(names if docs is None else docs):
            group = editors[name]
            for k, p in enumerate(group):
                if _server_edit(rng, p.document.get_text("t")):
                    clock.expect(group[(k + 1) % len(group)], p)
            if d % 16 == 15:
                await asyncio.sleep(0)
        await asyncio.wait_for(clock.idle.wait(), 300)
        await h.until_converged(what)

    base = [{k: cell.plane.counters[k] for k in ("flush_fast_ops", "flush_slow_ops", "cpu_fallbacks")}
            for cell in cells]
    lane0 = [dict(lane.counters) for lane in lanes]
    counts.start()
    recording = recorder if recorder is not None else contextlib.nullcontext()
    rounds = {}

    async def watch_hydrations():
        while counts.on:
            h.note_hydrated()
            await asyncio.sleep(0.005)

    watcher = asyncio.ensure_future(watch_hydrations())
    with recording, counts.counted():
        h.window = "round 1"
        t0 = time.perf_counter()
        await edit_round("round 1")
        rounds["round 1"] = time.perf_counter() - t0

        # the skew: the mega doc's appends among one edit of every other doc
        h.window = "skew"
        mega = names[0]
        mega_cell = runtime.cell_index_for(mega)
        migrated0 = runtime.migration_stats["docs_migrated"]
        stats_before = runtime.cell_stats()
        t0 = time.perf_counter()
        clock = clocks["skew"] = EditClock(asyncio.Event())
        for group in editors.values():
            for p in group:
                clock.watch(p)
        others = names[1:]
        every = max(len(others) // max(mega_inserts, 1), 1)
        writer = editors[mega][0]
        inserted = 0
        for d, name in enumerate(others):
            group = editors[name]
            if _server_edit(rng, group[0].document.get_text("t")):
                clock.expect(group[1], group[0])
            if d % every == every - 1 and inserted < mega_inserts:
                text = writer.document.get_text("t")
                text.insert(len(text), "x" * int(rng.integers(mega_units[0], mega_units[1] + 1)))
                clock.expect(editors[mega][1], writer)
                inserted += 1
                await asyncio.sleep(0)
        while inserted < mega_inserts:
            text = writer.document.get_text("t")
            text.insert(len(text), "x" * int(rng.integers(mega_units[0], mega_units[1] + 1)))
            clock.expect(editors[mega][1], writer)
            inserted += 1
            await asyncio.sleep(0)
        await asyncio.wait_for(clock.idle.wait(), 300)
        await h.until_converged("the skew round")
        skew_stats = runtime.cell_stats()
        deadline = time.perf_counter() + 30
        while runtime.migration_stats["docs_migrated"] == migrated0:
            check(time.perf_counter() < deadline,
                  f"{tag}: no doc migrated off the hot cell {mega_cell}: {runtime.migration_stats} "
                  f"work before {[s['work_units'] for s in stats_before]}, after {[s['work_units'] for s in skew_stats]}, "
                  f"now {[s['work_units'] for s in runtime.cell_stats()]}; fallbacks {h.fallbacks[:4]}")
            await asyncio.sleep(0.05)
        await h.until_hydrated()
        await h.until_converged("after the migrations")
        rounds["skew"] = time.perf_counter() - t0

        # the late cell: its canary sleeps past the deadline until the
        # breaker opens; a round runs while its docs are on the CPU path
        h.window = "late"
        late = (mega_cell + 1) % MULTI_CELLS
        sup = ext.supervisor
        late_plane = cells[late].plane
        on_time_probe = late_plane.canary_probe
        sleep_s = sup.canary_deadline * MULTI_LATE_DEADLINES

        def late_probe():
            time.sleep(sleep_s)
            return on_time_probe()

        late_docs = sorted(name for name in cells[late]._docs)
        t0 = time.perf_counter()
        late_plane.canary_probe = late_probe
        deadline = time.perf_counter() + 60
        while not (sup.cell_breakers and sup.cell_breakers[late].state == "open"
                   and sup.cell_states[late] == STATE_DEGRADED):
            check(time.perf_counter() < deadline, f"{tag}: the late cell's breaker never opened: {sup.snapshot()}")
            await asyncio.sleep(0.01)
        degrade_seconds = time.perf_counter() - t0
        check(late not in runtime.placement.healthy and lanes[late].paused,
              f"{tag}: the late cell still places docs or admits")
        # the rebalancer may have moved some of its docs off just before
        check(not cells[late]._docs, f"{tag}: the late cell still serves {len(cells[late]._docs)} docs")
        moved_off = [name for name in late_docs if runtime.is_served(name)]
        check(sup.state == STATE_READY, f"{tag}: the supervisor left READY: {sup.state}")
        opened = [i for i, b in enumerate(sup.cell_breakers) if b.state != "closed"]
        check(opened == [late], f"{tag}: breakers not closed: {opened}")
        t_round = time.perf_counter()
        await edit_round("late cell")
        rounds["late cell"] = time.perf_counter() - t_round
        late_plane.canary_probe = on_time_probe
        t_restore = time.perf_counter()
        deadline = time.perf_counter() + 60
        while True:
            placed_late = [name for name in names if runtime.placement.place(name) == late]
            if (sup.cell_states[late] == STATE_READY and sup.cell_breakers[late].state == "closed"
                    and placed_late and all(runtime.is_served(name) for name in placed_late)):
                break
            check(time.perf_counter() < deadline,
                  f"{tag}: the late cell never came back: {sup.snapshot().get('cells')} "
                  f"{sum(not runtime.is_served(n) for n in placed_late)} of its docs unserved")
            await asyncio.sleep(0.01)
        restore_seconds = time.perf_counter() - t_restore
        breaker_transitions = dict(sup.cell_breakers[late].transitions)
        check(all(b.state == "closed" for b in sup.cell_breakers), f"{tag}: a breaker is open after the restore")
        check(sup.state == STATE_READY, f"{tag}: the supervisor left READY: {sup.state}")

        h.window = "last"
        t0 = time.perf_counter()
        await edit_round("last round")
        rounds["last round"] = time.perf_counter() - t0
        joiners, joiner_joins = await h.join(names, 1)
        groups = {name: editors[name] + joiners[name] for name in names}
        await h.until_converged("the joiners", groups)
        await h.until_idle("the last round")
        h.note_hydrated()
    counts.on = False
    await watcher
    check(all(not p.has_unsynced_changes for group in editors.values() for p in group),
          f"{tag}: an editor's edit was never acknowledged")
    launches = counts.wrapper_launches()
    k1_ops = [cell.plane.counters["flush_slow_ops"] - base[i]["flush_slow_ops"] for i, cell in enumerate(cells)]
    append_ops = [cell.plane.counters["flush_fast_ops"] - base[i]["flush_fast_ops"] for i, cell in enumerate(cells)]
    fallback_total = sum(cell.plane.counters["cpu_fallbacks"] - base[i]["cpu_fallbacks"]
                         for i, cell in enumerate(cells))
    migration_cpu = sum(cell.plane.residency_stats.get("migration_cpu_snapshots", 0) for cell in cells)
    attributed = collections.Counter()
    unattributed = []
    for i, name, when, _migrating, reason in h.fallbacks:
        if when == "late" and i == late:
            attributed["late_cell"] += 1
        elif name == mega and reason == "capacity":
            attributed["mega_capacity"] += 1
        else:
            unattributed.append((i, name, when, reason))
    attributed["migration_snapshots"] = migration_cpu
    # /metrics: the cells' labelled gauges against their books, at rest
    status, text = await scrape(metrics, "/metrics")
    books = runtime.cell_stats()
    check(status == 200, f"{tag}: /metrics answered {status}")
    series = parse_prometheus(text, f"{tag} /metrics")
    gauge_mismatch = []
    # a card cell's device bytes are the card's allocator total, which the
    # watchdog's canaries move between the scrape and the books: there
    # the gauges must agree with each other (one card), on the CPU with
    # the books (arena and staging bytes)
    on_card = cells[0].plane.device.type == "cuda"
    books_keys = [("hocuspocus_tpu_cell_docs", "docs"), ("hocuspocus_tpu_cell_rows_in_use", "rows_in_use"),
                  ("hocuspocus_tpu_cell_pending_ops", "pending_ops"),
                  ("hocuspocus_tpu_cell_work_units", "work_units")]
    if not on_card:
        books_keys.append(("hocuspocus_tpu_cell_hbm_bytes", "hbm_bytes"))
    hbm_gauges = []
    for stat in books:
        labels = (("cell", str(stat["cell"])), ("device", stat["device"]))
        hbm_gauges.append(series.get(("hocuspocus_tpu_cell_hbm_bytes", labels)))
        for family, key in books_keys:
            if series.get((family, labels)) != float(stat[key]):
                gauge_mismatch.append((family, stat["cell"], series.get((family, labels)), stat[key]))
    if on_card and (len(set(hbm_gauges)) != 1 or not hbm_gauges[0]):
        gauge_mismatch.append(("hocuspocus_tpu_cell_hbm_bytes", "all", hbm_gauges, "one card's total"))
    # every doc served from a cell, its served bytes rebuilding it (the
    # mega doc where it outgrew its row: its CPU document, held above)
    rebuilt, served_by = await h.rebuild(names, skip={mega} if attributed["mega_capacity"] else ())
    lanes_out = []
    for i, lane in enumerate(lanes):
        lanes_out.append({k: lane.counters[k] - lane0[i].get(k, 0)
                          for k in ("admissions", "dispatches_in_lane", "dispatches_bypass", "deferrals")})
    h.note_hydrated()
    migrations = h.migrations
    out = {
        "ready_seconds": round(ready_seconds, 3),
        "setup_seconds": round(setup_seconds, 3),
        "round_seconds": {k: round(v, 3) for k, v in rounds.items()},
        "seconds": round(time.perf_counter() - started, 3),
        "edit_observe": {k: percentiles_ms(c.samples) for k, c in clocks.items()},
        "join_synced_editors": percentiles_ms(editor_joins),
        "join_synced_joiners": percentiles_ms(joiner_joins),
        "mega": {"doc": mega, "cell": mega_cell, "inserts": mega_inserts, "units": list(mega_units)},
        "work_before_skew": [s["work_units"] for s in stats_before],
        "work_after_skew": [s["work_units"] for s in skew_stats],
        "migrations": {
            "docs": len(migrations),
            "in_skew_round": sum(m["window"] == "skew" for m in migrations),
            "moves": [(m["doc"], m["src"], m["dst"]) for m in migrations[:16]],
            "seconds": h.migration_ms(),
            "stats": dict(runtime.migration_stats),
        },
        "late_cell": {
            "cell": late, "docs": len(late_docs), "migrated_off_before_the_trip": len(moved_off),
            "sleep_s": sleep_s,
            "degrade_seconds": round(degrade_seconds, 3), "restore_seconds": round(restore_seconds, 3),
            "breaker_transitions": breaker_transitions, "placed_docs_served": len(placed_late),
        },
        "supervisor": {"state": ext.supervisor.state, "counters": dict(ext.supervisor.counters)},
        "cpu_fallbacks": {"total": fallback_total, **attributed, "unattributed": unattributed[:8],
                          "unattributed_count": len(unattributed)},
        "client_closes": dict(h.closes),
        "integrate_launches": launches,
        **counts.by_cell(MULTI_CELLS),
        "k1_ops": {str(i): k1_ops[i] for i in range(MULTI_CELLS)},
        "append_ops": {str(i): append_ops[i] for i in range(MULTI_CELLS)},
        "lanes": lanes_out,
        "gauge_mismatch": gauge_mismatch,
        "hbm_gauges": hbm_gauges,
        "rebuilt": rebuilt,
        "served_by_cell": {str(i): served_by[i] for i in range(MULTI_CELLS)},
        "utilization_spread": runtime.utilization_spread(),
        "per_device_latency": runtime.per_device_latency(),
        "phase_offsets_ms": [cell.phase_offset_ms for cell in cells],
        "placement_hash": runtime.placement.placement_hash(),
        "counters": [{k: cell.plane.counters[k] for k in (
            "cpu_fallbacks", "docs_retired_capacity", "docs_retired_unsupported", "docs_evicted",
            "docs_hydrated", "docs_compacted", "plane_broadcasts", "sync_serves",
            "flush_fast_ops", "flush_slow_ops")} for cell in cells],
    }
    h.destroy(editors, joiners)
    await asyncio.sleep(0)
    await core.hooks("on_destroy", Payload(instance=core))
    return out


def phase_multi_device_server(rng, num_docs, capacity, cuts):
    """Per-device merge cells on the card (run_multi_device_server), with
    its checks: every doc byte-identical across its editors, its joiner
    and the server after each round, and served from a cell whose bytes
    rebuild it; K1 launched with ops of its own on every cell, each launch
    counted under the cell whose flush or canary made it, none outside,
    the cells' counts adding up to the wrapper's; each lane admitted only
    its cell's work (no bypass) and at least as often as its cell flushed;
    at least one doc migrated in the skew round, nothing acknowledged
    lost, no client-visible close; the late cell's breaker opened and
    closed and no other; every CPU fallback attributed to the late cell's
    window, a migration or the mega doc's row; the /metrics cell gauges
    equal to the cells' books. Then cell 0's biggest integrate batch is
    replayed through the kernel and the plain version. Returns
    (launches, max_abs_err of the replay)."""
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    recorder = Recorder(mp, *ARENAS["unit"]["wrap"])
    recorder.cell = 0
    out = asyncio.run(run_multi_device_server(rng, num_docs, capacity, recorder=recorder))
    launches = check_multi_device(out, num_docs, cuts, on_card=True)
    err = phase_served_replay(recorder.best, "unit", path="multi_device_server")
    recorder.best = recorder.before = None
    return launches, err


def check_multi_device(out, num_docs, cuts, on_card) -> int:
    """The multi_device_server phase's line and gates; the wrapper's
    launches. On the CPU (`on_card` False) the plain version integrates,
    so no launch is counted and the launch gates are left out."""
    tag = "multi_device_server"
    launches = sum(out["integrate_launches"].values())
    emit(
        tag,
        gpu=nvidia_smi_line() if on_card else None,
        config="BASELINE config 2's Y.Text edits through the CLI's --tpu-serve --tpu-devices 4 "
               "deployment (tests/tpu/test_multi_device.py's cell plane)",
        arena="unit",
        docs=num_docs,
        cells=MULTI_CELLS,
        rows=MULTI_ROWS,
        rebalance=MULTI_REBALANCE,
        cuts=cuts,
        **out,
    )
    for i in map(str, range(MULTI_CELLS)):
        check(out["k1_ops"][i] > 0, f"{tag}: no op integrated through K1 on cell {i}")
        check(out["lanes"][int(i)]["dispatches_bypass"] == 0, f"{tag}: cell {i}'s dispatches bypassed its lane")
        check(out["lanes"][int(i)]["dispatches_in_lane"] > 0, f"{tag}: cell {i} dispatched nothing in its lane")
        check(out["lanes"][int(i)]["admissions"] >= out["cell_flushes"][i],
              f"{tag}: cell {i} flushed {out['cell_flushes'][i]} times on {out['lanes'][int(i)]['admissions']} "
              "admissions of its lane")
        if on_card:
            check(out["cell_launches"][i] > 0, f"{tag}: K1 never launched in cell {i}'s flushes")
    check(out["launches_outside_flush"] == 0,
          f"{tag}: {out['launches_outside_flush']} K1 launches outside every cell's flush and canary")
    check(sum(out["cell_launches"].values()) + sum(out["canary_launches"].values()) == launches,
          f"{tag}: the cells' launches {out['cell_launches']} + canaries {out['canary_launches']} "
          f"do not add up to the wrappers' {launches}")
    if on_card:
        check(launches > 0, f"{tag}: K1 never launched from the cells")
    check(out["migrations"]["in_skew_round"] >= 1, f"{tag}: no doc migrated in the skew round")
    check(not out["client_closes"], f"{tag}: client-visible closes: {out['client_closes']}")
    late = out["late_cell"]
    check(late["breaker_transitions"].get("closed->open", 0) >= 1
          and late["breaker_transitions"].get("half_open->closed", 0) >= 1,
          f"{tag}: the late cell's breaker did not open and close: {late}")
    check(out["supervisor"]["state"] == "ready", f"{tag}: the supervisor ended {out['supervisor']['state']}")
    fallbacks = out["cpu_fallbacks"]
    check(fallbacks["unattributed_count"] == 0, f"{tag}: CPU fallbacks outside the late cell and migrations: "
                                                f"{fallbacks}")
    check(fallbacks["total"] == fallbacks.get("late_cell", 0) + fallbacks.get("mega_capacity", 0)
          + fallbacks["migration_snapshots"], f"{tag}: CPU fallbacks do not add up: {fallbacks}")
    check(not out["gauge_mismatch"], f"{tag}: /metrics cell gauges differ from the books: {out['gauge_mismatch']}")
    expected = num_docs - (1 if fallbacks.get("mega_capacity") else 0)
    check(out["rebuilt"] == expected, f"{tag}: {out['rebuilt']} of {expected} docs rebuilt from their cells")
    return launches


# -- the fleet autoscaler over per-device cells (--fleet-autoscale) ----------

FLEET_DOCS = 1024
FLEET_CELLS = 4
FLEET_SPARES = 2
# a cell's rows: 1,024 docs on 2 active cells read occupancy 0.25 / 0.85 =
# 0.29, under the down threshold; on 1 cell 0.59, over the projection
# guard's 0.55, so the controller's floor is 2 cells
FLEET_ROWS = 2048
FLEET_EDITORS = 2
FLEET_JOIN_CHUNK = 64
# diurnal_autoscale's day (hocuspocus_tpu/loadgen/scenarios.py:730-800):
# each phase's share of the peak edit rate
FLEET_DIURNAL = (("trough", 1 / 8), ("ramp_up", 1 / 2), ("peak", 1.0), ("ramp_down", 1 / 4),
                 ("night", 1 / 8))
# edits a second at the peak, spread over every open doc: the highest of
# 512, 448 and 384 at which the overload ladder held GREEN through the
# peak on an H100 machine (FLEET_CUTS["day"])
FLEET_PEAK_RATE = 384.0
FLEET_PHASE_S = 8.0
FLEET_NIGHT_MAX_S = 60.0  # night runs until the scale-down parked its cell, at most this
# the peak runs until every cell active in it has integrated ops through
# K1 (a spare activated late in it has had fresh docs to serve), at most this
FLEET_PEAK_MAX_S = 20.0
# daytime sessions that open new docs: this many docs a second, each with
# FLEET_EDITORS editors and a first word, through these phases; placement
# sends about 1/N of them to each active cell, so an activated spare loads
FLEET_FRESH_RATE = 16.0
FLEET_FRESH_PHASES = ("ramp_up", "peak")
# dispatched insert units a second that read as one loaded cell: the peak
# must read at least 1.0 a cell on 2 active cells, the trough under 0.35
# on 3 (derivation in FLEET_CUTS["work_target"])
FLEET_WORK_TARGET = 550.0
# the CLI's --fleet-* flags at a smoke cadence, cooldown 3 ticks; the
# floor at 2 cells (FLEET_CUTS["min_cells"])
FLEET_CONTROLLER = {"interval_s": 0.5, "hold_ticks": 2, "cooldown_ticks": 3, "min_cells": 2,
                    "warm_spares": FLEET_SPARES, "up_threshold": 0.75, "down_threshold": 0.35}
# the controller's holds that end a night: its signal settled, no streak
# or cooldown running
FLEET_SETTLED = ("survivors_too_hot", "at_min_cells", "in_band")
# diurnal_autoscale's slow rebalancer sweep
FLEET_REBALANCE = {"rebalance_interval_s": 1.0, "rebalance_ratio": 2.0, "rebalance_min_units": 256.0}
FLEET_SUPERVISOR = {**SUPERVISOR_DEFAULTS, "init_timeout": 60.0}
# the interval at which the phase moves the collector's survivors to its
# permanent generation (run_fleet_server)
FLEET_FREEZE_S = 1.0
FLEET_CUTS = {
    "docs": "1k docs as config 2, 2 editors a doc (10 clients in config 2), joined 64 docs at a time; "
            "16 more docs a second opened through ramp_up and the peak",
    "devices": "4 cells wrapped onto the one card the machine has, each with its own lane",
    "cadence": "the CLI's --fleet-interval 2 s cut to 0.5 s, --fleet-hold-ticks 3 to 2; the tick "
               "loop runs from listen, as the CLI's does",
    "min_cells": "--fleet-min-cells 2, the loaded floor (1,024 docs on 1 cell read 0.59, over the "
                 "projection guard): with 1 the loop parked cell 0 over the empty fleet at boot, "
                 "every doc loaded onto one cell, and its lane depth held the ladder at BROWNOUT-1/2 "
                 "through the peak at 512, 384 and 256 edits/s, which parks the controller",
    "day": "diurnal_autoscale's five phases, 8 s each (the peak until every cell active in it has "
           "integrated ops through K1, at most 20 s; night until the scale-down parked, at most "
           "60 s), at 1/8, 1/2, 1, 1/4, 1/8 of a peak cut from 512 to 384 edits/s: at 512 and 448 "
           "the overload ladder left GREEN for BROWNOUT-1 on lane_depth (8 waiters over the "
           "active cells' lanes, a flush and a sync serve each) and parked the controller",
    "work_target": "550 insert units/s a cell: the peak's config 2 edits dispatched 2.93 units "
                   "each on the card, so the 384/s peak reads 1.02 a cell on 2 active cells and the "
                   "48/s trough (3.66 units an edit) 0.11 a cell on 3",
    "gc": "the 2,560 clients live in the server's process: the earlier phases' garbage is collected "
          "before the ladder samples, then every 1 s the survivors move to the collector's permanent "
          "generation (gc.freeze), so a full collection walks the last second's objects, not every "
          "client's document; automatic collection stays on",
}


async def run_fleet_server(rng, num_docs, capacity, device=None, recorder=None, rows=FLEET_ROWS,
                           chunk=FLEET_JOIN_CHUNK, peak_rate=FLEET_PEAK_RATE, phase_s=FLEET_PHASE_S,
                           night_max_s=FLEET_NIGHT_MAX_S, work_target=FLEET_WORK_TARGET,
                           fresh_rate=FLEET_FRESH_RATE, peak_max_s=FLEET_PEAK_MAX_S):
    """The CLI's `--tpu-serve --tpu-devices 4 --fleet-autoscale
    --fleet-warm-spares 2 --metrics` deployment in process: the port's
    core with `Metrics`, `OverloadExtension` (the CLI's default ladder),
    `SupervisedTpuMergeExtension(devices=4)` (no `device`: the card; unit
    arena, `rows` rows a cell) and `FleetControllerExtension` at
    FLEET_CONTROLLER's cadence, its tick loop started by the core's
    `on_listen` as the CLI's is; the rebalancer at diurnal_autoscale's
    slow sweep.

    The controller boots with the last two cells parked. Each doc has
    FLEET_EDITORS editors, joined `chunk` docs at a time, and starts with
    one word. Then diurnal_autoscale's day: each phase paces config 2's
    edits at its share of `peak_rate` over random open docs for `phase_s`
    seconds (the peak until every cell active in it has integrated ops
    through K1, at most `peak_max_s`; night until a scale-down of
    ramp_down or night parked its cell and the controller holds
    settled, at most `night_max_s`), every
    insert timed to the doc's other editor, every doc converged after the
    phase. Through ramp_up and the peak fresh sessions open
    `fresh_rate` new docs a second, each with its editors and a first
    word, which placement spreads over the active cells, an activated
    spare among them. Then a fresh joiner a doc. From the first phase on
    each K1 launch is counted under the cell whose flush or canary made
    it (CellLaunches); every decision is logged with the ladder's rung at
    its tick, every actuation timed from the decision to the cell parked
    or active with the migrations it made, every migration from its
    start to the doc hydrated on its target; each CPU fallback is
    attributed to a migration or not; every 0.1 s the active cells, the
    rung and the docs of each cell are sampled. Returns the phase's
    numbers."""
    from hocuspocus_tpu_torch.fleet import FleetControllerExtension
    from hocuspocus_tpu_torch.observability import Metrics, get_profiler
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.overload import RUNG_NAMES, OverloadExtension, get_overload_controller
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import SupervisedTpuMergeExtension
    from hocuspocus_tpu_torch.tpu.scheduler import CLASS_CANARY, reset_device_lane
    from hocuspocus_tpu_torch.tpu.supervisor import STATE_INITIALIZING, STATE_READY

    tag = "fleet_server"
    reset_device_lane()
    overload = get_overload_controller()
    overload.reset()
    # The harness's clients live in the server's process (a deployment's
    # clients are browsers), and a gen-2 collection that walks their
    # documents paused the loop for 0.1-0.5 s on an H100 machine's host:
    # the ladder reads each pause as loop lag and leaves GREEN, which
    # parks the controller, and one full collection of an earlier phase's
    # garbage during the joins took it to RED, which refuses the joins.
    # So the earlier phases' garbage is collected here, before the ladder
    # samples, and from here on the sampler moves what survives to the
    # collector's permanent generation every FLEET_FREEZE_S (gc.freeze):
    # automatic collection stays on, and a full collection walks what the
    # last interval made instead of every client's document. Each phase's
    # collections and rungs are reported.
    gc.collect()
    gc.freeze()
    started = time.perf_counter()
    ext = SupervisedTpuMergeExtension(
        devices=FLEET_CELLS, num_docs=rows, capacity=capacity, serve=True, arena="unit",
        **FLEET_SUPERVISOR, **FLEET_REBALANCE,
        **({} if device is None else {"device": device}),
    )
    profiler = get_profiler().configure(hz=PROFILE_HZ)
    metrics = Metrics(**METRICS_DEFAULTS)
    fleet = FleetControllerExtension(**FLEET_CONTROLLER, work_target=work_target)
    core = Hocuspocus(Configuration(quiet=True, extensions=[
        metrics, OverloadExtension(hold_s=2.0, retry_after_s=1.0), ext, fleet,
    ]))
    # every decision but a hold, with the ladder's rung at its tick; every
    # actuation from its decision to the cell active or parked. Installed
    # before listen starts the tick loop: each tick reads these attributes
    h = None
    window = lambda: "boot" if h is None else h.window  # noqa: E731
    decisions, rung_ticks, actuations = [], collections.Counter(), []
    real_tick = fleet.tick_once

    async def logged_tick(cells_in=None):
        rung = RUNG_NAMES[overload.rung]
        decision = await real_tick(cells_in)
        rung_ticks[rung] += 1
        if decision.get("action") != "hold":
            decisions.append({**decision, "rung": rung, "phase": window(),
                              "t_s": round(time.perf_counter() - started, 3)})
        return decision

    fleet.tick_once = logged_tick
    for action in ("scale_up", "scale_down"):
        real_do = getattr(fleet, f"_do_{action}")

        async def timed_do(index, real_do=real_do, action=action):
            t0 = time.perf_counter()
            first_move = len(h.migrations) if h is not None else 0
            await real_do(index)
            cell = ext.runtime.cells[index]
            entry = {"action": action, "cell": index, "phase": window(),
                     "seconds": round(time.perf_counter() - t0, 3),
                     "moves": list(range(first_move, len(h.migrations) if h is not None else 0)),
                     "docs_left": len(cell._docs)}
            if action == "scale_down":
                # the parked cell's lane admissions from here on
                entry["admissions"] = list(cell.lane.class_admissions)
            actuations.append(entry)

        setattr(fleet, f"_do_{action}", timed_do)
    await core.ensure_configured()
    await core.hooks("on_listen", Payload(instance=core, configuration=core.configuration, port=None))
    deadline = time.perf_counter() + 180
    while ext.supervisor.state != STATE_READY:
        check(ext.supervisor.state == STATE_INITIALIZING,
              f"{tag}: the supervisor is {ext.supervisor.state}: {ext.health_status()}")
        check(time.perf_counter() < deadline, f"{tag}: the cells never attached")
        await asyncio.sleep(0.02)
    runtime = ext.runtime
    cells = runtime.cells
    check(len(cells) == FLEET_CELLS, f"{tag}: {len(cells)} cells")
    # the controller adopts the supervised runtime at its first read and
    # parks the warm spares then, before any doc loads; the first scaling
    # decision needs two ticks after that
    h = CellHarness(tag, core, runtime, chunk)
    check(fleet.plane is runtime, f"{tag}: the controller did not adopt the cell plane")
    boot = {"timeline": [dict(entry) for entry in fleet.timeline]}
    counts = CellLaunches(cells, recorder)
    spares = list(range(FLEET_CELLS - FLEET_SPARES, FLEET_CELLS))

    # samples every 0.1 s, by window: active cells, the ladder's rung, the
    # docs each cell serves, and any parked cell that holds docs
    samples = collections.defaultdict(lambda: {"active": [], "rungs": collections.Counter(),
                                               "docs": [], "healthy": set(), "queued": (0, {})})
    parked_with_docs = []
    sampling = asyncio.Event()

    async def sample():
        ticks = 0
        while not sampling.is_set():
            ticks += 1
            if ticks % round(FLEET_FREEZE_S / 0.1) == 0:
                gc.freeze()
            bucket = samples[h.window]
            healthy = set(runtime.placement.healthy)
            docs = [len(cell._docs) for cell in cells]
            bucket["active"].append(len(healthy))
            bucket["rungs"][RUNG_NAMES[overload.rung]] += 1
            bucket["docs"].append(docs)
            bucket["healthy"] |= healthy
            # the lanes' waiters (the ladder's lane_depth), by site: the
            # phase keeps its deepest sample
            queued = collections.Counter(f"{i}:{w.site}" for i, cell in enumerate(cells)
                                         for w in list(cell.lane._waiters))
            if sum(queued.values()) > bucket["queued"][0]:
                bucket["queued"] = (sum(queued.values()), dict(queued))
            parked_with_docs.extend((h.window, i, docs[i]) for i in range(FLEET_CELLS)
                                    if i not in healthy and docs[i] and not h.migrating)
            h.note_hydrated()
            await asyncio.sleep(0.1)

    sampler = asyncio.ensure_future(sample())
    for cell in cells:
        await cell.warmup_task
        check(cell.plane.compile_watch.warmed, f"{tag}: a cell's warm grid did not finish")
    ready_seconds = time.perf_counter() - started
    names = [f"fleet-{i}" for i in range(num_docs)]
    editors, editor_joins = await h.join(names, FLEET_EDITORS)
    h.editors = editors
    boot["docs_on_spares"] = sum(len(cells[i]._docs) for i in spares if i not in runtime.placement.healthy)
    await h.first_words(names)
    setup_seconds = time.perf_counter() - started

    def peak_done() -> bool:
        for i in samples["peak"]["healthy"]:
            if cells[i].plane.counters["flush_slow_ops"] == base[i]["flush_slow_ops"]:
                return False
            if cells[i].plane.device.type == "cuda" and not counts.flush_launches[i]:
                return False
        return True

    def night_done() -> bool:
        downs = [a for a in actuations if a["action"] == "scale_down"
                 and a["phase"] in ("ramp_down", "night")]
        last = fleet.controller.last_decision or {}
        return bool(downs) and downs[-1]["cell"] not in runtime.placement.healthy and (
            last.get("action") == "hold" and last.get("reason") in FLEET_SETTLED)

    clocks, phases = {}, []
    base = [{k: cell.plane.counters[k] for k in ("flush_fast_ops", "flush_slow_ops", "cpu_fallbacks")}
            for cell in cells]
    lane0 = [dict(cell.lane.counters) for cell in cells]
    # the loop's stalls: each loop-lag sample the ladder reads at 60 ms or
    # more (its BROWNOUT-1 threshold), each collection's pause, and the
    # loop thread's sampled stacks a phase
    lags = []
    started_day = time.perf_counter()

    def note_lag(lag_ms):
        if lag_ms >= 60.0:
            lags.append((round(time.perf_counter() - started_day, 3), h.window, round(lag_ms, 1)))

    overload.on_loop_lag.append(note_lag)
    seams = HostSeams()
    gc.callbacks.append(seams.collected)
    profiles = {}
    profiler.reset()
    counts.start()
    recording = recorder if recorder is not None else contextlib.nullcontext()
    live = list(names)  # the docs the day edits: the first 1,024 and each fresh one once it has its word
    fresh_names, fresh_joins, openings = [], [], []

    current = {}  # the running phase's EditClock

    async def open_fresh(batch) -> None:
        """Fresh sessions: `batch` new docs with their editors, each given
        a first word once synced (timed on the phase running then), then
        edited with the rest. The day does not wait for them: a join
        still open at a phase's end carries into the next."""
        group_by_doc, waits = await h.join(batch, FLEET_EDITORS)
        fresh_joins.extend(waits)
        clock = current["clock"]
        for d, name in enumerate(batch):
            group = group_by_doc[name]
            for p in group:
                clock.watch(p)
            editors[name] = group
            group[0].document.get_text("t").insert(0, WORDS[d % len(WORDS)])
            clock.expect(group[1], group[0])
            live.append(name)

    with recording, counts.counted():
        for phase, share in FLEET_DIURNAL:
            h.window = phase
            rate = peak_rate * share
            clock = current["clock"] = clocks[phase] = EditClock(asyncio.Event())
            for group in editors.values():
                for p in group:
                    clock.watch(p)
            units0 = [cell.plane.dispatched_total for cell in cells]
            t0 = time.perf_counter()
            sent = inserts = opened = 0
            behind_s = 0.0
            while True:
                elapsed = time.perf_counter() - t0
                if elapsed >= phase_s and (
                        (phase == "peak" and (peak_done() or elapsed >= peak_max_s))
                        or (phase == "night" and (night_done() or elapsed >= night_max_s))
                        or phase not in ("peak", "night")):
                    break
                if phase in FLEET_FRESH_PHASES:
                    batch = [f"fleet-day-{len(fresh_names) + j}"
                             for j in range(int(elapsed * fresh_rate) + 1 - opened)]
                    if batch:
                        fresh_names.extend(batch)
                        opened += len(batch)
                        openings.append(asyncio.ensure_future(open_fresh(batch)))
                due = int(elapsed * rate) + 1
                behind_s = max(behind_s, (due - sent - 1) / rate)
                while sent < due:
                    name = live[int(rng.integers(0, len(live)))]
                    k = int(rng.integers(0, FLEET_EDITORS))
                    group = editors[name]
                    if _server_edit(rng, group[k].document.get_text("t")):
                        clock.expect(group[(k + 1) % len(group)], group[k])
                        inserts += 1
                    sent += 1
                await asyncio.sleep(max(0.0, min((sent / rate) - (time.perf_counter() - t0), 0.05)))
            seconds = time.perf_counter() - t0
            profiles[phase] = profile_tops(profiler.collapsed(), roots=("MainThread",))["MainThread"]
            phase_gc = seams.summary()
            seams.reset()
            profiler.reset()
            units = [cell.plane.dispatched_total - units0[i] for i, cell in enumerate(cells)]
            await asyncio.wait_for(clock.idle.wait(), 300)
            await h.until_converged(f"after {phase}")
            bucket = samples[phase]
            phases.append({
                "phase": phase, "rate": rate, "seconds": round(seconds, 3), "edits": sent,
                "inserts": inserts, "kept_rate": round(sent / seconds, 1),
                "behind_ms_max": round(behind_s * 1e3, 1), "units": units,
                "units_per_edit": round(sum(units) / max(sent, 1), 3),
                "docs_opened": opened,
                "active_mean": round(float(np.mean(bucket["active"])), 3) if bucket["active"] else None,
                "active_cells": sorted(bucket["healthy"]),
                "rungs": dict(bucket["rungs"]),
                "lane_waiters_max": {"total": bucket["queued"][0], "by_cell_site": bucket["queued"][1]},
                "docs_max": [max(d[i] for d in bucket["docs"]) for i in range(FLEET_CELLS)]
                if bucket["docs"] else None,
                "gc": phase_gc,
                "loop_lags": sum(1 for lag in lags if lag[1] == phase),
            })
        await asyncio.gather(*openings)
        await h.until_converged("the fresh sessions")
        h.window = "joiners"
        all_names = names + fresh_names
        joiners, joiner_joins = await h.join(all_names, 1)
        groups = {name: editors[name] + joiners[name] for name in all_names}
        await h.until_converged("the joiners", groups)
        await h.until_idle("the joiners")
        await h.until_hydrated()
    counts.on = False
    sampling.set()
    await sampler
    gc.callbacks.remove(seams.collected)
    overload.on_loop_lag.remove(note_lag)
    check(all(not p.has_unsynced_changes for group in editors.values() for p in group),
          f"{tag}: an editor's edit was never acknowledged")
    launches = counts.wrapper_launches()
    k1_ops = [cell.plane.counters["flush_slow_ops"] - base[i]["flush_slow_ops"] for i, cell in enumerate(cells)]
    append_ops = [cell.plane.counters["flush_fast_ops"] - base[i]["flush_fast_ops"] for i, cell in enumerate(cells)]
    fallback_total = sum(cell.plane.counters["cpu_fallbacks"] - base[i]["cpu_fallbacks"]
                         for i, cell in enumerate(cells))
    migration_cpu = sum(cell.plane.residency_stats.get("migration_cpu_snapshots", 0) for cell in cells)
    in_migration = sum(1 for f in h.fallbacks if f[3])
    outside = [f[:3] for f in h.fallbacks if not f[3]]
    # each cell parked at the end, its lane after its last park: canaries only
    parked_lanes = []
    last_parks = {a["cell"]: a for a in actuations if a["action"] == "scale_down"}
    for entry in last_parks.values():
        if entry["cell"] not in runtime.placement.healthy:
            now = list(cells[entry["cell"]].lane.class_admissions)
            grown = [now[c] - entry["admissions"][c] for c in range(len(now)) if c != CLASS_CANARY]
            parked_lanes.append({"cell": entry["cell"], "admitted_after_park": sum(grown),
                                 "canaries_after_park": now[CLASS_CANARY] - entry["admissions"][CLASS_CANARY],
                                 "docs": len(cells[entry["cell"]]._docs)})
    # /debug/fleet and the autoscale families against the controller's
    # own status, all read between two of its ticks
    for _attempt in range(20):
        status = json.loads(json.dumps(fleet.status()))
        code, body = await scrape(metrics, "/debug/fleet")
        check(code == 200, f"{tag}: /debug/fleet answered {code}")
        view = json.loads(body).get("autoscale")
        code, text = await scrape(metrics, "/metrics")
        check(code == 200, f"{tag}: /metrics answered {code}")
        if json.loads(json.dumps(fleet.status())) == status:
            break
    series = parse_prometheus(text, f"{tag} /metrics")
    counters = status["counters"]
    expected = {
        ("hocuspocus_fleet_autoscale_active_cells", ()): float(len(status["roster"]["active"])),
        ("hocuspocus_fleet_autoscale_parked", ()): 1.0 if status["parked"] else 0.0,
        ("hocuspocus_fleet_autoscale_signal", ()): float(status["signal"] or 0.0),
        ("hocuspocus_fleet_autoscale_migrations_total", ()): float(status["actuation"]["docs_migrated"]),
        ("hocuspocus_fleet_autoscale_decisions_total", (("action", "scale_up"),)): float(counters["scale_ups"]),
        ("hocuspocus_fleet_autoscale_decisions_total", (("action", "scale_down"),)): float(counters["scale_downs"]),
    }
    gauge_mismatch = []
    for key, want in expected.items():
        got = series.get(key, 0.0 if key[0].endswith("_total") else None)
        if got is None or (round(got, 4) if "signal" in key[0] else got) != want:
            gauge_mismatch.append((key, got, want))
    view_matches = view == status
    # every doc served from a cell, its served bytes rebuilding it
    rebuilt, served_by = await h.rebuild(all_names)
    lanes_out = [{k: cell.lane.counters[k] - lane0[i].get(k, 0)
                  for k in ("admissions", "dispatches_in_lane", "dispatches_bypass", "deferrals")}
                 for i, cell in enumerate(cells)]
    night = next(p for p in phases if p["phase"] == "night")
    out = {
        "ready_seconds": round(ready_seconds, 3),
        "setup_seconds": round(setup_seconds, 3),
        "seconds": round(time.perf_counter() - started, 3),
        "boot": boot,
        "spares": spares,
        "docs_total": len(all_names),
        "phases": phases,
        "edit_observe": {k: percentiles_ms(c.samples) for k, c in clocks.items()},
        "join_synced_editors": percentiles_ms(editor_joins),
        "join_synced_fresh": percentiles_ms(fresh_joins),
        "join_synced_joiners": percentiles_ms(joiner_joins),
        "decisions": decisions,
        "rung_ticks": dict(rung_ticks),
        "left_green": [{"phase": p["phase"], "rate": p["rate"],
                        "rungs": {r: n for r, n in p["rungs"].items() if r != "green"}}
                       for p in phases if set(p["rungs"]) - {"green"}],
        "loop_lags": lags[:40],
        "loop_lags_count": len(lags),
        "loop_profile": profiles,
        "actuations": [{k: v for k, v in a.items() if k not in ("moves", "admissions")}
                       | {"docs_migrated": len(a["moves"]), "evict_hydrated": h.migration_ms(a["moves"])}
                       for a in actuations],
        "migrations": {"docs": len(h.migrations),
                       "by_window": dict(collections.Counter(m["window"] for m in h.migrations)),
                       "evict_hydrated": h.migration_ms(), "stats": dict(runtime.migration_stats)},
        "parked_lanes": parked_lanes,
        "parked_with_docs": parked_with_docs[:8],
        "parked_with_docs_count": len(parked_with_docs),
        "timeline": list(status["timeline"]),
        "controller": {k: status[k] for k in ("counters", "actuation", "thresholds", "bounds", "signal")},
        "footprint_ratio": None if night["active_mean"] is None else round(night["active_mean"] / FLEET_CELLS, 4),
        "peak_active": sorted(samples["peak"]["healthy"]),
        "supervisor": {"state": ext.supervisor.state, "counters": dict(ext.supervisor.counters)},
        "cpu_fallbacks": {"total": fallback_total, "in_migrations": in_migration,
                          "migration_snapshots": migration_cpu, "outside": outside[:8],
                          "outside_count": len(outside)},
        "client_closes": dict(h.closes),
        "integrate_launches": launches,
        **counts.by_cell(FLEET_CELLS),
        "k1_ops": {str(i): k1_ops[i] for i in range(FLEET_CELLS)},
        "append_ops": {str(i): append_ops[i] for i in range(FLEET_CELLS)},
        "lanes": lanes_out,
        "gauge_mismatch": gauge_mismatch,
        "debug_fleet_matches": view_matches,
        "rebuilt": rebuilt,
        "served_by_cell": {str(i): served_by[i] for i in range(FLEET_CELLS)},
        "counters": [{k: cell.plane.counters[k] for k in (
            "cpu_fallbacks", "docs_retired_capacity", "docs_evicted", "docs_hydrated",
            "plane_broadcasts", "sync_serves", "flush_fast_ops", "flush_slow_ops")} for cell in cells],
    }
    h.destroy(editors, joiners)
    await asyncio.sleep(0)
    await core.hooks("on_destroy", Payload(instance=core))
    profiler.stop()
    overload.reset()
    gc.unfreeze()
    gc.collect()
    return out


def phase_fleet_server(rng, num_docs, capacity, cuts):
    """The fleet autoscaler on the card (run_fleet_server) with its checks
    (check_fleet), then cell 0's biggest integrate batch replayed through
    the kernel and the plain version. Returns (launches, max_abs_err)."""
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    recorder = Recorder(mp, *ARENAS["unit"]["wrap"])
    recorder.cell = 0
    out = asyncio.run(run_fleet_server(rng, num_docs, capacity, recorder=recorder))
    launches = check_fleet(out, num_docs, cuts, on_card=True)
    err = phase_served_replay(recorder.best, "unit", path="fleet_server")
    recorder.best = recorder.before = None
    return launches, err


def check_fleet(out, num_docs, cuts, on_card) -> int:
    """The fleet_server phase's line and gates: the controller booted with
    the two warm spares parked, no doc placed on them, and no parked cell
    held a doc at any sample outside a migration; a scale-up in ramp_up or
    peak; a scale-down in ramp_down or night that migrated docs off its
    cell under the edits, and the last such cell parked at the end,
    holding no doc, its lane admitting only canaries after the park; no
    scaling decision off GREEN and every park naming its rung; nothing
    acknowledged lost (the phase converged every doc after each phase and
    held every editor acknowledged), no client-visible close; K1
    launched with ops of its own on every cell active in the peak, each
    launch counted under its cell, none outside, the cells' counts adding
    up to the wrapper's; no CPU fallback outside a migration; /debug/fleet
    and the autoscale families equal to the controller's status; every
    doc rebuilt from its served bytes. On the CPU (`on_card` False) no
    launch is counted. Returns the wrapper's launches."""
    tag = "fleet_server"
    launches = sum(out["integrate_launches"].values())
    emit(
        tag,
        gpu=nvidia_smi_line() if on_card else None,
        config="BASELINE config 2's Y.Text edits through the CLI's --tpu-serve --tpu-devices 4 "
               "--fleet-autoscale --fleet-warm-spares 2 deployment, diurnal_autoscale's day",
        arena="unit",
        docs=num_docs,
        cells=FLEET_CELLS,
        rows=FLEET_ROWS,
        controller_flags=FLEET_CONTROLLER,
        rebalance=FLEET_REBALANCE,
        cuts=cuts,
        **out,
    )
    boot = out["boot"]["timeline"]
    check(boot and boot[0]["action"] == "boot" and boot[0]["active"] == [0, 1],
          f"{tag}: the controller did not boot with cells 2 and 3 parked: {out['boot']}")
    check(out["boot"]["docs_on_spares"] == 0, f"{tag}: docs placed on the warm spares: {out['boot']}")
    check(out["parked_with_docs_count"] == 0, f"{tag}: parked cells held docs: {out['parked_with_docs']}")
    actions = [(a["action"], a["phase"]) for a in out["actuations"]]
    check(any(a == "scale_up" and p in ("ramp_up", "peak") for a, p in actions),
          f"{tag}: no scale-up in ramp_up or peak: {out['decisions']}")
    late_downs = [a for a in out["actuations"] if a["action"] == "scale_down" and a["phase"] in ("ramp_down", "night")]
    check(late_downs, f"{tag}: no scale-down in ramp_down or night: {out['decisions']}")
    check(any(a["docs_migrated"] > 0 for a in late_downs),
          f"{tag}: no scale-down in ramp_down or night migrated a doc: {late_downs}")
    parked = {lane["cell"]: lane for lane in out["parked_lanes"]}
    check(late_downs[-1]["cell"] in parked,
          f"{tag}: the last scale-down's cell is not parked at the end: {out['actuations']}")
    lane = parked[late_downs[-1]["cell"]]
    check(lane["docs"] == 0, f"{tag}: the parked cell still holds {lane['docs']} docs")
    for lane in out["parked_lanes"]:
        check(lane["admitted_after_park"] == 0,
              f"{tag}: parked cell {lane['cell']}'s lane admitted work after the park: {lane}")
    for decision in out["decisions"]:
        if decision["action"] in ("scale_up", "scale_down"):
            check(decision["rung"] == "green", f"{tag}: a scaling decision off GREEN: {decision}")
        if decision["action"] == "park":
            check(decision["reason"] == f"brownout:{decision['rung']}",
                  f"{tag}: a park does not name the ladder's rung: {decision}")
    check(not out["client_closes"], f"{tag}: client-visible closes: {out['client_closes']}")
    for i in map(str, out["peak_active"]):
        check(out["k1_ops"][i] > 0, f"{tag}: no op integrated through K1 on cell {i}")
        if on_card:
            check(out["cell_launches"][i] > 0, f"{tag}: K1 never launched in cell {i}'s flushes")
    for i, lane in enumerate(out["lanes"]):
        check(lane["dispatches_bypass"] == 0, f"{tag}: cell {i}'s dispatches bypassed its lane")
    check(out["launches_outside_flush"] == 0,
          f"{tag}: {out['launches_outside_flush']} K1 launches outside every cell's flush and canary")
    check(sum(out["cell_launches"].values()) + sum(out["canary_launches"].values()) == launches,
          f"{tag}: the cells' launches {out['cell_launches']} + canaries {out['canary_launches']} "
          f"do not add up to the wrappers' {launches}")
    if on_card:
        check(launches > 0, f"{tag}: K1 never launched from the cells")
    check(out["cpu_fallbacks"]["outside_count"] == 0,
          f"{tag}: CPU fallbacks outside the migrations: {out['cpu_fallbacks']}")
    check(not out["gauge_mismatch"], f"{tag}: the autoscale families differ from status(): {out['gauge_mismatch']}")
    check(out["debug_fleet_matches"], f"{tag}: /debug/fleet's autoscale section differs from status()")
    check(out["docs_total"] >= num_docs and out["rebuilt"] == out["docs_total"],
          f"{tag}: {out['rebuilt']} of {out['docs_total']} docs rebuilt from their cells")
    check(out["supervisor"]["state"] == "ready", f"{tag}: the supervisor ended {out['supervisor']['state']}")
    check(out["controller"]["actuation"]["failures"] == 0, f"{tag}: actuations failed: {out['controller']}")
    return launches


# -- Tiptap docs behind the CLI's persistence stack (BASELINE configs 3 and 1) --

TIPTAP_ROUNDS = 2
TIPTAP_BURST = 100  # single-character inserts in one ProseMirror transaction
TIPTAP_CHECKPOINTS = 8  # docs History checkpoints after round 1
TIPTAP_RESTORES = 2  # of them, restored after round 2
TIPTAP_SECRET = "chip-smoke-webhook-secret"
TIPTAP_DOCS = 512
TIPTAP_CUTS = {"docs": "10k docs cut to 512 (to 1,024 before the CLI and loadgen phases)",
               "rounds": "2 rounds"}
# every sequence of a doc's XML tree takes an arena row (the fragment, the
# heading and its text, the paragraph and its text): the plane has eight
# rows per doc, as the JAX package's config 3 bench sizes it
# (benchmarks/config3_prosemirror_transform.py `num_docs * 8`)
TIPTAP_ROWS_PER_DOC = 8


def make_pm_doc(i: int) -> dict:
    """The Tiptap document of BASELINE config 3's bench
    (benchmarks/config3_prosemirror_transform.py `make_pm_doc`)."""
    return {
        "type": "doc",
        "content": [
            {"type": "heading", "attrs": {"level": 1}, "content": [{"type": "text", "text": f"Document {i}"}]},
            {
                "type": "paragraph",
                "content": [
                    {"type": "text", "text": "Some "},
                    {"type": "text", "text": "bold", "marks": [{"type": "bold"}]},
                    {"type": "text", "text": " rich text content with enough length "},
                    {
                        "type": "text",
                        "text": "and a link",
                        "marks": [{"type": "link", "attrs": {"href": f"https://x.test/{i}"}}],
                    },
                ],
            },
        ],
    }


class WebhookReceiver:
    """The CMS end of the Webhook extension, in process (aiohttp): checks
    every request's `X-Hocuspocus-Signature-256` against its own HMAC,
    answers each `create` with `{"default": make_pm_doc(i)}` for doc
    `tiptap-i`, and keeps each doc's last `change` payload."""

    def __init__(self, secret: str) -> None:
        self.secret = secret.encode()
        self.requests = collections.Counter()
        self.bad_signatures = 0
        self.last_change: dict = {}
        self.runner = None
        self.url = ""

    async def start(self) -> "WebhookReceiver":
        from aiohttp import web

        app = web.Application()
        app.router.add_post("/", self.handle)
        self.runner = web.AppRunner(app, access_log=None)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        self.url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}/"
        return self

    async def handle(self, request):
        import hashlib
        import hmac

        from aiohttp import web

        body = await request.read()
        want = "sha256=" + hmac.new(self.secret, body, hashlib.sha256).hexdigest()
        if request.headers.get("X-Hocuspocus-Signature-256") != want:
            self.bad_signatures += 1
            return web.Response(status=403)
        message = json.loads(body)
        event, payload = message["event"], message["payload"]
        self.requests[event] += 1
        if event == "create":
            index = int(payload["documentName"].rsplit("-", 1)[1])
            return web.json_response({"default": make_pm_doc(index)})
        if event == "change":
            self.last_change[payload["documentName"]] = payload["document"]
        return web.json_response({})

    async def stop(self) -> None:
        await self.runner.cleanup()


def _paragraph_text(doc):
    """The paragraph's text node of a config 3 doc (the XML tree's
    `default` fragment: heading, then paragraph)."""
    return doc.get_xml_fragment("default").get(1).get(0)


async def run_tiptap_server(rng, num_docs, capacity, rounds=TIPTAP_ROUNDS, burst=TIPTAP_BURST,
                            device="cuda", recorder=None, webhook_debounce_ms=2000):
    """BASELINE configs 3 and 1 through the served plane: one port
    Hocuspocus core with Logger, SQLite (a file in a fresh temporary
    directory), Webhook (the in-process WebhookReceiver, events create and
    change), History and TpuMergeExtension(serve=True, arena="rle") on
    `device`, a writer and a reader of each doc on in-process sockets.
    Every doc loads through `Webhook.on_load_document`: the receiver's
    Tiptap JSON, through the transformer. Each round every writer sends
    one transaction of `burst` single-character inserts at drawn
    positions of the paragraph's text (one Yjs update per ProseMirror
    transaction) and the reader's `from_ydoc` must equal the writer's.
    History checkpoints TIPTAP_CHECKPOINTS docs after round 1 and restores
    TIPTAP_RESTORES of them after round 2. Then every provider leaves,
    every doc unloads (SQLite stores it) and a wave of one joiner per doc
    reloads each from SQLite onto the plane. The kernel launch counts are
    set to 0 once every doc is loaded and read after the reload wave.
    Returns the phase's numbers."""
    import contextlib
    import sqlite3

    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_as_update
    from hocuspocus_tpu_torch.extensions import Events, History, Logger, SQLite, Webhook
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket
    from hocuspocus_tpu_torch.server import Configuration, Hocuspocus
    from hocuspocus_tpu_torch.server.types import Payload
    from hocuspocus_tpu_torch.tpu import TpuMergeExtension
    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane
    from hocuspocus_tpu_torch.transformer import TiptapTransformer

    reset_device_lane()
    seams = HostSeams()
    asyncio.get_running_loop().set_default_executor(_TimedExecutor(seams))
    started = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="tiptap-server-")
    database = os.path.join(workdir, "documents.sqlite")
    receiver = await WebhookReceiver(TIPTAP_SECRET).start()
    log_lines = collections.Counter()
    ext = TpuMergeExtension(
        num_docs=TIPTAP_ROWS_PER_DOC * num_docs, capacity=capacity, serve=True, arena="rle", device=device
    )
    sqlite = SQLite(database=database)
    webhook = Webhook(
        url=receiver.url, secret=TIPTAP_SECRET, events=[Events.onCreate, Events.onChange],
        debounce=webhook_debounce_ms,
    )
    stores = collections.Counter()
    store = sqlite.store

    async def counted_store(data):
        stores[data.document_name] += 1
        await store(data)

    sqlite.store = counted_store
    retries0 = sum(webhook.retries_total.value(event=e) for e in ("create", "change"))
    core = Hocuspocus(Configuration(quiet=True, extensions=[
        Logger(log=lambda line: log_lines.update([line.split("] ", 1)[1].split(" ", 1)[0]])),
        sqlite,
        webhook,
        History(),
        ext,
    ]))
    try:
        await core.ensure_configured()
        await core.hooks("on_listen", Payload(instance=core, configuration=core.configuration, port=None))
        await ext.warmup_task
        check(ext.plane.compile_watch.warmed, "tiptap_server: the warm grid did not finish")
        warm_seconds = time.perf_counter() - started
        plane = ext.plane
        cycles = []
        real_flush = plane.flush
        flush_wall, flush_cpu = seams.samples["flush_wall"], seams.samples["flush_cpu"]

        def timed_flush(max_batches=None):
            t0, c0 = time.perf_counter(), time.thread_time()
            count = real_flush(max_batches)
            wall = time.perf_counter() - t0
            flush_wall.append(wall)
            flush_cpu.append(time.thread_time() - c0)
            if count:
                cycles.append(wall)
            if recorder is not None:
                recorder.after_flush(plane.state)
            return count

        plane.flush = timed_flush
        names = [f"tiptap-{i}" for i in range(num_docs)]

        async def wave():
            """One provider per doc, each timed from creation to synced."""
            synced_at, providers = {}, []
            t0 = time.perf_counter()
            for name in names:
                provider = HocuspocusProvider(name=name, websocket_provider=InProcessProviderSocket(core))
                provider.on(
                    "synced",
                    lambda payload, p=provider: payload.get("state")
                    and synced_at.setdefault(p, time.perf_counter()),
                )
                provider.attach()
                providers.append(provider)
            await asyncio.wait_for(_all_synced(providers), 600)
            return providers, percentiles_ms([synced_at[p] - t0 for p in providers])

        writers, load_synced = await wave()
        readers, _ = await wave()
        for d, name in enumerate(names):
            check(TiptapTransformer.from_ydoc(writers[d].document, "default") == make_pm_doc(d),
                  f"tiptap_server: {name} did not load the receiver's document")
        await _converge_tiptap(writers, readers, time.perf_counter() + 300, "load")
        deadline = time.perf_counter() + 300
        while not all(ext.is_capturing(name) for name in names):
            docs = [plane.docs.get(name) for name in names if not ext.is_capturing(name)]
            check(time.perf_counter() < deadline,
                  f"tiptap_server: {len(docs)} docs not captured after load: "
                  f"{[(d.name, d.retired, d.retire_reason, d.lane_slot) if d else None for d in docs[:4]]}")
            await asyncio.sleep(0.02)
        setup_seconds = time.perf_counter() - started
        # where a CPU fallback happened, if one did
        fallbacks = {"load": plane.counters["cpu_fallbacks"]}

        dense_name, sparse_name = ARENAS["rle"]["wrap"]
        dense_fn, sparse_fn = getattr(ti, dense_name), getattr(ti, sparse_name)
        clock = EditClock(asyncio.Event())
        for reader in readers:
            clock.watch(reader)
        base = {k: plane.counters[k] for k in ("flush_fast_ops", "flush_slow_ops")}
        if recorder is not None:
            recorder.before = clone_state(plane.state)
        dense_fn.launches = sparse_fn.launches = 0
        seams.reset()
        gc.callbacks.append(seams.collected)
        traffic_started = time.perf_counter()
        checkpoints, restored = {}, []
        sampled = sorted(int(i) for i in rng.choice(num_docs, TIPTAP_CHECKPOINTS, replace=False))
        events: dict = {d: [] for d in sampled}
        for d in sampled:
            writers[d].on("stateless", lambda data, box=events[d]: box.append(json.loads(data["payload"])))
        recording = recorder if recorder is not None else contextlib.nullcontext()
        try:
            with recording:
                for round_index in range(rounds):
                    for d, writer in enumerate(writers):
                        text = _paragraph_text(writer.document)

                        def burst_edit(_tr, text=text):
                            for _ in range(burst):
                                text.insert(int(rng.integers(0, len(text) + 1)), "x")

                        writer.document.transact(burst_edit)
                        clock.expect(readers[d], writer)
                        if d % 16 == 15:
                            await asyncio.sleep(0)
                    await asyncio.wait_for(clock.idle.wait(), 300)
                    await _converge_tiptap(writers, readers, time.perf_counter() + 300, f"round {round_index}")
                    if round_index == 0:
                        for d in sampled:
                            checkpoints[d] = TiptapTransformer.from_ydoc(writers[d].document, "default")
                            writers[d].send_stateless(json.dumps({"action": "history.checkpoint"}))
                        await _history_events(events, "history.checkpointed", "tiptap_server checkpoints")
                traffic_seconds = time.perf_counter() - traffic_started
                fallbacks["rounds"] = plane.counters["cpu_fallbacks"]
                for d in sampled[:TIPTAP_RESTORES]:
                    version = next(e for e in events[d] if e.get("event") == "history.checkpointed")
                    writers[d].send_stateless(json.dumps({"action": "history.restore", "id": version["id"]}))
                    restored.append(d)
                await _history_events({d: events[d] for d in restored}, "history.restored",
                                      "tiptap_server restores")
                # the restore's transaction reaches both providers of the doc
                deadline = time.perf_counter() + 120
                while any(
                    TiptapTransformer.from_ydoc(p.document, "default") != checkpoints[d]
                    for d in restored for p in (writers[d], readers[d])
                ):
                    check(time.perf_counter() < deadline,
                          f"tiptap_server: {[names[d] for d in restored]} never restored their checkpoints")
                    await asyncio.sleep(0.02)
                await _converge_tiptap(writers, readers, time.perf_counter() + 300, "restores")
                deadline = time.perf_counter() + 120
                while plane.pending_ops() > 0 or ext._flush_inflight:
                    check(time.perf_counter() < deadline, "tiptap_server: the queues never drained")
                    await asyncio.sleep(0.005)
                integrated = sum(plane.counters[k] - base[k] for k in base)
                host_traffic = seams.summary()
                gc_traffic = _gc2_share(seams, traffic_seconds)
                # the webhook's debounced `change` posts carry each doc's last state
                deadline = time.perf_counter() + webhook_debounce_ms / 1e3 + 120
                while any(
                    (receiver.last_change.get(name) or {}).get("default")
                    != TiptapTransformer.from_ydoc(core.documents[name], "default")
                    for name in names
                ):
                    check(time.perf_counter() < deadline, "tiptap_server: change payloads never caught up")
                    await asyncio.sleep(0.05)
                fallbacks["restores"] = plane.counters["cpu_fallbacks"]
                served_before = {}
                for name in names:
                    served_before[name] = await _served_rebuild(core, name, "after the rounds")
                fallbacks["served"] = plane.counters["cpu_fallbacks"]
                # every provider leaves and every doc unloads: SQLite stores each
                stores_before = sum(stores.values())
                for p in writers + readers:
                    p.destroy()
                    p.websocket_provider.destroy()
                deadline = time.perf_counter() + 300
                while core.documents:
                    check(time.perf_counter() < deadline,
                          f"tiptap_server: {len(core.documents)} docs never unloaded")
                    await asyncio.sleep(0.02)
                unload_stores = sum(stores.values()) - stores_before
                seams.reset()
                fallbacks["unload"] = plane.counters["cpu_fallbacks"]
                reloaders, reload_synced = await wave()
                host_reload = seams.summary()
                fallbacks["reload"] = plane.counters["cpu_fallbacks"]
        finally:
            gc.callbacks.remove(seams.collected)
        launches = {dense_name: dense_fn.launches, sparse_name: sparse_fn.launches}
        db = sqlite3.connect(database)
        try:
            rows = dict(db.execute('SELECT name, data FROM "documents"').fetchall())
        finally:
            db.close()
        for d, name in enumerate(names):
            served_json, served_sv = await _served_rebuild(core, name, "after the reload")
            if (served_json, served_sv) != served_before[name]:
                stored = Doc()
                apply_update(stored, rows.get(name, b""))
                check(False, f"tiptap_server: {name} reloaded from SQLite as another doc: json "
                             f"{served_json == served_before[name][0]}, sv {served_sv!r} vs "
                             f"{served_before[name][1]!r}; the row holds the doc before the unload: "
                             f"{TiptapTransformer.from_ydoc(stored, 'default') == served_before[name][0]}; "
                             f"reloaded {served_json}; before {served_before[name][0]}")
            check(TiptapTransformer.from_ydoc(reloaders[d].document, "default") == served_json,
                  f"tiptap_server: {name}: the reload joiner holds another doc")
            check(rows.get(name) == encode_state_as_update(core.documents[name]),
                  f"tiptap_server: {name}: the SQLite row is not the reloaded doc's encoded state")
        counters = dict(plane.counters)
        served_docs = sum(ext.is_served(name) for name in names)
        for p in reloaders:
            p.destroy()
            p.websocket_provider.destroy()
        await core.hooks("on_destroy", Payload(instance=core))
        return {
            "warm_seconds": round(warm_seconds, 3),
            "setup_seconds": round(setup_seconds, 3),
            "traffic_seconds": round(traffic_seconds, 3),
            "seconds": round(time.perf_counter() - started, 3),
            "edit_observe_burst": percentiles_ms(clock.samples),
            "load_synced_webhook": load_synced,
            "reload_synced_sqlite": reload_synced,
            "ops_integrated": integrated,
            "ops_per_s": integrated / traffic_seconds if traffic_seconds else None,
            "flush_cycles": percentiles_ms(cycles),
            "integrate_launches": launches,
            "sqlite": {"stores": sum(stores.values()), "unload_stores": unload_stores, "rows": len(rows)},
            "webhook": {
                "posts": dict(receiver.requests),
                "retries": sum(webhook.retries_total.value(event=e) for e in ("create", "change"))
                - retries0,
                "bad_signatures": receiver.bad_signatures,
            },
            "history": {"checkpoints": len(checkpoints), "restores": len(restored)},
            "cpu_fallbacks_after": fallbacks,
            "logger_lines": dict(log_lines),
            "gc2_traffic": gc_traffic,
            "host_traffic": host_traffic,
            "host_reload": host_reload,
            "served_docs": served_docs,
            "counters": counters,
        }
    finally:
        await receiver.stop()
        shutil.rmtree(workdir, ignore_errors=True)


async def _converge_tiptap(writers, readers, deadline: float, what: str) -> None:
    from hocuspocus_tpu_torch.transformer import TiptapTransformer

    left = list(zip(writers, readers))
    while left:
        left = [
            (w, r) for w, r in left
            if TiptapTransformer.from_ydoc(r.document, "default")
            != TiptapTransformer.from_ydoc(w.document, "default")
        ]
        if not left:
            return
        check(time.perf_counter() < deadline, f"tiptap_server {what}: {len(left)} readers never converged")
        await asyncio.sleep(0.02)


async def _history_events(events: dict, name: str, what: str) -> None:
    deadline = time.perf_counter() + 120
    while not all(any(e.get("event") == name for e in box) for box in events.values()):
        errors = [e for box in events.values() for e in box if e.get("event") == "history.error"]
        check(not errors, f"{what}: {errors}")
        check(time.perf_counter() < deadline, f"{what}: no {name} for every doc")
        await asyncio.sleep(0.02)


async def _served_rebuild(core, name: str, what: str):
    """The plane's SyncStep2 for an empty state vector, rebuilt into a
    fresh doc: (its Tiptap JSON, its state vector); both must be the
    server document's."""
    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_vector
    from hocuspocus_tpu_torch.transformer import TiptapTransformer

    document = core.documents[name]
    check(document.sync_source is not None, f"tiptap_server: {name} left the plane {what}")
    served = await document.sync_source.encode_state_as_update_async(None)
    check(served is not None, f"tiptap_server: {name} was not served from the plane {what}")
    rebuilt = Doc()
    apply_update(rebuilt, served)
    as_json = TiptapTransformer.from_ydoc(rebuilt, "default")
    check(as_json == TiptapTransformer.from_ydoc(document, "default"),
          f"tiptap_server: {name}: served bytes rebuild another doc {what}")
    sv = encode_state_vector(rebuilt)
    check(sv == encode_state_vector(document), f"tiptap_server: {name}: another state vector {what}")
    return as_json, sv


def phase_tiptap_server(rng, num_docs, capacity, cuts):
    """Tiptap docs behind Logger, SQLite, Webhook and History on the
    run-length plane (run_tiptap_server), with its checks (the run's own,
    and: no CPU fallback, no unsupported retire, every doc served, every
    webhook signature good, K2 launched). Then the path's biggest
    integrate batch is replayed through the kernel and the plain version.
    Returns (launches, max_abs_err of the replay)."""
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    tag = "rle_tiptap_server"
    recorder = Recorder(mp, *ARENAS["rle"]["wrap"])
    out = asyncio.run(run_tiptap_server(rng, num_docs, capacity, recorder=recorder))
    counters = out["counters"]
    launches = sum(out["integrate_launches"].values())
    emit(
        tag,
        gpu=nvidia_smi_line(),
        config="BASELINE configs 3 and 1: Tiptap docs through the transformer behind SQLite, a "
               "webhook and History (benchmarks/config3_prosemirror_transform.py)",
        arena="rle",
        docs=num_docs,
        rows=TIPTAP_ROWS_PER_DOC * num_docs,
        capacity=capacity,
        rounds=TIPTAP_ROUNDS,
        burst=TIPTAP_BURST,
        cuts=cuts,
        **{k: v for k, v in out.items() if k != "counters"},
        plane_counters={k: counters[k] for k in (
            "cpu_fallbacks", "docs_retired_unsupported", "docs_retired_lane_demote",
            "plane_broadcasts", "sync_serves", "sync_cache_hits", "flush_fast_ops", "flush_slow_ops")},
    )
    check(counters["cpu_fallbacks"] == 0, f"{tag}: {counters['cpu_fallbacks']} CPU fallbacks")
    check(counters["docs_retired_unsupported"] == 0, f"{tag}: unsupported retires")
    check(out["served_docs"] == num_docs, f"{tag}: {out['served_docs']} of {num_docs} docs served")
    check(out["webhook"]["bad_signatures"] == 0, f"{tag}: {out['webhook']['bad_signatures']} bad signatures")
    check(launches > 0, f"{tag}: K2 never launched from the Tiptap path")
    err = phase_served_replay(recorder.best, "rle", path="tiptap_server")
    recorder.best = recorder.before = None
    return launches, err


# The compaction phases' stream: BASELINE config 2's random-position
# inserts and deletes, a doc's edits of a round in one transaction, deletes
# more likely as a doc's live text passes `live` units, so the rows fill
# with tombstones (unit arena: capacity counts units, so inserts are
# pastes of 10-60 words) or split runs (run-length arena: capacity counts
# entries, one or two a small edit) while the live text stays near a tenth
# of the row. COMPACT_TEMPLATES editing docs make the updates; doc i of the
# plane takes template i % COMPACT_TEMPLATES's.
COMPACT_STREAMS = {
    "unit": {"edits": 4, "live": 400, "words": (10, 61), "delete": (20, 201)},
    "rle": {"edits": 64, "live": 400, "words": (1, 6), "delete": (1, 5)},
}
COMPACT_TEMPLATES = 8
# the twin each arena's compaction phase holds the card plane against: a
# CPU plane (the unit arena's stream takes a batch or two a round), or on
# the run-length arena, whose rows take about 4,000 ops each to fill, a
# shadow arena on the card (_ShadowArena). A CPU twin there would run the
# plain integrate over the whole 1,024-row arena for some 800 batches,
# several seconds each on an 8-core host, and a second plane on the card
# would lower every update a second time on the host
COMPACT_TWINS = {"unit": "cpu", "rle": "shadow"}
# docs driven through each compaction phase (the arenas keep 1,024 rows):
# a run-length row takes ~4,000 Python-lowered ops to fill, ~6.9 million
# for 1,024 docs, the largest share of the smoke's time
COMPACT_DRIVEN = {"unit": 128, "rle": 64}
COMPACT_CUTS = {
    "unit": {"docs": "128 of the 1,024 rows' docs driven (1,024 before the Redis and Tiptap "
                     "phases joined the smoke, 512 before the CLI and loadgen phases)"},
    "rle": {"docs": "64 of the 1,024 rows' docs driven to retirement and back (1,024 before "
                    "Metrics and the WAL joined the supervised phases, 512 before the Redis and "
                    "Tiptap phases, 256 before the CLI and loadgen phases)"},
}


class _ShadowArena:
    """A twin arena for `plane` on its device: every step the plane
    launches (integrate, run append, compaction) is applied to this copy
    too, with the same inputs, through the plain PyTorch version. One host
    path (lowering, queues, logs, residency) feeds both, so the twin costs
    no second lowering; `serve` encodes a SyncStep2 from the copy."""

    def __init__(self, plane, plain_steps: dict) -> None:
        self.plane = plane
        self.state = clone_state(plane.state)
        for seam, plain in plain_steps.items():
            setattr(plane, seam, self._wrap(getattr(plane, seam), plain))

    def _wrap(self, real, plain):
        def factory():
            step = real()

            def run(state, *args):
                out = step(state, *args)
                plain(self.state, *args)  # in place, like the step
                return out

            return run

        return factory

    def serve(self, serving, name: str, document):
        plane = self.plane
        with plane._step_lock:
            check(plane.pending_ops() == 0, "shadow serve with ops queued")
            real, plane.state = plane.state, self.state
            try:
                return serving.encode_state_as_update(name, document)
            finally:
                plane.state = real
COMPACT_MAX_ROUNDS = 160
COMPACT_SERVE_SAMPLE = 8  # docs whose served bytes are compared after a flush


def _compact_edit(rng, text, stream) -> None:
    length = len(text)
    if length > 16 and rng.random() < min(0.95, length / stream["live"]):
        pos = int(rng.integers(0, length - 1))
        text.delete(pos, min(int(rng.integers(*stream["delete"])), length - pos))
    else:
        words = rng.integers(0, len(WORDS), int(rng.integers(*stream["words"])))
        text.insert(int(rng.integers(0, length + 1)), "".join(WORDS[w] for w in words))


def compact_bound(plane, rows: int) -> tuple[float, str, dict]:
    """The compaction program's least time for `rows` routed rows: each
    row's fields read once and written once (the routing vector and the
    packed sizes besides); the integer work is a few operations a lane,
    far under the bytes' time."""
    width = plane.capacity
    per_lane = RLE_BYTES_PER_ENTRY if plane.arena == "rle" else ROW_BYTES_PER_UNIT
    scalars = 9 if plane.arena == "rle" else 5  # per-row scalar bytes
    moved = 2 * rows * (per_lane * width + scalars) + 8 * rows
    return _bound(moved, 8 * rows * width)


async def run_compact_plane(rng, arena, num_docs, capacity, device="cuda", twin="cpu",
                            max_rounds=COMPACT_MAX_ROUNDS, driven=None):
    """MergePlane + PlaneServing + ResidencyManager(compact_threshold=0.75)
    on `device`, beside a twin: a CPU plane fed the same updates with a
    manager of its own (`twin="cpu"`), or a shadow arena on `device` that
    every step of the plane also updates through the plain PyTorch
    version (`twin="shadow"`, _ShadowArena). Each round every doc takes
    one update of the compaction stream, both flush, the arenas must be
    equal element for element and a rotating sample of docs must serve
    equal bytes from both, which rebuild the doc. A doc whose row passed
    capacity (host projection) or overflowed (the device flag, read by the
    health check) retires with its logs kept, and both managers recycle it
    through compact-and-replay; after every compaction the arenas are
    compared again. On the unit arena a compaction whose rebuilt serve log
    would not decode is declined (ResidencyManager._rebuild_decodable):
    the doc stays retired, on the CPU document, as the extension leaves it
    once the snapshot recycle finds no headroom either. A template's docs
    stop editing once each has compacted or declined; the rounds end when
    every doc has. `driven` docs (all `num_docs` by default) are
    registered and edited; the arenas keep `num_docs` rows. Returns the
    phase's numbers."""
    import torch

    from hocuspocus_tpu_torch.crdt import Doc, apply_update
    from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing, ResidencyManager
    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk
    from hocuspocus_tpu_torch.tpu import kernels_rle as tr

    tag = ARENAS[arena]["tag"] + "compact_plane"
    stream = COMPACT_STREAMS[arena]
    started = time.perf_counter()
    plane = MergePlane(num_docs=num_docs, capacity=capacity, arena=arena, device=device)
    compact_calls = []  # (routed rows, wall seconds) of the card plane's compaction launches
    real_compact = plane._compact_step_fn

    def counted_compact():
        program = real_compact()

        def run(state, slots):
            t0 = time.perf_counter()
            out = program(state, slots)
            compact_calls.append((int(slots.numel()), time.perf_counter() - t0))
            return out

        return run

    plane._compact_step_fn = counted_compact
    shadow = other = None
    if twin == "cpu":
        other = MergePlane(num_docs=num_docs, capacity=capacity, arena=arena, device="cpu")
        planes = (plane, other)
    else:
        module = tr if arena == "rle" else tk
        shadow = _ShadowArena(plane, {
            "_step_fn": module.integrate_op_slots_rle if arena == "rle" else tk.integrate_op_slots,
            "_sparse_step_fn": (
                tr.integrate_op_slots_rle_sparse if arena == "rle" else tk.integrate_op_slots_sparse
            ),
            "_append_step_fn": (
                tr.append_run_slots_rle_sparse if arena == "rle" else tk.append_run_slots_sparse
            ),
            "_compact_step_fn": tr.compact_doc_rows_rle if arena == "rle" else tk.compact_doc_rows,
        })
        planes = (plane,)
    servings = tuple(PlaneServing(p) for p in planes)
    managers = tuple(
        ResidencyManager(plane=p, serving=s, compact_threshold=0.75) for p, s in zip(planes, servings)
    )
    twin_serving = servings[1] if other is not None else PlaneServing(plane)

    def twin_state():
        return other.state if other is not None else shadow.state

    def serve_both(name, document):
        ours = servings[0].encode_state_as_update(name, document)
        if other is not None:
            return ours, twin_serving.encode_state_as_update(name, document)
        twin_serving.refresh()
        return ours, shadow.serve(twin_serving, name, document)

    names = [f"doc-{i}" for i in range(num_docs if driven is None else driven)]
    for p in planes:
        for name in names:
            p.register(name)
    templates, outboxes = [], []
    for _ in range(COMPACT_TEMPLATES):
        doc = Doc()
        doc.client_id = int(rng.integers(1, 2**32))
        box: list = []
        doc.on("update", lambda update, *rest, box=box: box.append(update))
        templates.append(doc)
        outboxes.append(box)
    dense_name, sparse_name = ARENAS[arena]["wrap"]
    dense_fn, sparse_fn = getattr(ti, dense_name), getattr(ti, sparse_name)
    dense_fn.launches = sparse_fn.launches = 0
    retires = {name: 0 for name in names}
    recycles = {name: 0 for name in names}
    declined = set()  # unit rows whose rebuild would not decode: left retired
    undecodable = {"n": 0}
    real_decodable = managers[0]._rebuild_decodable

    def decodable(doc, plans):
        ok = real_decodable(doc, plans)
        undecodable["n"] += not ok
        return ok

    managers[0]._rebuild_decodable = decodable

    def done(name) -> bool:
        return recycles[name] > 0 or name in declined

    decoded = {}  # served bytes -> the text they rebuild (a template's docs serve alike)

    def rebuilds(name, served, template) -> None:
        if served not in decoded:
            rebuilt = Doc()
            try:
                apply_update(rebuilt, served)
            except (KeyError, RuntimeError) as error:
                raise SmokeFailure(f"{tag}: {name}: a decoder refuses the served bytes ({error!r})")
            decoded[served] = rebuilt.get_text("t").to_string()
        check(decoded[served] == template.get_text("t").to_string(),
              f"{tag}: {name}: served bytes rebuild another text")

    compact_ms, flush_ms, arena_checks, serve_checks = [], [], 0, 0
    max_err = 0
    rounds = 0
    while not all(map(done, names)):
        check(rounds < max_rounds, f"{tag}: {sum(not done(n) for n in names)} docs never compacted")
        for t, doc in enumerate(templates):
            # a template's docs stop editing once each has compacted: on
            # the run-length arena a second or third refill of a row can
            # outgrow what the defragmenter reclaims
            if all(map(done, names[t::COMPACT_TEMPLATES])):
                continue
            doc.transact(
                lambda _tr, doc=doc: [
                    _compact_edit(rng, doc.get_text("t"), stream) for _ in range(stream["edits"])
                ]
            )
        for i, name in enumerate(names):
            for update in outboxes[i % COMPACT_TEMPLATES]:
                counts = [p.enqueue_update(name, update) for p in planes]
                check(counts[0] == counts[-1], f"{tag}: the planes lowered an update differently")
        for box in outboxes:
            box.clear()
        t0 = time.perf_counter()
        plane.flush()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        for p in planes[1:]:
            p.flush()
        for serving in servings:
            serving.refresh()
        check(states_equal(plane.state, twin_state()), f"{tag}: round {rounds}: the arenas differ")
        arena_checks += 1
        # the health check retires overflowed rows (logs kept for compaction)
        for name in names:
            healthy = [s.doc_healthy(name) is not None for s in servings]
            check(healthy[0] == healthy[-1], f"{tag}: {name}: the planes judged health differently")
        retired = [name for name in names if plane.docs[name].retired and name not in declined]
        check(retired == [name for name in names if planes[-1].docs[name].retired and name not in declined],
              f"{tag}: round {rounds}: the planes retired different docs")
        compacted = []
        for name in retired:
            retires[name] += 1
            check(plane.docs[name].retire_reason in ("capacity", "overflow"),
                  f"{tag}: {name} retired for {plane.docs[name].retire_reason}")
            template = templates[names.index(name) % COMPACT_TEMPLATES]
            results = []
            refused = undecodable["n"]
            for p, manager in zip(planes, managers):
                async with p.flush_lock:
                    results.append(await manager.compact_and_replay_locked(name, template))
            check(results[0] == results[-1], f"{tag}: {name}: the compactions disagree")
            if not results[0]:
                check(arena == "unit" and undecodable["n"] == refused + 1,
                      f"{tag}: {name}: compact-and-replay declined (round {rounds})")
                declined.add(name)
                continue
            compact_ms.append(plane.residency_stats["last_compaction_ms"])
            recycles[name] += 1
            compacted.append(name)
        if compacted:
            # the replays are queued: flush them, then hold the arenas
            for p in planes:
                p.flush()
            for serving in servings:
                serving.refresh()
            check(states_equal(plane.state, twin_state()), f"{tag}: after compaction the arenas differ")
            max_err = max(max_err, max_abs_err(plane.state, twin_state()))
            arena_checks += 1
        # a rotating sample, and a sample of the docs compacted this round
        # (the arenas were compared whole), whose bytes must rebuild them
        rotating = names[(rounds * COMPACT_SERVE_SAMPLE) % len(names):][:COMPACT_SERVE_SAMPLE]
        for name in rotating + compacted[:COMPACT_SERVE_SAMPLE]:
            if name in declined:
                continue  # on the CPU document
            template = templates[names.index(name) % COMPACT_TEMPLATES]
            replies = serve_both(name, template)
            check(replies[0] is not None and replies[0] == replies[1],
                  f"{tag}: {name}: served bytes differ (round {rounds})")
            if name in compacted:
                rebuilds(name, replies[0], template)
            serve_checks += 1
        rounds += 1
    launches = {dense_name: dense_fn.launches, sparse_name: sparse_fn.launches}
    # every doc at the end: on the plane, served equal bytes on both sides
    # that rebuild its text; or declined, still retired on both
    for i, name in enumerate(names):
        template = templates[i % COMPACT_TEMPLATES]
        if name in declined:
            check(plane.docs[name].retired and planes[-1].docs[name].retired,
                  f"{tag}: {name}: a declined doc came back")
            continue
        check(not plane.docs[name].retired, f"{tag}: {name} ended retired")
        replies = serve_both(name, template)
        check(replies[0] is not None and replies[0] == replies[1], f"{tag}: {name}: final serves differ")
        rebuilds(name, replies[0], template)
    # the compaction program's device time a launch at the path's shape
    # (one doc's row), CUDA events around the call, on a copy of the arena
    rows = compact_calls[0][0] if compact_calls else 1
    routed = torch.arange(rows, dtype=torch.int32, device=plane.device)
    program = real_compact()
    compact_device_ms = None
    if plane.device.type == "cuda":
        copy = Copies(plane.state, 1)
        compact_device_ms = event_ms(lambda: program(copy[0], routed), reps=9, setup=copy.reset)
        copy.clear()
    bound_ms, bound_by, bound_work = compact_bound(plane, rows)
    counters = dict(plane.counters)
    return {
        "twin": twin,
        "docs_driven": len(names),
        "rounds": rounds,
        "seconds": round(time.perf_counter() - started, 3),
        "docs_retired_at_least_once": sum(v > 0 for v in retires.values()),
        "retires": sum(retires.values()),
        "recycles": sum(recycles.values()),
        "compactions": counters["docs_compacted"],
        "compactions_declined": counters["compactions_declined"],
        "declined_undecodable": len(declined),
        "retired_now": sum(plane.docs[name].retired for name in names),
        "compact_ms": percentiles_ms(np.asarray(compact_ms) / 1e3),
        "compact_launches": len(compact_calls),
        "compact_routed_rows": rows,
        "compact_host_ms": percentiles_ms([w for _n, w in compact_calls]),
        "compact_device_ms": compact_device_ms,
        "compact_bound_ms": bound_ms,
        "compact_bound_by": bound_by,
        "compact_bound_work": bound_work,
        "flush": percentiles_ms(np.asarray(flush_ms) / 1e3),
        "arena_checks": arena_checks,
        "serve_checks": serve_checks,
        "max_abs_err": max_err,
        "integrate_launches": launches,
        "counters": {k: v for k, v in counters.items() if v},
    }


def phase_compact_plane(rng, arena, num_docs, capacity, twin, driven=None, cuts=None):
    """The self-compacting plane on the card (run_compact_plane), with its
    checks: every doc retired at least once and recycled through
    compact-and-replay, or on the unit arena declined because the rebuild
    would not decode (then it is the only kind of doc left retired), the
    arenas equal after every flush and every compaction, the served bytes
    equal and rebuilding each served doc. Returns (integrate launches,
    max_abs_err)."""
    tag = ARENAS[arena]["tag"] + "compact_plane"
    out = asyncio.run(run_compact_plane(rng, arena, num_docs, capacity, twin=twin, driven=driven))
    launches = sum(out["integrate_launches"].values())
    emit(
        tag,
        gpu=nvidia_smi_line(),
        config="BASELINE config 2's random-position insert/delete stream, deletes outweighing inserts",
        stream=COMPACT_STREAMS[arena],
        templates=COMPACT_TEMPLATES,
        arena=arena,
        docs=num_docs,
        capacity=capacity,
        compact_threshold=0.75,
        cuts=cuts or {},
        **out,
    )
    driven = out["docs_driven"]
    check(out["docs_retired_at_least_once"] == driven, f"{tag}: {out['docs_retired_at_least_once']} docs retired")
    declined = out["declined_undecodable"]
    check(arena == "unit" or declined == 0, f"{tag}: the run-length defragmenter declined")
    check(out["retired_now"] == declined, f"{tag}: {out['retired_now']} docs ended retired, {declined} declined")
    check(out["compactions"] >= driven - declined, f"{tag}: {out['compactions']} compactions")
    check(launches > 0, f"{tag}: the integrate kernel never launched")
    return launches, out["max_abs_err"]


# -- the port's entry points: the CLI in a process of its own, and loadgen -----

ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_DOCS_PER_SOCKET = 64  # docs multiplexed on one client websocket
CLI_PROVIDERS = 2  # editing providers a doc, each set on sockets of its own
CLI_DRAIN_TIMEOUT_S = 20.0  # the CLI's --drain-timeout-secs default
CLI_PROFILE_SECS = 3.0  # the server's /debug/profile capture, over the round
CLI_READY_S = 300.0  # a CLI process must answer /healthz READY within this
CLI_CUTS = {
    "providers": "2 editing providers a doc (10 in config 2), 1 late joiner, 1 fresh reader",
    "rounds": "1 round of one edit per provider",
}
# loadgen: the published scenarios, replication_lag widened to 1,024 docs
LOADGEN_SEED = 7
LOADGEN_DOCS_SCENARIO = "replication_lag"
# the schedules' hashes as the JAX package compiles them
# (tests/test_torch_smoke_phases.py holds these constants to it)
LOADGEN_HASHES = {
    ("smoke", None): "6ba1ee244d310ad46e5660213b8725400f0e02f5480f3944d13951af736a9eb6",
    ("replication_lag", 1024): "bb255b3a250b59ad056ab26e217d3d246efa40ce40715597eef8a887a99d9f32",
    ("edge_fanout", None): "2f3892d5fc975743c1ce22b196cd7417d138e303678f98742642d5afeb0999d0",
    ("edge_handoff", None): "04a7e2616a26fd07da5ccf943569bc7568aace596d32d91138276e29f37a48ab",
    ("multi_device_storm", None): "e52390f0efbb491c3268e5ed52151036cb11a2e6c1ac0bf218265cabc9fdb99b",
    ("mega_audience", None): "4b6cfc8bf10bbfbabe44dc74bc73877a323ebc7ab80d7f8107913381661d7f0f",
    ("diurnal_autoscale", None): "197b784d9577015b04511590db91a16084846b23b8de66b735a9ae88822c37d0",
}
# the edge scenarios, at their published defaults (2 edges, 2 cells, each
# cell's plane on the card), gated
LOADGEN_EDGE_SCENARIOS = ("edge_fanout", "edge_handoff")
# mega_audience at its defaults: three cell planes in one process on one
# card behind two edges, gated as the edge scenarios (its CPU fallbacks,
# the follower seams' CPU answers, reported)
LOADGEN_AUDIENCE_SCENARIOS = ("mega_audience",)
# per-device merge cells at multi_device_storm's published defaults: 24
# docs, 2 instances of 4 cells, so 8 cells in one process on one card
LOADGEN_MULTI_SCENARIOS = ("multi_device_storm",)
# diurnal_autoscale at its defaults: one instance of four cells under the
# fleet controller; verdict, footprint ratio, convergence and every
# acknowledged edit gated
LOADGEN_AUTOSCALE_SCENARIOS = ("diurnal_autoscale",)
LOADGEN_ACK_S = 120.0  # acknowledged edits must be observed on the other instance within this
LOADGEN_READERS_PER_CHUNK = 64  # fresh readers joining the other instance at once
LOADGEN_CUTS = {"docs": "replication_lag's 16 docs widened to 1,024 (its other parameters as published)"}


def free_port() -> int:
    """A free loopback port, picked as tests/server/test_cli.py picks it."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


class CliServer:
    """`python -m hocuspocus_tpu_torch.cli` in a process of its own on a
    free loopback port, its output in `log_path`."""

    def __init__(self, args, log_path: str) -> None:
        self.port = free_port()
        self.args = ["--host", "127.0.0.1", "--port", str(self.port), *args]
        self.log_path = log_path
        self.url = f"ws://127.0.0.1:{self.port}"
        self.http = f"http://127.0.0.1:{self.port}"
        self.process = None
        self._log = None
        self._session = None

    def tail(self, size: int = 3000) -> str:
        try:
            with open(self.log_path, "rb") as fh:
                return fh.read()[-size:].decode("utf-8", "replace")
        except OSError:
            return ""

    async def start(self, what: str) -> float:
        """Spawn and wait until /healthz reads the supervised plane READY;
        returns the seconds that took."""
        import aiohttp

        started = time.perf_counter()
        self._log = open(self.log_path, "ab")
        self.process = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "hocuspocus_tpu_torch.cli", *self.args,
            cwd=ROOT, stdout=self._log, stderr=subprocess.STDOUT,
        )
        self._session = aiohttp.ClientSession()
        while True:
            check(self.process.returncode is None,
                  f"{what}: the CLI exited with {self.process.returncode}: {self.tail()}")
            check(time.perf_counter() - started < CLI_READY_S,
                  f"{what}: the CLI was not READY within {CLI_READY_S} s: {self.tail()}")
            try:
                status, text = await self.get("/healthz")
                section = json.loads(text)["extensions"]["SupervisedTpuMergeExtension"]
                check(section["fault"] is None, f"{what}: the plane failed: {section['fault']}")
                if section["state"] == "ready":
                    return time.perf_counter() - started
            except (OSError, aiohttp.ClientError, KeyError, ValueError):
                pass
            await asyncio.sleep(0.2)

    async def get(self, path: str, **query) -> tuple:
        async with self._session.get(self.http + path, params=query) as response:
            return response.status, await response.text()

    async def stop(self, timeout: float) -> tuple:
        """SIGTERM (the graceful drain); returns (exit code, seconds to exit),
        the code None when the process outlived `timeout` (it is then killed)."""
        import signal

        started = time.perf_counter()
        self.process.send_signal(signal.SIGTERM)
        try:
            code = await asyncio.wait_for(self.process.wait(), timeout)
        except asyncio.TimeoutError:
            code = None
        seconds = time.perf_counter() - started
        await self.close()
        return code, seconds

    async def close(self) -> None:
        if self.process is not None and self.process.returncode is None:
            self.process.kill()
            await self.process.wait()
        if self._session is not None:
            await self._session.close()
            self._session = None
        if self._log is not None:
            self._log.close()
            self._log = None


def _open_providers(url, names, sockets, per_socket=CLI_DOCS_PER_SOCKET):
    """One provider a doc over HocuspocusProviderWebsockets, `per_socket`
    docs multiplexed on each (the sockets are appended to `sockets`)."""
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, HocuspocusProviderWebsocket

    providers = []
    for base in range(0, len(names), per_socket):
        socket = HocuspocusProviderWebsocket(url=url)
        sockets.append(socket)
        for name in names[base:base + per_socket]:
            provider = HocuspocusProvider(name=name, websocket_provider=socket)
            provider.attach()
            providers.append(provider)
    return providers


def _sync_clock(providers) -> list:
    """Each provider's seconds from now to its `synced` event (filled in
    as the events come)."""
    started = time.perf_counter()
    seconds = [None] * len(providers)
    for i, provider in enumerate(providers):
        def on_synced(payload, i=i):
            if payload.get("state") and seconds[i] is None:
                seconds[i] = time.perf_counter() - started
        provider.on("synced", on_synced)
    return seconds


async def _until(condition, deadline_s: float, message) -> float:
    started = time.perf_counter()
    while not condition():
        check(time.perf_counter() - started < deadline_s, message() if callable(message) else message)
        await asyncio.sleep(0.02)
    return time.perf_counter() - started


def _k1_launches(series) -> int:
    """K1 launches in a /metrics scrape: the device watch's launch series
    (first launches and repeats) of the integrate sites."""
    return int(sum(
        value for (name, labels), value in series.items()
        if name == "hocuspocus_tpu_compile_events_total"
        and dict(labels).get("site") in ("integrate_dense", "integrate_sparse")
    ))


def _plane_families() -> set:
    """The plane's counter families on /metrics, named from a CPU plane's books."""
    from hocuspocus_tpu_torch.tpu import MergePlane

    plane = MergePlane(num_docs=2, capacity=8, device="cpu")
    return {f"hocuspocus_tpu_plane_{key.removeprefix('plane_')}" for key in plane.counters} | {
        "hocuspocus_tpu_plane_ops_integrated",
        "hocuspocus_tpu_supervisor_state",
        "hocuspocus_tpu_compile_events_total",
        "hocuspocus_wal_appended_records",
    }


async def run_cli_server(rng, num_docs, device="cuda", arena="unit", providers=CLI_PROVIDERS,
                         profile_secs=CLI_PROFILE_SECS, drain_timeout_s=CLI_DRAIN_TIMEOUT_S,
                         extra_args=()):
    """The port's CLI as a user starts it: `python -m hocuspocus_tpu_torch.cli
    --tpu-serve --metrics --wal-dir D` at its defaults (the supervised unit
    plane at 1,024 x 4,096 unless `arena` says otherwise), in a process of
    its own, on `device`. The clients live here: `providers` editing
    providers a doc over the port's websocket provider, 64 docs a socket,
    each set on sockets of its own. One round of config 2's random-position
    edits, one a provider, under one /debug/profile capture of the server;
    a late joiner a doc; /metrics scraped over HTTP; SIGTERM's graceful
    drain; then a second CLI process on the same WAL directory serves every
    doc to a fresh provider. `extra_args` go to both CLI processes (a
    rehearsal's smaller plane). Every check raises SmokeFailure."""
    from hocuspocus_tpu_torch.crdt import encode_state_as_update
    from hocuspocus_tpu_torch.tpu.supervisor import STATE_CODES, STATE_READY

    tag = "cli_server"
    started = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    args = [
        "--tpu-serve", "--metrics", "--wal-dir", os.path.join(workdir, "wal"),
        "--tpu-arena", arena, "--tpu-device", device,
        "--drain-timeout-secs", str(drain_timeout_s), *extra_args,
    ]
    names = [f"cli-{i}" for i in range(num_docs)]
    sockets, everyone = [], []
    servers = [CliServer(args, os.path.join(workdir, "server-1.log")),
               CliServer(args, os.path.join(workdir, "server-2.log"))]
    first, second = servers
    try:
        boot_seconds = await first.start(tag)
        sets = [_open_providers(first.url, names, sockets) for _ in range(providers)]
        everyone = [p for group in sets for p in group]
        editors_synced = _sync_clock(everyone)
        await _until(lambda: all(p.synced for p in everyone), 600,
                     lambda: f"{tag}: {sum(not p.synced for p in everyone)} editors never synced")
        setup_seconds = time.perf_counter() - started

        clock = EditClock(asyncio.Event())
        for group in sets[:2]:
            for provider in group:
                clock.watch(provider)
        capture = asyncio.ensure_future(first.get("/debug/profile", secs=str(profile_secs)))
        round_started = time.perf_counter()
        edits = inserts = 0
        for d in range(num_docs):
            for j in range(providers):
                provider = sets[j][d]
                edits += 1
                if _server_edit(rng, provider.document.get_text("t")):
                    inserts += 1
                    clock.expect(sets[1 if j == 0 else 0][d], provider)
            if d % 16 == 15:
                await asyncio.sleep(0)
        await asyncio.wait_for(clock.idle.wait(), 300)
        await _until(lambda: not any(p.has_unsynced_changes for p in everyone), 120,
                     f"{tag}: edits never acknowledged")
        round_seconds = time.perf_counter() - round_started
        status, text = await capture
        check(status == 200, f"{tag}: /debug/profile answered {status}")
        profile = json.loads(text)
        check("error" not in profile, f"{tag}: /debug/profile: {profile.get('error')}")

        # a late joiner a doc; every doc's providers hold the same bytes
        joiners = _open_providers(first.url, names, sockets)
        joined = _sync_clock(joiners)
        await _until(lambda: all(p.synced for p in joiners), 300,
                     lambda: f"{tag}: {sum(not p.synced for p in joiners)} joiners never synced")
        expected = {}

        def converged() -> bool:
            for d, name in enumerate(names):
                states = {encode_state_as_update(group[d].document) for group in (*sets, joiners)}
                if len(states) != 1:
                    return False
                expected[name] = states.pop()
            return True

        await _until(converged, 120, f"{tag}: a doc's providers and joiner hold different bytes")

        # /metrics over HTTP: the plane's families, and every edit integrated
        families = _plane_families()
        scraped = {}

        async def scrape_first():
            status, text = await first.get("/metrics")
            check(status == 200, f"{tag}: /metrics answered {status}")
            scraped.update(parse_prometheus(text, f"{tag} /metrics"))
            return scraped.get(("hocuspocus_tpu_plane_ops_integrated", ()))

        deadline = time.perf_counter() + 60
        while await scrape_first() != edits:
            check(time.perf_counter() < deadline,
                  f"{tag}: /metrics ops integrated "
                  f"{scraped.get(('hocuspocus_tpu_plane_ops_integrated', ()))} for {edits} edits")
            await asyncio.sleep(0.2)
        listed = {name for name, _labels in scraped}
        check(families <= listed, f"{tag}: /metrics lacks {sorted(families - listed)}")
        check(scraped[("hocuspocus_tpu_supervisor_state", ())] == STATE_CODES[STATE_READY],
              f"{tag}: supervisor state {scraped[('hocuspocus_tpu_supervisor_state', ())]}")
        check(scraped[("hocuspocus_wal_appended_records", ())] >= edits,
              f"{tag}: the WAL appended {scraped[('hocuspocus_wal_appended_records', ())]} records")
        plane = {name.removeprefix("hocuspocus_tpu_plane_"): value
                 for (name, labels), value in scraped.items()
                 if name.startswith("hocuspocus_tpu_plane_") and not labels}
        check(plane["cpu_fallbacks"] == 0, f"{tag}: {plane['cpu_fallbacks']} CPU fallbacks")
        check(plane["broadcasts"] > 0, f"{tag}: no broadcast went through the plane")
        retired = {k: v for k, v in plane.items() if k.startswith("docs_retired_") and v}
        check(not retired, f"{tag}: docs retired {retired}")
        launches = {"first": _k1_launches(scraped)}

        for p in everyone + joiners:
            p.destroy()
        for socket in sockets:
            socket.destroy()
        sockets.clear()
        await asyncio.sleep(0.2)
        code, drain_seconds = await first.stop(drain_timeout_s + 10)
        check(code == 0, f"{tag}: after SIGTERM the CLI exited with {code}: {first.tail()}")
        check(drain_seconds <= drain_timeout_s,
              f"{tag}: the drain took {drain_seconds:.3f} s, over --drain-timeout-secs {drain_timeout_s}")

        # WAL replay through the entry point: a second process, fresh readers
        replay_started = time.perf_counter()
        reboot_seconds = await second.start(f"{tag} replay")
        readers = _open_providers(second.url, names, sockets)
        await _until(lambda: all(p.synced for p in readers), 300,
                     lambda: f"{tag}: {sum(not p.synced for p in readers)} readers never synced "
                             "after the restart")

        def replayed() -> list:
            return [p.name for p in readers if encode_state_as_update(p.document) != expected[p.name]]

        await _until(lambda: not replayed(), 60,
                     lambda: f"{tag}: {len(replayed())} docs served back other bytes after the restart")
        replay_seconds = time.perf_counter() - replay_started
        status, text = await second.get("/metrics")
        check(status == 200, f"{tag}: the second process's /metrics answered {status}")
        launches["replay"] = _k1_launches(parse_prometheus(text, f"{tag} replay /metrics"))
        for p in readers:
            p.destroy()
        for socket in sockets:
            socket.destroy()
        sockets.clear()
        await asyncio.sleep(0.2)
        code2, drain2_seconds = await second.stop(drain_timeout_s + 10)
        check(code2 == 0, f"{tag}: the second CLI exited with {code2}: {second.tail()}")
    except SmokeFailure as failure:
        notes = []
        for i, server in enumerate(servers):
            if server.process is None:
                continue
            health = None
            if server.process.returncode is None:
                try:
                    health = (await server.get("/healthz"))[1][:1500]
                except Exception as error:  # noqa: BLE001 - a note on a failure
                    health = repr(error)
            notes.append(f"server {i + 1}: /healthz {health}; log {server.tail()}")
        raise SmokeFailure(f"{failure}; {' | '.join(notes)}") from None
    finally:
        for socket in sockets:
            socket.destroy()
        for server in servers:
            await server.close()
        shutil.rmtree(workdir, ignore_errors=True)
    server_gc = profile["gc"]
    return {
        "seconds": round(time.perf_counter() - started, 3),
        "boot_seconds": round(boot_seconds, 3),
        "setup_seconds": round(setup_seconds, 3),
        "round_seconds": round(round_seconds, 3),
        "edits": edits,
        "inserts": inserts,
        "edit_observe": percentiles_ms(clock.samples),
        "editors_synced": percentiles_ms([s for s in editors_synced if s is not None]),
        "join_synced": percentiles_ms([s for s in joined if s is not None]),
        "drain_seconds": round(drain_seconds, 3),
        "replay": {"boot_seconds": round(reboot_seconds, 3), "seconds": round(replay_seconds, 3),
                   "docs": len(expected), "drain_seconds": round(drain2_seconds, 3)},
        "server_profile": {"seconds": profile["seconds"], "gc": server_gc,
                           "device_events": profile["device_events"],
                           "device_activity_names": len(profile["kernels"]),
                           "integrate_kernels": sorted({
                               match.group(0) for match in map(
                                   re.compile(r"integrate\w*kernel").search, profile["kernels"])
                               if match})},
        "server_gc2_share": server_gc["gen2"]["share"],
        "plane_counters": {k: plane[k] for k in (
            "broadcasts", "cpu_fallbacks", "sync_serves", "sync_cache_hits",
            "flush_fast_ops", "flush_slow_ops", "flush_batches_dense", "flush_batches_sparse")},
        "ops_integrated": edits,
        "k1_launches": launches,
        "metrics_series": len(scraped),
    }


def phase_cli_server(rng, num_docs, cuts):
    """The CLI's default deployment through its entry point (run_cli_server).
    The server is another process, so the kernel is held to its plain
    version through what it serves: every doc byte-identical across its
    providers and joiner, and again after the WAL replay in a second
    process (max_abs_err 0 only then; any difference fails the phase). K1's
    launches are the servers' own /metrics (the device watch's integrate
    launch series). Returns (launches, max_abs_err)."""
    import torch

    torch.cuda.empty_cache()  # the earlier phases' arenas, before another process takes the card
    out = asyncio.run(run_cli_server(rng, num_docs))
    launches = sum(out["k1_launches"].values())
    emit(
        "cli_server",
        gpu=nvidia_smi_line(),
        config="BASELINE config 2: 1k Y.Text docs, random-position insert/delete, through "
               "`python -m hocuspocus_tpu_torch.cli --tpu-serve --metrics --wal-dir D` at its defaults",
        arena="unit",
        docs=num_docs,
        capacity=4096,
        docs_per_socket=CLI_DOCS_PER_SOCKET,
        cuts=cuts,
        k1_launches_from="the servers' /metrics: hocuspocus_tpu_compile_events_total, sites "
                         "integrate_dense and integrate_sparse, kinds compile and hit",
        max_abs_err=0,
        **out,
    )
    check(launches > 0, "cli_server: the servers' /metrics show no K1 launch")
    return launches, 0


def acked_runner(schedule, device):
    """The port's ScenarioRunner, with one check added before the
    population is torn down: every writer's edits must be acknowledged,
    every sampled doc's reader must hold its writer's bytes, and with two
    instances every other doc too, read by a fresh provider on the other
    instance (it loads the doc there, whose Redis join fetches the
    writer's instance's state): every acknowledged edit of every doc is
    observed on the other instance (`runner.acked`)."""
    from hocuspocus_tpu_torch.crdt import encode_state_as_update
    from hocuspocus_tpu_torch.loadgen import ScenarioRunner
    from hocuspocus_tpu_torch.provider import HocuspocusProvider, InProcessProviderSocket

    class Runner(ScenarioRunner):
        acked = None
        convergence = None

        async def _teardown(self):
            try:
                harness = self.harness
                if harness.servers:
                    if harness.edges > 0:
                        # writers and sampled readers, on different edges
                        self.convergence = await self._check_convergence()
                    await self._acknowledged(harness)
                    if len(harness.servers) == 1 and harness.edges == 0:
                        self.convergence = await self._held_by_the_server(harness)
            finally:
                await super()._teardown()

        @staticmethod
        async def _held_by_the_server(harness):
            """One instance: every writer's doc byte-identical to the
            server's document (its acknowledged edits are all there)."""
            documents = harness.servers[0].hocuspocus.documents

            def diverged():
                return [d for d, writer in enumerate(harness.writers)
                        if documents.get(f"load-{d}") is None
                        or encode_state_as_update(documents[f"load-{d}"])
                        != encode_state_as_update(writer.document)]

            wait = await _until(lambda: not diverged(), LOADGEN_ACK_S,
                                lambda: f"loadgen: docs {diverged()[:16]} differ from the server's")
            return {"docs_checked": len(harness.writers), "converged": True, "diverged": [],
                    "wait_s": round(wait, 3)}

        async def _acknowledged(self, harness):
            wait = await _until(
                lambda: not any(p.has_unsynced_changes for p in harness.writers),
                LOADGEN_ACK_S, "loadgen: writers' edits never acknowledged")
            # the sampled readers, then LOADGEN_READERS_PER_CHUNK fresh
            # readers at a time, each chunk observed before the next joins
            # (the joins' SyncStep1 and QueryAwareness frames of 1,018 docs
            # at once overflow MiniRedis's 1,024-frame subscriber queue)
            chunks = [dict(enumerate(harness.readers))]
            if len(harness.servers) > 1:
                chunks += [range(base, min(base + LOADGEN_READERS_PER_CHUNK, harness.num_docs))
                           for base in range(harness.sampled, harness.num_docs,
                                             LOADGEN_READERS_PER_CHUNK)]
            observed = 0
            for chunk in chunks:
                if not isinstance(chunk, dict):
                    socket = InProcessProviderSocket(harness.servers[1])
                    harness.sockets.append(socket)  # destroyed by the harness's teardown
                    readers = {}
                    for d in chunk:
                        readers[d] = HocuspocusProvider(name=f"load-{d}", websocket_provider=socket)
                        readers[d].attach()
                        harness.readers.append(readers[d])
                    chunk = readers

                def unobserved(chunk=chunk):
                    return [d for d, reader in chunk.items()
                            if encode_state_as_update(reader.document)
                            != encode_state_as_update(harness.writers[d].document)]

                wait += await _until(
                    lambda: not unobserved(), LOADGEN_ACK_S,
                    lambda: f"loadgen: acknowledged edits of docs {unobserved()[:16]} never "
                            f"observed on the other instance ({self._redis_counters(harness)})")
                observed += len(chunk)
            self.acked = {"writers": len(harness.writers), "docs_observed": observed,
                          "fresh_readers": observed - harness.sampled,
                          "wait_s": round(wait, 3)}

        @staticmethod
        def _redis_counters(harness):
            return None if harness.mini_redis is None else dict(harness.mini_redis.counters)

    return Runner(schedule, device=device)


def _scenario_summary(result) -> dict:
    return {
        "verdict": result["verdict"],
        "schedule_hash": result["schedule_hash"],
        "breached": result["slo"]["breached_targets"],
        "phases": [
            {k: phase[k] for k in ("name", "slo_e2e_ms", "measured_ops", "failed_ops",
                                   "latency_p50_ms", "latency_p99_ms", "breached")}
            for phase in result["phases"]
        ],
        "ops": {k: result["extra"][k] for k in ("ops_total", "ops_measured", "ops_failed")},
        "setup_s": result["extra"]["setup_s"],
        "elapsed_s": result["extra"]["elapsed_s"],
        "behind_ms_max": result["extra"]["behind_ms_max"],
        "cpu_fallbacks": [h["cpu_fallbacks"] for h in result["extra"]["plane_health"]],
        # ops each plane integrated through K1 (its flushes' full-integrate
        # batches) and through the append path
        "k1_ops": [h["flush_slow_ops"] for h in result["extra"]["plane_health"]],
        "append_ops": [h["flush_fast_ops"] for h in result["extra"]["plane_health"]],
    }


async def run_loadgen(num_docs, device="cuda", seed=LOADGEN_SEED):
    """The port's ScenarioRunner: `smoke` at its defaults (its verdict must
    be pass), then `replication_lag` widened to `num_docs` (two instances
    over the port's MiniRedis, the scenario's other parameters as
    published; its SLO verdicts are reported, not gated), then the edge
    scenarios at their published defaults (two edges, two merge cells;
    verdicts gated, writers and readers converged byte for byte),
    `mega_audience` at its defaults (three cells; gated as the edge
    scenarios), and
    `multi_device_storm` at its defaults (two instances of four per-device
    cells; verdict, convergence and migrations gated in phase_loadgen),
    each schedule's hash held to the JAX package's. Returns the numbers."""
    from hocuspocus_tpu_torch.loadgen import get_scenario
    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu.scheduler import reset_device_lane

    dense_fn, sparse_fn = (getattr(ti, name) for name in ARENAS["unit"]["wrap"])
    out = {}
    runs = [("smoke", None), (LOADGEN_DOCS_SCENARIO, num_docs)]
    runs += [(name, None) for name in LOADGEN_EDGE_SCENARIOS + LOADGEN_AUDIENCE_SCENARIOS
             + LOADGEN_MULTI_SCENARIOS + LOADGEN_AUTOSCALE_SCENARIOS]
    for name, docs in runs:
        reset_device_lane()
        scenario = get_scenario(name) if docs is None else get_scenario(name, num_docs=docs)
        schedule = scenario.compile(seed)
        expected = LOADGEN_HASHES.get((name, docs))
        check(expected is None or schedule.schedule_hash == expected,
              f"loadgen {name}: schedule hash {schedule.schedule_hash} against the reference's {expected}")
        runner = acked_runner(schedule, device)
        started = time.perf_counter()
        launches0 = dense_fn.launches + sparse_fn.launches
        result = await runner.run()
        check(result["schedule_hash"] == schedule.schedule_hash, f"loadgen {name}: the run's hash differs")
        out[name] = {"seconds": round(time.perf_counter() - started, 3), "docs": scenario.num_docs,
                     "k1_launches": dense_fn.launches + sparse_fn.launches - launches0,
                     "acked": runner.acked, **_scenario_summary(result)}
        if name == LOADGEN_DOCS_SCENARIO:
            out[name]["mini_redis"] = result["extra"].get("mini_redis")
        if name in (LOADGEN_EDGE_SCENARIOS + LOADGEN_AUDIENCE_SCENARIOS + LOADGEN_MULTI_SCENARIOS
                    + LOADGEN_AUTOSCALE_SCENARIOS):
            # every edit of these scenarios is an append: reported, not
            # gated, since the cells' warm grid alone launches K1
            out[name]["k1_launches_are"] = (
                "the cells' warm grid's no-op batches: no op went through K1"
                if not any(out[name]["k1_ops"]) else "warm-grid and integrate batches"
            )
        if name in LOADGEN_MULTI_SCENARIOS:
            extra = result["extra"]
            out[name]["convergence"] = extra.get("convergence")
            out[name]["multi_device"] = {
                instance: {"migrations": m["migrations"], "utilization": m["utilization"],
                           "devices": m["devices"]}
                for instance, m in extra.get("multi_device", {}).items()
            }
            out[name]["docs_migrated"] = sum(
                m["migrations"]["docs_migrated"] for m in extra.get("multi_device", {}).values()
            )
            out[name]["lanes"] = [phase.get("lane") for phase in result["phases"]]
        if name in LOADGEN_AUTOSCALE_SCENARIOS:
            autoscale = result["extra"].get("autoscale") or {}
            out[name]["convergence"] = runner.convergence
            out[name]["autoscale"] = {
                "steady_footprint_ratio": autoscale.get("steady_footprint_ratio"),
                "max_ratio": autoscale.get("max_ratio"),
                "phase_active_cells": autoscale.get("phase_active_cells"),
                "decisions": [d for c in autoscale.get("controllers", []) for d in c["decisions"]],
                "actuation": [c["actuation"] for c in autoscale.get("controllers", [])],
                "timeline": [c["timeline"] for c in autoscale.get("controllers", [])],
            }
        if name in LOADGEN_EDGE_SCENARIOS + LOADGEN_AUDIENCE_SCENARIOS:
            out[name]["convergence"] = runner.convergence
            out[name]["mini_redis"] = result["extra"].get("mini_redis")
            out[name]["edge"] = {
                edge: {k: v["counters"].get(k, 0) for k in ("handoffs", "relay_overflows", "remaps")}
                for edge, v in result["extra"].get("edge", {}).items()
            }
    return out


def _loadgen_cli(seed=LOADGEN_SEED, timeout=300) -> dict:
    """`python -m hocuspocus_tpu_torch.loadgen --scenario smoke` as a user
    runs it (on the card, its default): exit code 0 and a pass verdict."""
    started = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "hocuspocus_tpu_torch.loadgen", "--scenario", "smoke", "--seed", str(seed)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"loadgen CLI: exit code {proc.returncode}: {proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    artifact = json.loads(lines[-1])
    check(artifact["verdict"] == "pass", f"loadgen CLI: verdict {artifact['verdict']}")
    return {"exit_code": proc.returncode, "verdict": artifact["verdict"],
            "schedule_hash": artifact["schedule_hash"], "seconds": round(time.perf_counter() - started, 3)}


def phase_loadgen(num_docs, cuts):
    """The loadgen entry points on the card (run_loadgen, then the module's
    command line). Gated on correctness only: smoke's verdict pass, the
    schedules' hashes, every acknowledged edit observed on the other
    instance, and K1 launched. Every loadgen edit is an append, which the
    append path takes: each plane's K1 ops are counted, and where no
    plane integrated one, K1's launches here are no-op batches (the
    planes' warm grid) and there is no batch to replay kernel vs plain;
    the line says so. Returns (launches, max_abs_err)."""
    from hocuspocus_tpu_torch.tpu import integrate as ti

    started = time.perf_counter()
    dense_name, sparse_name = ARENAS["unit"]["wrap"]
    dense_fn, sparse_fn = getattr(ti, dense_name), getattr(ti, sparse_name)
    dense_fn.launches = sparse_fn.launches = 0
    out = asyncio.run(run_loadgen(num_docs))
    launches = dense_fn.launches + sparse_fn.launches
    k1_ops = sum(sum(scenario["k1_ops"]) for scenario in out.values())
    cli = _loadgen_cli()
    check(cli["schedule_hash"] == out["smoke"]["schedule_hash"], "loadgen CLI: another smoke schedule")
    emit(
        "loadgen",
        gpu=nvidia_smi_line(),
        arena="unit",
        cuts=cuts,
        seed=LOADGEN_SEED,
        scenarios=out,
        cli=cli,
        integrate_launches={dense_name: dense_fn.launches, sparse_name: sparse_fn.launches},
        k1_ops=k1_ops,
        kernel_vs_plain=(
            "not replayed: no plane integrated an op through K1 (every edit an append, taken "
            "by the append path); K1's launches here are the warm grid's no-op batches"
            if k1_ops == 0 else "not replayed: this path keeps no batch"
        ),
        seconds=round(time.perf_counter() - started, 3),
    )
    check(out["smoke"]["verdict"] == "pass", f"loadgen smoke: verdict {out['smoke']['verdict']}")
    check(out[LOADGEN_DOCS_SCENARIO]["acked"] is not None, "loadgen: the acknowledgement check did not run")
    check(out[LOADGEN_DOCS_SCENARIO]["acked"]["docs_observed"] == num_docs,
          f"loadgen: {out[LOADGEN_DOCS_SCENARIO]['acked']} docs observed on the other instance")
    for name in LOADGEN_MULTI_SCENARIOS:
        run = out[name]
        check(run["verdict"] == "pass", f"loadgen {name}: verdict {run['verdict']} ({run['breached']})")
        check(run["convergence"] is not None and run["convergence"]["converged"],
              f"loadgen {name}: sampled docs diverged across instances: {run['convergence']}")
        check(run["docs_migrated"] >= 1, f"loadgen {name}: no doc migrated: {run['multi_device']}")
        check(run["acked"] is not None and run["acked"]["docs_observed"] == run["docs"],
              f"loadgen {name}: {run['acked']} docs observed on the other instance")
    for name in LOADGEN_AUTOSCALE_SCENARIOS:
        run = out[name]
        check(run["verdict"] == "pass", f"loadgen {name}: verdict {run['verdict']} ({run['breached']})")
        ratio, limit = run["autoscale"]["steady_footprint_ratio"], run["autoscale"]["max_ratio"]
        check(ratio is not None and ratio <= limit,
              f"loadgen {name}: steady footprint ratio {ratio} over {limit}: {run['autoscale']}")
        check(run["convergence"] is not None and run["convergence"]["converged"],
              f"loadgen {name}: writers diverged from the server: {run['convergence']}")
        check(run["acked"] is not None and run["acked"]["docs_observed"] == min(8, run["docs"]),
              f"loadgen {name}: {run['acked']} sampled readers observed their writers")
        check(all(a["failures"] == 0 for a in run["autoscale"]["actuation"]),
              f"loadgen {name}: actuations failed: {run['autoscale']['actuation']}")
    for name in LOADGEN_EDGE_SCENARIOS + LOADGEN_AUDIENCE_SCENARIOS:
        run = out[name]
        check(run["verdict"] == "pass", f"loadgen {name}: verdict {run['verdict']} ({run['breached']})")
        check(run["convergence"] is not None and run["convergence"]["converged"],
              f"loadgen {name}: writers and readers diverged: {run['convergence']}")
        check(run["acked"] is not None and run["acked"]["docs_observed"] == run["docs"],
              f"loadgen {name}: {run['acked']} docs observed through the other edge")
        check(not any(c["relay_overflows"] for c in run["edge"].values()),
              f"loadgen {name}: relay overflows {run['edge']}")
    check(launches > 0, "loadgen: K1 never launched from the scenario runs")
    return launches, 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--supervised-docs", type=int, default=None, metavar="N",
                        help="run only the unit supervised phase with N docs driven (the "
                             "smoke's reported run, supervised_server_full) and exit")
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
    if args.supervised_docs is not None:
        try:
            phase_native_build()
            phase_build()
            phase_supervised_server(
                rng, "unit", num_docs=1024, capacity=4096, clients=SERVER_CLIENTS,
                rounds=SUPERVISED_ROUNDS, evict_idle_secs=EVICT_IDLE_SECS,
                cuts={"rounds": SUPERVISED_CUTS["rounds"]}, driven=args.supervised_docs,
                device_profile=False,
            )
        except SmokeFailure as failure:
            print(f"chip_smoke: FAILED: {failure}", file=sys.stderr)
            return 1
        return 0
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
                rng, arena, num_docs=SERVER_DOCS, capacity=4096, clients=SERVER_CLIENTS,
                rounds=SERVER_ROUNDS, cuts=SERVER_CUTS,
            )
        for arena in ("unit", "rle"):
            # the earlier served path (Python host path), kept driven
            results[arena]["server_python"], results[arena]["server_python_err"] = phase_server(
                rng, arena, num_docs=PYTHON_SERVER_DOCS, capacity=4096, clients=SERVER_CLIENTS,
                rounds=PYTHON_SERVER_ROUNDS, cuts=PYTHON_SERVER_CUTS, native_lane=False,
                join_waves=PYTHON_SERVER_JOIN_WAVES,
            )
        for arena in ("unit", "rle"):
            # the JAX CLI's default deployment: supervised, evicting, compacting
            results[arena]["supervised_server"], results[arena]["supervised_server_err"] = (
                phase_supervised_server(
                    rng, arena, num_docs=1024, capacity=4096, clients=SERVER_CLIENTS,
                    rounds=SUPERVISED_ROUNDS, evict_idle_secs=EVICT_IDLE_SECS,
                    cuts=SUPERVISED_CUTS, driven=SUPERVISED_DRIVEN,
                )
            )
        for arena in ("unit", "rle"):
            results[arena]["compact_plane"], results[arena]["compact_plane_err"] = phase_compact_plane(
                rng, arena, num_docs=1024, capacity=4096, twin=COMPACT_TWINS[arena],
                driven=COMPACT_DRIVEN[arena], cuts=COMPACT_CUTS[arena],
            )
        # BASELINE config 4: Redis fan-out between two served planes (unit
        # arena); configs 3 and 1: Tiptap docs behind SQLite, a webhook and
        # History (run-length arena). An arena a path does not run reports 0
        results["unit"]["cluster_server"], results["unit"]["cluster_server_err"] = phase_cluster_server(
            rng, num_docs=CLUSTER_DOCS, capacity=4096, cuts=CLUSTER_CUTS,
        )
        # the edge tier: two stateless edges in front of two merge cells
        results["unit"]["edge_server"], results["unit"]["edge_server_err"] = phase_edge_server(
            rng, num_docs=EDGE_DOCS, capacity=4096, cuts=EDGE_CUTS,
        )
        results["rle"]["tiptap_server"], results["rle"]["tiptap_server_err"] = phase_tiptap_server(
            rng, num_docs=TIPTAP_DOCS, capacity=4096, cuts=TIPTAP_CUTS,
        )
        # the port's entry points: the CLI in a process of its own (its
        # default deployment) and the scenario runner, both on the unit arena
        results["unit"]["cli_server"], results["unit"]["cli_server_err"] = phase_cli_server(
            rng, num_docs=1024, cuts=CLI_CUTS,
        )
        results["unit"]["loadgen"], results["unit"]["loadgen_err"] = phase_loadgen(
            num_docs=1024, cuts=LOADGEN_CUTS,
        )
        # the CLI's --tpu-serve --tpu-devices 4 in process: four supervised
        # cells, a lane each, the rebalancer's migrations and one late
        # cell. Last of the gated phases: its 3,072 providers and four
        # arenas in this process come after every earlier phase's clients
        results["unit"]["multi_device_server"], results["unit"]["multi_device_server_err"] = (
            phase_multi_device_server(rng, num_docs=MULTI_DOCS, capacity=4096, cuts=MULTI_CUTS)
        )
        # the same deployment with --fleet-autoscale --fleet-warm-spares 2:
        # the controller parks and activates cells through diurnal_autoscale's day
        results["unit"]["fleet_server"], results["unit"]["fleet_server_err"] = phase_fleet_server(
            rng, num_docs=FLEET_DOCS, capacity=4096, cuts=FLEET_CUTS,
        )
        for arena, path in (("rle", "cluster_server"), ("rle", "edge_server"),
                            ("rle", "multi_device_server"), ("rle", "fleet_server"), ("unit", "tiptap_server"),
                            ("rle", "cli_server"), ("rle", "loadgen")):
            results[arena][path] = results[arena][f"{path}_err"] = 0
        phase_supervised_full(args.seed, started)
        smi = nvidia_smi_line()
    except SmokeFailure as failure:
        print(f"chip_smoke: FAILED: {failure}", file=sys.stderr)
        return 1
    marks = [("start", started), *EMITTED]
    emit("phase_clock", seconds={
        tag: round(at - marks[i][1], 3) for i, (tag, at) in enumerate(marks[1:])
    })
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
                    *(results[arena][f"{path}_err"] for path in PATHS[1:]),
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
