#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the Hopper integrate kernel from `hocuspocus_tpu_torch/csrc/`,
holds it against its plain PyTorch version (bit for bit) at the bench
shape and at deployment scale, then drives the merge plane + serving
path (`MergePlane` on the card, `PlaneServing`, `TpuSyncSource`) with
concurrent Yjs editors and checks every served byte against a second
plane on the CPU. Each phase prints one line; any failure exits nonzero.
The last two lines are the kernels' JSON record and the device line.
Without a CUDA device, or outside a checkout, it exits nonzero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

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
    """Median device time of fn() over `reps` runs, CUDA events around
    the call only; setup() runs before each (untimed)."""
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


def plain_with_lengths(state, ops):
    """The plain integrate one op slot at a time, in place, recording
    each row's length before each slot: the reference result plus what
    the bound needs."""
    import torch

    from hocuspocus_tpu_torch.tpu import kernels as tk

    lengths = []
    for k in range(ops.kind.shape[0]):
        lengths.append(state.length.clone())
        tk.integrate_op_slots(state, tk.OpBatch(*(f[k : k + 1] for f in ops)))
    return torch.stack(lengths)


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
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = operations / INT32_OPS_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"bytes": moved, "int32_ops": operations}


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


def phase_build():
    from hocuspocus_tpu_torch.tpu.integrate import LIBRARY

    started = time.perf_counter()
    LIBRARY.get()
    ptxas = [
        line.strip()
        for line in LIBRARY.build_log.splitlines()
        if "registers" in line or "spill" in line or "smem" in line
    ]
    emit(
        "build",
        gpu=nvidia_smi_line(),
        kernel="integrate_rows",
        seconds=round(time.perf_counter() - started, 3),
        nvcc_seconds=round(LIBRARY.build_seconds, 3),
        ptxas=ptxas,
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

    scratch = {}

    def reset():
        scratch["s"] = clone_state(state)

    kernel_ms = event_ms(lambda: ti.integrate_op_slots_fast(scratch["s"], ops), reps, reset)
    plain_ms = event_ms(lambda: tk.integrate_op_slots(scratch["s"], ops), 2, reset)
    bound_ms, bound_by, need = integrate_bound(ops, lengths, expected.length)
    scratch.clear()
    emit(
        "dense",
        shape={"D": num_docs, "N": capacity, "K": num_slots},
        bit_identical=True,
        max_abs_err=err,
        mean_occupancy=round(float(state.length.float().mean()) / capacity, 4),
        ms=kernel_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        **need,
    )
    return state


def _row_checksums(state, chunk=8192):
    """Per-row int64 checksum of every field (random column weights),
    computed in row chunks to bound the temporaries."""
    import torch

    num_docs, capacity = state.id_client.shape
    gen = torch.Generator(device="cuda").manual_seed(1234)
    weights = torch.randint(1, 2**31, (capacity,), generator=gen, device="cuda", dtype=torch.int64)
    out = torch.zeros(num_docs, dtype=torch.int64, device="cuda")
    for start in range(0, num_docs, chunk):
        rows = slice(start, start + chunk)
        for field in state[:5]:
            out[rows] += (field[rows].long() * weights).sum(dim=1)
        out[rows] += state.length[rows].long() * 31 + state.overflow[rows].long() * 17
    return out


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
    live = random_ops(rng, next_clock, num_slots)
    fields = []
    for value, default in zip(live, (0, 0, 0, 0, NONE, 0, NONE, 0)):
        full = np.full((num_slots, busy + pad), default, value.dtype)
        full[:, :busy] = value
        fields.append(full)
    ops = tk.ops_from_numpy(fields, dev)
    slots_np = np.full(busy + pad, num_docs, np.int32)
    slots_np[:busy] = cols
    slots = torch.from_numpy(slots_np).to(dev)

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

    kernel_ms = event_ms(lambda: ti.integrate_op_slots_sparse_fast(state, ops, slots), reps, restore)
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
        ms=kernel_ms,
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

    def __init__(self, module) -> None:
        self.module = module
        self.best = None
        self.before = None  # the arena as the current flush found it
        self.pending = None  # (ops, slots) of this flush's first call
        self.dense = module.integrate_op_slots_fast
        self.sparse = module.integrate_op_slots_sparse_fast

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
            if state.id_client.is_cuda:
                self._keep(ops, None)
            return self.dense(state, ops)

        def sparse(state, ops, slots):
            if state.id_client.is_cuda:
                self._keep(ops, slots)
            return self.sparse(state, ops, slots)

        self.module.integrate_op_slots_fast = dense
        self.module.integrate_op_slots_sparse_fast = sparse
        return self

    def __exit__(self, *exc):
        self.module.integrate_op_slots_fast = self.dense
        self.module.integrate_op_slots_sparse_fast = self.sparse


def run_plane(rng, devices, num_docs, capacity, clients, rounds, on_flush=None):
    """Drive MergePlane + PlaneServing on each device in `devices` with
    the same concurrent Yjs stream: `clients` replicas per doc, every
    editor edits its own replica before it sees the others' edits, and
    the updates reach the planes shuffled. After every flush, for every
    doc, the bytes TpuSyncSource serves cold and for a stale state
    vector must rebuild the converged text, and match across planes
    byte for byte. Returns (planes, per-round flush seconds of the
    first plane, checks)."""
    from hocuspocus_tpu_torch.crdt import Doc, apply_update, encode_state_vector
    from hocuspocus_tpu_torch.tpu import MergePlane, PlaneServing, TpuSyncSource

    planes = [MergePlane(num_docs=num_docs, capacity=capacity, device=d) for d in devices]
    servings = [PlaneServing(p) for p in planes]
    names = [f"doc-{i}" for i in range(num_docs)]
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
    flush_seconds = []
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
        started = time.perf_counter()
        planes[0].flush()
        flush_seconds.append(time.perf_counter() - started)
        for plane in planes[1:]:
            plane.flush()
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
    return planes, flush_seconds, {"served_bytes": served_bytes}


def phase_plane(rng, num_docs, capacity, clients, rounds):
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import merge_plane as mp

    arena_checks = []
    stages = []
    recorder = Recorder(mp)

    def compare(planes):
        gpu, cpu = planes
        stages.append(dict(gpu.flush_stats))
        check(states_equal(cpu.state, gpu.state), "plane: CUDA and CPU arenas differ")
        arena_checks.append(True)
        recorder.after_flush(gpu.state)

    started = time.perf_counter()
    ti.reset_integrate_launches()
    with recorder:
        planes, flush_s, extra = run_plane(
            rng, ["cuda", "cpu"], num_docs, capacity, clients, rounds, on_flush=compare
        )
    launches = {
        "integrate_op_slots_fast": ti.integrate_op_slots_fast.launches,
        "integrate_op_slots_sparse_fast": ti.integrate_op_slots_sparse_fast.launches,
    }
    gpu = planes[0]
    counters = gpu.counters
    retired = {k: v for k, v in counters.items() if k.startswith("docs_retired_")}
    check(ti.integrate_launches() > 0, "plane: the integrate kernel never launched")
    check(counters["flush_fast_ops"] > 0, "plane: no op took the append fast path")
    check(counters["flush_slow_ops"] > 0, "plane: no op took the integrate path")
    check(counters["cpu_fallbacks"] == 0, "plane: CPU fallbacks happened")
    check(not any(retired.values()), f"plane: docs retired {retired}")
    check(counters == planes[1].counters, "plane: CUDA and CPU counters differ")
    flush_ms = np.asarray(flush_s) * 1e3
    emit(
        "plane",
        config="BASELINE config 2: 1k Y.Text docs, 10 clients each, random-position insert/delete",
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
        flush_p50_ms=float(np.percentile(flush_ms, 50)),
        flush_p99_ms=float(np.percentile(flush_ms, 99)),
        flush_stage_p50_ms={
            key: float(np.median([s[key] for s in stages]))
            for key in ("build_ms", "upload_ms", "dispatch_ms", "device_sync_ms")
        },
        fast_path_fraction=round(
            counters["flush_fast_ops"]
            / max(counters["flush_fast_ops"] + counters["flush_slow_ops"], 1),
            6,
        ),
        arena_equal_checks=len(arena_checks),
        cuda_cpu_bytes_equal=True,
        **extra,
    )
    return ti.integrate_launches(), recorder.best


def phase_replay(recorded, reps):
    """The integrate batch of the main path with the most ops, replayed:
    kernel vs plain on the same inputs at the plane's own shape."""
    import torch

    from hocuspocus_tpu_torch.tpu import integrate as ti
    from hocuspocus_tpu_torch.tpu import kernels as tk

    check(recorded is not None, "replay: no integrate batch was recorded")
    _count, state0, ops, slots = recorded
    dense = slots is None
    if dense:
        rows = torch.arange(state0.length.shape[0], device=state0.length.device)
        slots = rows.to(torch.int32)
    else:
        rows = slots.long()[slots.long() < state0.length.shape[0]]
    live = slots.long() < state0.length.shape[0]
    sub_ops = tk.OpBatch(*(f[:, live] for f in ops))
    expected = tk.gather_doc_rows(state0, rows)
    lengths = plain_with_lengths(expected, sub_ops)
    work = clone_state(state0)
    ti.integrate_rows_cuda(work, ops, slots)
    torch.cuda.synchronize()
    got = tk.gather_doc_rows(work, rows)
    check(states_equal(got, expected), "replay: kernel and plain rows differ")
    err = max_abs_err(got, expected)
    scratch = {}

    def reset():
        scratch["s"] = clone_state(state0)

    kernel_ms = event_ms(lambda: ti.integrate_rows_cuda(scratch["s"], ops, slots), reps, reset)
    if dense:
        plain_ms = event_ms(lambda: tk.integrate_op_slots(scratch["s"], ops), 3, reset)
    else:
        plain_ms = event_ms(
            lambda: tk.integrate_op_slots_sparse(scratch["s"], ops, slots), 3, reset
        )
    bound_ms, bound_by, need = integrate_bound(sub_ops, lengths, expected.length)
    emit(
        "replay",
        shape={"D": state0.length.shape[0], "N": state0.id_client.shape[1],
               "K": ops.kind.shape[0], "B": ops.kind.shape[1]},
        bit_identical=True,
        ms=kernel_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        **need,
    )
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    try:
        phase_build()
        seeded = phase_dense(rng, num_docs=8192, capacity=5632, num_slots=64, reps=5)
        phase_sparse(rng, seeded, num_docs=100_000, busy=1024, pad=32, num_slots=16, reps=5)
        del seeded
        torch.cuda.empty_cache()
        launches, recorded = phase_plane(
            # host work grows with the docs: 16 rounds took 200 s, 12 keep
            # the phase near two minutes
            rng, num_docs=1024, capacity=4096, clients=10, rounds=12
        )
        replay = phase_replay(recorded, reps=10)
        smi = nvidia_smi_line()
    except SmokeFailure as failure:
        print(f"chip_smoke: FAILED: {failure}", file=sys.stderr)
        return 1
    emit("total", seconds=round(time.perf_counter() - started, 3))
    print(smi, flush=True)
    record = {
        "kernels": [
            {
                "name": "integrate_rows",
                "route": "cuda",
                "source": "hocuspocus_tpu_torch/csrc/integrate.cu",
                "replaces": "hocuspocus_tpu/tpu/pallas_kernels.py:34",
                "launches": launches,
                "max_abs_err": replay["max_abs_err"],
                "ms": replay["ms"],
                "plain_ms": replay["plain_ms"],
                "bound_ms": replay["bound_ms"],
                "bound_by": replay["bound_by"],
                "library_ms": None,
            }
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
