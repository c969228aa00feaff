"""Run-length batched text-CRDT arena and its plain PyTorch programs.

The PyTorch counterpart of the JAX package's `tpu/kernels_rle.py`: one
arena entry per RUN of consecutively-typed units instead of one slot
per unit, so a busy document's arena cost grows with ops and
fragmentation, not with the units it ever held. A churning document
(insert a burst, delete it, repeat) stays on the plane where the unit
arena would retire it for capacity.

Same layout rules as `kernels.py`: entries are APPEND-ONLY, unit ranks
are DENSE (0..total_units), client ids are int32 BIT PATTERNS of the
uint32 wire ids. Two structural facts keep the integrate cheap:

- Within a run, unit i's left origin is unit i-1, so only run HEADS can
  block a YATA conflict scan, plus the one unit at rank left_rank+1
  inside a run (it ties on client id).
- Ranks are dense, so the insertion rank is `min(first_block,
  right_rank)`: skipped window units need no count.

Inserting or deleting inside a run SPLITS it: the head keeps its lane
and shortens, the tail is appended as a fresh entry (at most two
appends per op). An op that would need more lanes than the row has
flags sticky overflow.

These programs run as the plane's device step on a CPU tensor, and on
the card they are the reference the hand-written kernel
(`csrc/integrate_rle.cu`) is held against, bit for bit. Programs that
the JAX package runs with a donated state update the state tensors IN
PLACE and return the same NamedTuple.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .kernels import (
    KIND_DELETE,
    KIND_INSERT,
    NONE_CLIENT_I32,
    OpBatch,
    _INF,
    _SIGN,
    _copy_into,
    gather_doc_rows,
    op_count,
    scatter_doc_rows,
)


class RleState(NamedTuple):
    """Run-length arena for a batch of rows. Leading axis = row."""

    run_client: torch.Tensor  # (D, R) int32 (uint32 bit pattern) — author of the run
    run_clock: torch.Tensor  # (D, R) int32 — clock of the first unit
    run_len: torch.Tensor  # (D, R) int32 — units in this entry
    run_rank: torch.Tensor  # (D, R) int32 — UNIT rank of the first unit
    run_orank: torch.Tensor  # (D, R) int32 — origin UNIT rank of the first unit
    run_deleted: torch.Tensor  # (D, R) bool
    num_runs: torch.Tensor  # (D,) int32 — occupied entries
    total_units: torch.Tensor  # (D,) int32 — rank-space size (live + tombstones)
    overflow: torch.Tensor  # (D,) bool

    @property
    def length(self) -> torch.Tensor:
        """Alias of total_units: the inserted units, the same accounting
        as the unit arena's `length`, so the plane's health readback and
        `check_doc_health` read either arena alike."""
        return self.total_units


def make_empty_rle_state(num_docs: int, entries: int, device) -> RleState:
    shape = (num_docs, entries)
    return RleState(
        run_client=torch.full(shape, NONE_CLIENT_I32, dtype=torch.int32, device=device),
        run_clock=torch.zeros(shape, dtype=torch.int32, device=device),
        run_len=torch.zeros(shape, dtype=torch.int32, device=device),
        run_rank=torch.full(shape, _INF, dtype=torch.int32, device=device),
        run_orank=torch.full(shape, -1, dtype=torch.int32, device=device),
        run_deleted=torch.zeros(shape, dtype=torch.bool, device=device),
        num_runs=torch.zeros((num_docs,), dtype=torch.int32, device=device),
        total_units=torch.zeros((num_docs,), dtype=torch.int32, device=device),
        overflow=torch.zeros((num_docs,), dtype=torch.bool, device=device),
    )


# -- carrying state across from the JAX package ------------------------------


def rle_state_from_numpy(fields: Sequence[np.ndarray], device) -> RleState:
    """The JAX package's RleState fields, as numpy arrays in field order
    (run_client uint32, run_deleted/overflow bool), as the port's
    tensors on `device`."""
    arrays = [np.ascontiguousarray(np.asarray(f)) for f in fields]
    arrays[0] = arrays[0].astype(np.uint32).view(np.int32)
    dtypes = (np.int32,) * 5 + (np.bool_, np.int32, np.int32, np.bool_)
    return RleState(
        *(
            torch.from_numpy(a.astype(dt, copy=True)).to(device)
            for a, dt in zip(arrays, dtypes)
        )
    )


def rle_state_to_numpy(state: RleState) -> RleState:
    """Inverse of rle_state_from_numpy: the fields as numpy arrays in the
    JAX package's dtypes (run_client uint32), held in an RleState."""
    out = [field.detach().cpu().numpy().copy() for field in state]
    out[0] = out[0].view(np.uint32)
    return RleState(*out)


# -- integrate (the plain version of the hand-written kernel) ---------------


def _integrate_rle_rows(rows: RleState, op: Sequence[torch.Tensor]) -> RleState:
    """One op per row over (B, R) rows; op fields are (B,). The YATA
    math of the JAX package's `_integrate_one_rle`, vectorised over
    rows, with the split fields extracted per entry and summed as
    `_rle_block_kernel` extracts them."""
    rcl, rck, rln, rrk, ror, rdl, nrn, tot, ovf = rows
    kind, client, clock, run, lc, lk, rc, rk = (f[:, None] for f in op)
    r = rcl.shape[1]
    idx = torch.arange(r, dtype=torch.int32, device=rcl.device)[None, :]
    nrn = nrn[:, None]
    tot = tot[:, None]
    occupied = idx < nrn

    def row_sum(mask, values):
        return torch.where(mask, values, 0).sum(dim=1, keepdim=True, dtype=torch.int32)

    # -- resolve origin ids to UNIT ranks (range membership) ---------------
    in_left = occupied & (rcl == lc) & (lk >= rck) & (lk < rck + rln)
    has_left = lc != NONE_CLIENT_I32
    left_raw = torch.where(in_left, rrk + (lk - rck), -1).amax(dim=1, keepdim=True)
    left_rank = torch.where(has_left, left_raw, -1)
    in_right = occupied & (rcl == rc) & (rk >= rck) & (rk < rck + rln)
    has_right = rc != NONE_CLIENT_I32
    right_raw = torch.where(in_right, rrk + (rk - rck), -1).amax(dim=1, keepdim=True)
    right_rank = torch.where(has_right, right_raw, tot)

    # -- YATA conflict scan over run heads + the in-run successor ----------
    client_ge = ~((rcl ^ _SIGN) < (client ^ _SIGN))  # unsigned compare
    head_blocked = (
        occupied
        & (rrk > left_rank)
        & (rrk < right_rank)
        & ((ror < left_rank) | ((ror == left_rank) & client_ge))
    )
    succ = left_rank + 1
    succ_blocked = (
        occupied & (rrk < succ) & (succ < rrk + rln) & (succ < right_rank) & client_ge
    )
    first_block = torch.minimum(
        torch.where(head_blocked, rrk, _INF).amin(dim=1, keepdim=True),
        torch.where(succ_blocked, succ, _INF).amin(dim=1, keepdim=True),
    )
    ins_rank = torch.minimum(first_block, right_rank)

    fits = nrn + 2 <= r
    deps_ok = (~has_left | (left_raw >= 0)) & (~has_right | (right_raw >= 0))
    do_insert = (kind == KIND_INSERT) & fits & deps_ok

    # -- insert: split the straddled run -----------------------------------
    off = ins_rank - rrk
    inside = do_insert & occupied & (rrk < ins_rank) & (ins_rank < rrk + rln)
    any_split = inside.any(dim=1, keepdim=True)
    t_client = row_sum(inside, rcl)
    t_clock = row_sum(inside, rck + off)
    t_len = row_sum(inside, rln - off)
    t_deleted = (inside & rdl).any(dim=1, keepdim=True)
    rln = torch.where(inside, off, rln)
    at = any_split & (idx == nrn)
    rcl = torch.where(at, t_client, rcl)
    rck = torch.where(at, t_clock, rck)
    rln = torch.where(at, t_len, rln)
    rrk = torch.where(at, ins_rank, rrk)
    ror = torch.where(at, ins_rank - 1, ror)
    rdl = torch.where(at, t_deleted, rdl)
    nrn = nrn + any_split.to(torch.int32)

    # -- bump ranks right of the insertion, append the new entry -----------
    occupied2 = idx < nrn
    bump_rank = do_insert & occupied2 & (rrk >= ins_rank)
    bump_orank = do_insert & occupied2 & (ror >= ins_rank)
    rrk = torch.where(bump_rank, rrk + run, rrk)
    ror = torch.where(bump_orank, ror + run, ror)
    at2 = do_insert & (idx == nrn)
    rcl = torch.where(at2, client, rcl)
    rck = torch.where(at2, clock, rck)
    rln = torch.where(at2, run, rln)
    rrk = torch.where(at2, ins_rank, rrk)
    ror = torch.where(at2, left_rank, ror)
    rdl = rdl & ~at2
    nrn = nrn + do_insert.to(torch.int32)
    tot = tot + torch.where(do_insert, run, 0)
    ovf = ovf | ((kind == KIND_INSERT) & ~fits)[:, 0]

    # -- delete: split at both id bounds, tombstone covered entries --------
    # the capacity verdict is taken AFTER the insert step moved num_runs
    # and BEFORE the delete's own splits use the margin
    del_fits = nrn + 2 <= r
    do_delete = (kind == KIND_DELETE) & del_fits
    del_end = clock + run
    for bound in (clock, del_end):
        occ = idx < nrn
        off_d = bound - rck
        ins_d = do_delete & occ & (rcl == client) & (rck < bound) & (bound < rck + rln)
        any_d = ins_d.any(dim=1, keepdim=True)
        d_rank = row_sum(ins_d, rrk + off_d)
        d_len = row_sum(ins_d, rln - off_d)
        d_deleted = (ins_d & rdl).any(dim=1, keepdim=True)
        rln = torch.where(ins_d, off_d, rln)
        at_d = any_d & (idx == nrn)
        rcl = torch.where(at_d, client, rcl)
        rck = torch.where(at_d, bound, rck)
        rln = torch.where(at_d, d_len, rln)
        rrk = torch.where(at_d, d_rank, rrk)
        ror = torch.where(at_d, d_rank - 1, ror)
        rdl = torch.where(at_d, d_deleted, rdl)
        nrn = nrn + any_d.to(torch.int32)
    covered = (
        do_delete
        & (idx < nrn)
        & (rcl == client)
        & (rck >= clock)
        & (rck + rln <= del_end)
    )
    return RleState(
        run_client=rcl,
        run_clock=rck,
        run_len=rln,
        run_rank=rrk,
        run_orank=ror,
        run_deleted=rdl | covered,
        num_runs=nrn[:, 0],
        total_units=tot[:, 0],
        overflow=ovf | ((kind == KIND_DELETE) & ~del_fits)[:, 0],
    )


def _integrate_rle_slots(rows: RleState, ops: OpBatch) -> RleState:
    for k in range(ops.kind.shape[0]):
        rows = _integrate_rle_rows(rows, [field[k] for field in ops])
    return rows


def integrate_op_slots_rle(state: RleState, ops: OpBatch) -> tuple[RleState, torch.Tensor]:
    """Integrate K op slots into every row: ops fields are (K, D).

    Updates `state` in place (the JAX step donates it); returns it and
    the number of non-noop ops."""
    return _copy_into(state, _integrate_rle_slots(state, ops)), op_count(ops)


def integrate_op_slots_rle_sparse(
    state: RleState, ops: OpBatch, slots: torch.Tensor
) -> tuple[RleState, torch.Tensor]:
    """Integrate K op slots over the B rows `slots` routes to: ops fields
    are (K, B), slots int32 (B,) with num_docs as the padding sentinel
    (the gather clips, the scatter drops). Updates `state` in place."""
    sub = _integrate_rle_slots(gather_doc_rows(state, slots), ops)
    return scatter_doc_rows(state, sub, slots), op_count(ops)


# -- minimal-work run merge (the sequential fast path) -----------------------


def append_run_slots_rle_sparse(
    state: RleState,
    client: torch.Tensor,
    clock: torch.Tensor,
    run_len: torch.Tensor,
    slots: torch.Tensor,
) -> tuple[RleState, torch.Tensor]:
    """Fast-path integrate for B all-sequential columns (RLE arena).

    client/clock/run_len are (K, B) int32 coalesced tail-append runs
    (run_len == 0 is padding) with the sparse integrate's routing
    contract. Run 0 EXTENDS the rank-tail entry when it continues it
    (same client, consecutive clock, entry not tombstoned): no new
    entry. Every other live run APPENDS one entry at rank old total +
    chain offset with orank = rank - 1. A run that needs a lane when
    none is free flags overflow and kills the chain. Updates `state` in
    place; returns it and the applied-run count."""
    sub = gather_doc_rows(state, slots)
    rcl, rck, rln, rrk, ror, rdl, entries, total, ovf = sub
    r = rcl.shape[1]
    idx = torch.arange(r, dtype=torch.int32, device=rcl.device)[None, :]
    is_run = run_len > 0

    # the rank-tail entry: occupied spans are disjoint and cover
    # [0, total), so exactly one nonempty entry ends at `total` (none
    # when the row is empty); masked sums extract its fields
    occupied = (idx < entries[:, None]) & (rln > 0)
    tail = occupied & (rrk + rln == total[:, None]) & (total[:, None] > 0)
    tail_client = torch.where(tail, rcl, 0).sum(dim=1, dtype=torch.int32)
    tail_end_clock = torch.where(tail, rck + rln, 0).sum(dim=1, dtype=torch.int32)
    tail_deleted = (tail & rdl).any(dim=1)
    ext0 = (
        is_run[0]
        & (total > 0)
        & tail.any(dim=1)
        & (tail_client == client[0])
        & (clock[0] == tail_end_clock)
        & ~tail_deleted
    )

    applied = torch.zeros_like(total)
    new_entries = torch.zeros_like(entries)
    alive = torch.ones_like(ovf)
    over = ovf.clone()
    starts, lanes, appends = [], [], []
    for m in range(run_len.shape[0]):
        extend = ext0 if m == 0 else torch.zeros_like(ext0)
        fits = extend | (entries + new_entries + 1 <= r)
        live = alive & fits & is_run[m]
        starts.append(applied)
        lanes.append(entries + new_entries)
        appends.append(live & ~extend)
        applied = applied + torch.where(live, run_len[m], 0)
        new_entries = new_entries + (live & ~extend).to(torch.int32)
        over = over | (is_run[m] & ~fits)
        alive = alive & (fits | ~is_run[m])

    # the extension first (its own lane, disjoint from every appended one)
    rln = torch.where(tail & ext0[:, None], rln + run_len[0][:, None], rln)
    for m, (start, lane, append) in enumerate(zip(starts, lanes, appends)):
        at = append[:, None] & (idx == lane[:, None])
        rank = (total + start)[:, None]
        rcl = torch.where(at, client[m][:, None], rcl)
        rck = torch.where(at, clock[m][:, None], rck)
        rln = torch.where(at, run_len[m][:, None], rln)
        rrk = torch.where(at, rank, rrk)
        ror = torch.where(at, rank - 1, ror)
        rdl = rdl & ~at
    appended = torch.stack(appends).sum(dim=0, dtype=torch.int32)
    sub = RleState(
        run_client=rcl,
        run_clock=rck,
        run_len=rln,
        run_rank=rrk,
        run_orank=ror,
        run_deleted=rdl,
        num_runs=entries + appended,
        total_units=total + applied,
        overflow=over,
    )
    count = appended.sum() + ext0.sum()
    return scatter_doc_rows(state, sub, slots), count


# -- on-device catch-up support (SyncStep2 serving) --------------------------


def tail_probe_rle(state: RleState, slots: torch.Tensor) -> torch.Tensor:
    """Rank-tail UNIT ids of the requested rows as ONE (2B,) int32
    readback [clients..., clocks...] (uint32 bit patterns): the same
    host contract as kernels.tail_probe, an empty row reading (0, 0)."""
    sub = gather_doc_rows(state, slots)
    r = sub.run_client.shape[1]
    idx = torch.arange(r, dtype=torch.int32, device=sub.run_client.device)[None, :]
    total = sub.total_units[:, None]
    occupied = (idx < sub.num_runs[:, None]) & (sub.run_len > 0)
    tail = occupied & (sub.run_rank + sub.run_len == total) & (total > 0)
    clients = torch.where(tail, sub.run_client, 0).sum(dim=1, dtype=torch.int32)
    clocks = torch.where(tail, sub.run_clock + sub.run_len - 1, 0).sum(
        dim=1, dtype=torch.int32
    )
    return torch.cat([clients, clocks])


def catchup_pack_rle(state: RleState, slots: torch.Tensor, width: int) -> torch.Tensor:
    """Device-side delete-set pack for the requested rows (RLE arena):
    ONE (B + 3*B*width,) int32 readback [counts, clients (B, width)
    flat, clocks flat, lens flat] of the tombstoned nonempty entries in
    lane order. A row with more than `width` of them reports its true
    count (the host re-reads that row in full)."""
    sub = gather_doc_rows(state, slots)
    rows, r = sub.run_client.shape
    device = sub.run_client.device
    idx = torch.arange(r, dtype=torch.int32, device=device)[None, :]
    dead = (idx < sub.num_runs[:, None]) & sub.run_deleted & (sub.run_len > 0)
    pos = torch.cumsum(dead.to(torch.int32), dim=1, dtype=torch.int32) - 1
    dst = torch.where(dead & (pos < width), pos, width).long()  # width = drop
    packed = []
    for field in (sub.run_client, sub.run_clock, sub.run_len):
        out = torch.zeros((rows, width + 1), dtype=torch.int32, device=device)
        out.scatter_(1, dst, field)
        packed.append(out[:, :width].reshape(-1))
    return torch.cat([dead.sum(dim=1, dtype=torch.int32), *packed])


# -- host-side extraction (test helpers) -------------------------------------


def expand_to_units(state: RleState, doc: int):
    """Document order as parallel unit arrays (client uint32, clock,
    deleted), sorted by rank: the comparison form of the tests."""
    n = int(state.num_runs[doc])
    client = state.run_client[doc][:n].cpu().numpy().view(np.uint32)
    clock = state.run_clock[doc][:n].cpu().numpy()
    length = state.run_len[doc][:n].cpu().numpy()
    rank = state.run_rank[doc][:n].cpu().numpy()
    deleted = state.run_deleted[doc][:n].cpu().numpy()
    keep = length > 0  # split heads shortened to zero never re-emit
    order = np.argsort(rank[keep])
    client, clock, length, deleted = (a[keep][order] for a in (client, clock, length, deleted))
    if not len(order):
        return np.zeros(0, np.uint32), np.zeros(0, np.int32), np.zeros(0, bool)
    return (
        np.repeat(client, length),
        np.concatenate([c + np.arange(l, dtype=np.int32) for c, l in zip(clock, length)]),
        np.repeat(deleted, length),
    )


def delete_ranges(state: RleState, doc: int) -> list[tuple[int, int, int]]:
    """Tombstones as sorted, merged (client, clock, length) ranges."""
    n = int(state.num_runs[doc])
    client = state.run_client[doc][:n].cpu().numpy().view(np.uint32)
    clock = state.run_clock[doc][:n].cpu().numpy()
    length = state.run_len[doc][:n].cpu().numpy()
    deleted = state.run_deleted[doc][:n].cpu().numpy()
    sel = deleted & (length > 0)
    merged: list[tuple[int, int, int]] = []
    for c, k, l in sorted(zip(client[sel].tolist(), clock[sel].tolist(), length[sel].tolist())):
        if merged and merged[-1][0] == c and merged[-1][1] + merged[-1][2] == k:
            merged[-1] = (c, merged[-1][1], merged[-1][2] + l)
        else:
            merged.append((c, k, l))
    return merged
