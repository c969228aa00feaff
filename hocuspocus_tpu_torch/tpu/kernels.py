"""Batched text-CRDT arena and its plain PyTorch programs.

The PyTorch counterpart of the JAX package's `tpu/kernels.py`: the same
append-only, rank-ordered arena (one row per sequence, fixed capacity N)
and the same device programs, written as plain tensor code on an
explicit device. They serve twice: on a CPU tensor they ARE the plane's
device step, and on the card they are the reference every hand-written
kernel (`integrate.py`) is held against, bit for bit.

Representation (per row, capacity N):
  id_client/id_clock  — the unit's Yjs id; client ids are uint32 on the
                        wire and int32 BIT PATTERNS here (torch's uint32
                        support is partial); equality is bit equality,
                        and the one ordered compare (the YATA client-id
                        tiebreak) biases the sign bit
  rank                — current logical position (0..length-1); empty
                        slots hold 0x7FFFFFFF
  origin_rank         — current rank of the left origin (-1 = start)
  deleted             — tombstone flag (bool)
  length              — occupied slots (int32)
  overflow            — capacity exceeded (bool)

Ops are (kind, client, clock, run_len, left id, right id), all int32:
kind 0 = noop, 1 = insert run, 2 = delete id-range.

Functions that the JAX package runs with a donated state update the
state tensors IN PLACE and return the same NamedTuple.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

NONE_CLIENT = 0xFFFFFFFF  # "no origin" sentinel as a uint32 wire value
NONE_CLIENT_I32 = -1  # the same sentinel as an int32 bit pattern
_INF = 0x7FFFFFFF
_SIGN = -0x80000000  # xor with this maps uint32 order onto int32 order

KIND_NOOP = 0
KIND_INSERT = 1
KIND_DELETE = 2


class DocState(NamedTuple):
    """Dense arena for a batch of rows. Leading axis = row."""

    id_client: torch.Tensor  # (D, N) int32 (uint32 bit pattern)
    id_clock: torch.Tensor  # (D, N) int32
    rank: torch.Tensor  # (D, N) int32
    origin_rank: torch.Tensor  # (D, N) int32
    deleted: torch.Tensor  # (D, N) bool
    length: torch.Tensor  # (D,) int32
    overflow: torch.Tensor  # (D,) bool


class OpBatch(NamedTuple):
    """K op slots per column: every field is (K, B) int32."""

    kind: torch.Tensor
    client: torch.Tensor  # uint32 bit pattern
    clock: torch.Tensor
    run_len: torch.Tensor
    left_client: torch.Tensor  # uint32 bit pattern (-1 = doc start)
    left_clock: torch.Tensor
    right_client: torch.Tensor  # uint32 bit pattern (-1 = doc end)
    right_clock: torch.Tensor


def make_empty_state(num_docs: int, capacity: int, device) -> DocState:
    shape = (num_docs, capacity)
    return DocState(
        id_client=torch.full(shape, NONE_CLIENT_I32, dtype=torch.int32, device=device),
        id_clock=torch.zeros(shape, dtype=torch.int32, device=device),
        rank=torch.full(shape, _INF, dtype=torch.int32, device=device),
        origin_rank=torch.full(shape, -1, dtype=torch.int32, device=device),
        deleted=torch.zeros(shape, dtype=torch.bool, device=device),
        length=torch.zeros((num_docs,), dtype=torch.int32, device=device),
        overflow=torch.zeros((num_docs,), dtype=torch.bool, device=device),
    )


# -- carrying state across from the JAX package ------------------------------


def doc_state_from_numpy(fields: Sequence[np.ndarray], device) -> DocState:
    """The JAX package's DocState fields, as numpy arrays in field order
    (id_client uint32, deleted/overflow bool), as the port's tensors on
    `device`. A JAX DocState passed through np.asarray per field works
    as is."""
    idc, idk, rank, orank, dele, length, ovf = (np.asarray(f) for f in fields)

    def put(array, dtype):
        return torch.from_numpy(np.ascontiguousarray(array).astype(dtype, copy=True)).to(
            device
        )

    return DocState(
        id_client=put(idc.astype(np.uint32).view(np.int32), np.int32),
        id_clock=put(idk, np.int32),
        rank=put(rank, np.int32),
        origin_rank=put(orank, np.int32),
        deleted=put(dele, np.bool_),
        length=put(length, np.int32),
        overflow=put(ovf, np.bool_),
    )


def doc_state_to_numpy(state: DocState) -> DocState:
    """Inverse of doc_state_from_numpy: the fields as numpy arrays in the
    JAX package's dtypes (id_client uint32), held in a DocState."""
    out = [field.detach().cpu().numpy().copy() for field in state]
    out[0] = out[0].view(np.uint32)
    return DocState(*out)


def ops_from_numpy(fields: Sequence[np.ndarray], device) -> OpBatch:
    """An OpBatch of numpy arrays in the JAX package's dtypes (client
    fields uint32) as the port's int32 tensors on `device`."""
    out = []
    for field in fields:
        array = np.ascontiguousarray(np.asarray(field))
        if array.dtype == np.uint32:
            array = array.view(np.int32)
        out.append(torch.from_numpy(array.astype(np.int32, copy=True)).to(device))
    return OpBatch(*out)


# -- integrate (the plain version of the hand-written kernel) ---------------


def _integrate_rows(rows: DocState, op: Sequence[torch.Tensor]) -> DocState:
    """One op per row over (R, N) rows; op fields are (R,). The YATA
    math of the JAX package's `_integrate_one`, vectorised over rows."""
    idc, idk, rank, orank, dele, length, ovf = rows
    kind, client, clock, run, lc, lk, rc, rk = (f[:, None] for f in op)
    n = idc.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=idc.device)[None, :]
    len2 = length[:, None]
    occupied = idx < len2

    # resolve origin ids to ranks (masked row maxes; occupied ranks are
    # >= 0, so found-ness falls out of the max)
    is_left = occupied & (idc == lc) & (idk == lk)
    has_left = lc != NONE_CLIENT_I32
    left_raw = torch.where(is_left, rank, -1).amax(dim=1, keepdim=True)
    left_rank = torch.where(has_left, left_raw, -1)
    is_right = occupied & (idc == rc) & (idk == rk)
    has_right = rc != NONE_CLIENT_I32
    right_raw = torch.where(is_right, rank, -1).amax(dim=1, keepdim=True)
    right_rank = torch.where(has_right, right_raw, len2)

    # YATA conflict scan over the (left, right) rank window
    in_window = occupied & (rank > left_rank) & (rank < right_rank)
    client_lt = (idc ^ _SIGN) < (client ^ _SIGN)  # unsigned compare
    skip_cond = (orank > left_rank) | ((orank == left_rank) & client_lt)
    blocked = in_window & ~skip_cond
    first_block = torch.where(blocked, rank, _INF).amin(dim=1, keepdim=True)
    skipped = (in_window & (rank < first_block)).sum(dim=1, keepdim=True, dtype=torch.int32)
    ins_rank = left_rank + 1 + skipped

    fits = len2 + run <= n
    deps_ok = (~has_left | (left_raw >= 0)) & (~has_right | (right_raw >= 0))
    do_insert = (kind == KIND_INSERT) & fits & deps_ok

    # elementwise insert: bump ranks at/after the insertion rank, fill
    # the appended slots
    bump = do_insert & occupied
    rank_b = torch.where(bump & (rank >= ins_rank), rank + run, rank)
    orank_b = torch.where(bump & (orank >= ins_rank), orank + run, orank)
    slot_off = idx - len2
    in_new = do_insert & (slot_off >= 0) & (slot_off < run)
    is_first = slot_off == 0

    # delete: id-range tombstones over occupied slots
    in_del = (
        (kind == KIND_DELETE)
        & occupied
        & (idc == client)
        & (idk >= clock)
        & (idk < clock + run)
    )
    return DocState(
        id_client=torch.where(in_new, client, idc),
        id_clock=torch.where(in_new, clock + slot_off, idk),
        rank=torch.where(in_new, ins_rank + slot_off, rank_b),
        origin_rank=torch.where(
            in_new, torch.where(is_first, left_rank, ins_rank + slot_off - 1), orank_b
        ),
        deleted=(dele & ~in_new) | in_del,
        length=torch.where(do_insert[:, 0], length + run[:, 0], length),
        overflow=ovf | ((kind[:, 0] == KIND_INSERT) & ~fits[:, 0]),
    )


def _integrate_slots(rows: DocState, ops: OpBatch) -> DocState:
    for k in range(ops.kind.shape[0]):
        rows = _integrate_rows(rows, [field[k] for field in ops])
    return rows


def _copy_into(state: DocState, new: DocState) -> DocState:
    for field, value in zip(state, new):
        field.copy_(value)
    return state


def op_count(ops: OpBatch) -> torch.Tensor:
    """Ops the batch carries: kind != NOOP over every slot, padding
    columns and dropped ops included (the JAX step's returned count)."""
    return (ops.kind != KIND_NOOP).sum()


def integrate_op_slots(state: DocState, ops: OpBatch) -> tuple[DocState, torch.Tensor]:
    """Integrate K op slots into every row: ops fields are (K, D).

    Updates `state` in place (the JAX step donates it); returns it and
    the number of non-noop ops."""
    return _copy_into(state, _integrate_slots(state, ops)), op_count(ops)


def gather_doc_rows(state: DocState, slots: torch.Tensor) -> DocState:
    """Gather the rows `slots` names from every field of either arena's
    state. Out-of-range indices clip, as the JAX gather does."""
    index = slots.long().clamp(0, state[0].shape[0] - 1)
    return type(state)(*(field.index_select(0, index) for field in state))


def scatter_doc_rows(state: DocState, sub: DocState, slots: torch.Tensor) -> DocState:
    """Write gathered rows back in place; out-of-range indices drop."""
    index = slots.long()
    keep = (index >= 0) & (index < state[0].shape[0])
    index = index[keep]
    for field, sub_field in zip(state, sub):
        field.index_copy_(0, index, sub_field[keep])
    return state


def integrate_op_slots_sparse(
    state: DocState, ops: OpBatch, slots: torch.Tensor
) -> tuple[DocState, torch.Tensor]:
    """Integrate K op slots over the B rows `slots` routes to.

    ops fields are (K, B); slots is int32 (B,) mapping batch column to
    row, with num_docs as the padding sentinel (the gather clips, the
    scatter drops: padding never aliases a busy row). Updates `state`
    in place."""
    sub = _integrate_slots(gather_doc_rows(state, slots), ops)
    return scatter_doc_rows(state, sub, slots), op_count(ops)


# -- on-device compaction (tombstone GC) -------------------------------------


def compact_doc_rows(state: DocState, slots: torch.Tensor) -> tuple[DocState, torch.Tensor]:
    """Pack each routed row's live units into slots 0..L-1 in rank order,
    with dense ranks and predecessor-chained origin ranks; tombstones
    and the overflow flag clear. Same routing contract as the sparse
    integrate. Updates `state` in place; returns it and the packed live
    lengths (B,)."""
    sub = gather_doc_rows(state, slots)
    idc, idk, rank, _orank, dele, length, _ovf = sub
    rows, n = idc.shape
    device = idc.device
    idx = torch.arange(n, dtype=torch.int32, device=device)[None, :].expand(rows, n)
    live = (idx < length[:, None]) & ~dele
    new_len = live.sum(dim=1, dtype=torch.int32)
    # rank-indexed live mask; column n is the drop bucket
    live_by_rank = torch.zeros((rows, n + 1), dtype=torch.int32, device=device)
    live_by_rank.scatter_add_(
        1, torch.where(live, rank, n).long(), live.to(torch.int32)
    )
    packed_of_rank = torch.cumsum(live_by_rank[:, :n], dim=1, dtype=torch.int32) - 1
    dst = torch.where(
        live, packed_of_rank.gather(1, rank.clamp(0, n - 1).long()), n
    ).long()
    clients = torch.full((rows, n + 1), NONE_CLIENT_I32, dtype=torch.int32, device=device)
    clients.scatter_(1, dst, idc)
    clocks = torch.zeros((rows, n + 1), dtype=torch.int32, device=device)
    clocks.scatter_(1, dst, idk)
    in_new = idx < new_len[:, None]
    packed = DocState(
        id_client=clients[:, :n],
        id_clock=clocks[:, :n],
        rank=torch.where(in_new, idx, _INF),
        origin_rank=torch.where(in_new, idx - 1, -1),
        deleted=torch.zeros_like(dele),
        length=new_len,
        overflow=torch.zeros_like(length, dtype=torch.bool),
    )
    return scatter_doc_rows(state, packed, slots), new_len


def extract_live_mask(state: DocState) -> torch.Tensor:
    """(D, N) bool — live (non-tombstone) units."""
    n = state.id_client.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=state.length.device)
    return (idx[None, :] < state.length[:, None]) & ~state.deleted


def state_vector_diff(
    doc_clocks: torch.Tensor, client_clocks: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched catch-up triage: per (doc, client) the clock range the
    requester is missing, as (missing_from, missing_len)."""
    return (
        torch.minimum(client_clocks, doc_clocks),
        (doc_clocks - client_clocks).clamp(min=0),
    )


# -- minimal-work run merge (the sequential fast path) -----------------------


def append_run_slots_sparse(
    state: DocState,
    client: torch.Tensor,
    clock: torch.Tensor,
    run_len: torch.Tensor,
    slots: torch.Tensor,
) -> tuple[DocState, torch.Tensor]:
    """Fast-path integrate for B all-sequential columns.

    client/clock/run_len are (K, B) int32 coalesced tail-append runs
    (run_len == 0 is padding); slots is the (B,) routing vector with the
    sparse integrate's padding contract. The capacity ladder is the JAX
    program's: a run integrates while the chain is alive and it fits; a
    run that does not fit marks overflow and kills the chain, and a
    dead-chain run only flags overflow when it ALSO fails its own fits
    check against the unchanged length. Updates `state` in place;
    returns it and the applied-run count."""
    sub = gather_doc_rows(state, slots)
    idc, idk, rank, orank, dele, base, ovf = sub
    rows, n = idc.shape
    device = idc.device
    applied = torch.zeros_like(base)
    alive = torch.ones_like(ovf)
    over = ovf.clone()
    starts, lives = [], []
    for m in range(run_len.shape[0]):
        run = run_len[m]
        is_run = run > 0
        fits = base + applied + run <= n
        live = alive & fits & is_run
        starts.append(applied)
        applied = applied + torch.where(live, run, 0)
        over = over | (is_run & ~fits)
        alive = alive & (fits | ~is_run)
        lives.append(live)
    idx = torch.arange(n, dtype=torch.int32, device=device)[None, :]
    off = idx - base[:, None]
    in_new = torch.zeros_like(dele)
    for m, (start, live) in enumerate(zip(starts, lives)):
        start = start[:, None]
        in_run = live[:, None] & (off >= start) & (off < start + run_len[m][:, None])
        idc = torch.where(in_run, client[m][:, None], idc)
        idk = torch.where(in_run, clock[m][:, None] + (off - start), idk)
        in_new = in_new | in_run
    sub = DocState(
        id_client=idc,
        id_clock=idk,
        rank=torch.where(in_new, idx, rank),
        origin_rank=torch.where(in_new, idx - 1, orank),
        deleted=dele & ~in_new,
        length=base + applied,
        overflow=over,
    )
    count = torch.stack(lives).sum() if lives else torch.zeros((), dtype=torch.int64)
    return scatter_doc_rows(state, sub, slots), count


# -- on-device catch-up support (SyncStep2 serving) --------------------------


def tail_probe(state: DocState, slots: torch.Tensor) -> torch.Tensor:
    """Rank-tail ids of the requested rows as ONE (2B,) int32 readback
    [clients..., clocks...] (uint32 bit patterns). Masked SUMS: exactly
    one unit matches (dense ranks); an empty row reads as (0, 0)."""
    sub = gather_doc_rows(state, slots)
    tail = sub.rank == (sub.length - 1)[:, None]
    clients = torch.where(tail, sub.id_client, 0).sum(dim=1, dtype=torch.int32)
    clocks = torch.where(tail, sub.id_clock, 0).sum(dim=1, dtype=torch.int32)
    return torch.cat([clients, clocks])


def catchup_pack(state: DocState, slots: torch.Tensor, width: int) -> torch.Tensor:
    """Device-side SyncStep2 delete-set pack for the requested rows: ONE
    (B + 2*B*width,) int32 readback [counts, clients (B, width) flat,
    clocks (B, width) flat], tombstones in arena order. A row with more
    than `width` tombstones reports its true count (the host re-reads
    that row in full)."""
    sub = gather_doc_rows(state, slots)
    rows, n = sub.id_client.shape
    device = sub.id_client.device
    idx = torch.arange(n, dtype=torch.int32, device=device)[None, :]
    dead = (idx < sub.length[:, None]) & sub.deleted
    pos = torch.cumsum(dead.to(torch.int32), dim=1, dtype=torch.int32) - 1
    dst = torch.where(dead & (pos < width), pos, width).long()  # width = drop
    clients = torch.zeros((rows, width + 1), dtype=torch.int32, device=device)
    clients.scatter_(1, dst, sub.id_client)
    clocks = torch.zeros((rows, width + 1), dtype=torch.int32, device=device)
    clocks.scatter_(1, dst, sub.id_clock)
    return torch.cat(
        [
            dead.sum(dim=1, dtype=torch.int32),
            clients[:, :width].reshape(-1),
            clocks[:, :width].reshape(-1),
        ]
    )
