"""Update encode/apply: the Y.js v1 update format and its integration.

Covers applyUpdate / encodeStateAsUpdate / encodeStateVector /
mergeUpdates / diffUpdate / encodeStateVectorFromUpdate / snapshots —
the yjs API surface the reference server uses (SURVEY.md §2.2), including
the pending-structs machinery for causally-incomplete updates.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

from .delete_set import DeleteSet, merge_delete_sets
from .encoding import Decoder, Encoder
from .ids import ID
from .structs import GC, Item, Skip, Struct, StructStore, read_struct

if TYPE_CHECKING:
    from .doc import Doc, Transaction


# -- struct section read/write --------------------------------------------


def _read_client_struct_refs(decoder: Decoder) -> dict[int, dict]:
    """Read the structs section into {client: {"i": 0, "refs": [structs]}}."""
    refs: dict[int, dict] = {}
    num_of_state_updates = decoder.read_var_uint()
    for _ in range(num_of_state_updates):
        number_of_structs = decoder.read_var_uint()
        client = decoder.read_var_uint()
        clock = decoder.read_var_uint()
        client_refs: list[Struct] = []
        for _ in range(number_of_structs):
            struct = read_struct(decoder, ID(client, clock))
            client_refs.append(struct)
            clock += struct.length
        if client_refs:
            existing = refs.get(client)
            if existing is None:
                refs[client] = {"i": 0, "refs": client_refs}
            else:
                # multiple sections for one client (merged updates)
                existing["refs"].extend(client_refs)
                existing["refs"].sort(key=lambda s: s.id.clock)
    return refs


def _write_structs(encoder: Encoder, structs: list[Struct], client: int, clock: int) -> None:
    clock = max(clock, structs[0].id.clock)
    start = StructStore.find_index(structs, clock)
    encoder.write_var_uint(len(structs) - start)
    encoder.write_var_uint(client)
    encoder.write_var_uint(clock)
    first = structs[start]
    first.write(encoder, clock - first.id.clock)
    for i in range(start + 1, len(structs)):
        structs[i].write(encoder, 0)


def _write_clients_structs(encoder: Encoder, store: StructStore, target_sv: dict[int, int]) -> None:
    sm: dict[int, int] = {}
    for client, clock in target_sv.items():
        if store.get_state(client) > clock:
            sm[client] = clock
    for client in store.get_state_vector():
        if client not in target_sv:
            sm[client] = 0
    encoder.write_var_uint(len(sm))
    for client in sorted(sm, reverse=True):
        _write_structs(encoder, store.clients[client], client, sm[client])


def transaction_changed(transaction: "Transaction") -> bool:
    """Did this transaction add structs or delete anything? Gates both
    the update-event emit paths (wire reuse and store re-encode)."""
    return bool(transaction.delete_set.clients) or any(
        transaction.before_state.get(client, 0) != clock
        for client, clock in transaction.after_state.items()
    )


def write_update_message_from_transaction(encoder: Encoder, transaction: "Transaction") -> bool:
    if not transaction_changed(transaction):
        return False
    transaction.delete_set.sort_and_merge()
    _write_clients_structs(encoder, transaction.doc.store, transaction.before_state)
    transaction.delete_set.write(encoder)
    return True


# -- state vectors ---------------------------------------------------------


def encode_state_vector(doc_or_sv) -> bytes:
    sv = doc_or_sv.store.get_state_vector() if hasattr(doc_or_sv, "store") else doc_or_sv
    values = [len(sv)]
    for client in sorted(sv, reverse=True):
        values.append(client)
        values.append(sv[client])
    encoder = Encoder()
    encoder.write_var_uints(values)
    return encoder.to_bytes()


def decode_state_vector(data: bytes) -> dict[int, int]:
    decoder = Decoder(data)
    count = decoder.read_var_uint()
    flat = decoder.read_var_uints(count * 2)
    return dict(zip(flat[0::2], flat[1::2]))


# -- integration -----------------------------------------------------------


def _integrate_structs(
    transaction: "Transaction", store: StructStore, clients_struct_refs: dict[int, dict]
) -> Optional[dict]:
    """Integrate decoded structs; returns {missing, update} for leftovers."""
    stack: list[Struct] = []
    client_ids = sorted(clients_struct_refs.keys())
    if not client_ids:
        return None

    rest_structs: dict[int, list[Struct]] = {}
    missing_sv: dict[int, int] = {}

    def update_missing(client: int, clock: int) -> None:
        if client not in missing_sv or missing_sv[client] > clock:
            missing_sv[client] = clock

    def get_next_target() -> Optional[dict]:
        while client_ids:
            target = clients_struct_refs[client_ids[-1]]
            if target["i"] < len(target["refs"]):
                return target
            client_ids.pop()
        return None

    def add_stack_to_rest() -> None:
        for item in stack:
            client = item.id.client
            inapplicable = clients_struct_refs.get(client)
            if inapplicable is not None and inapplicable["refs"]:
                inapplicable["i"] -= 1
                rest_structs[client] = list(inapplicable["refs"][inapplicable["i"] :])
                clients_struct_refs.pop(client, None)
                inapplicable["i"] = 0
                inapplicable["refs"] = []
            else:
                rest_structs[client] = [item]
            if client in client_ids:
                client_ids.remove(client)
        stack.clear()

    cur_target = get_next_target()
    if cur_target is None:
        return None
    state: dict[int, int] = {}
    stack_head: Struct = cur_target["refs"][cur_target["i"]]
    cur_target["i"] += 1

    while True:
        if not isinstance(stack_head, Skip):
            client = stack_head.id.client
            local_clock = state.setdefault(client, store.get_state(client))
            offset = local_clock - stack_head.id.clock
            if offset < 0:
                # gap from the same client — this update depends on a missing one
                stack.append(stack_head)
                update_missing(client, stack_head.id.clock - 1)
                add_stack_to_rest()
            else:
                missing = stack_head.get_missing(transaction, store)
                if missing is not None:
                    stack.append(stack_head)
                    struct_refs = clients_struct_refs.get(missing, {"refs": [], "i": 0})
                    if len(struct_refs["refs"]) == struct_refs["i"]:
                        update_missing(missing, store.get_state(missing))
                        add_stack_to_rest()
                    else:
                        stack_head = struct_refs["refs"][struct_refs["i"]]
                        struct_refs["i"] += 1
                        continue
                elif offset == 0 or offset < stack_head.length:
                    if offset != 0:
                        # partial dedup: part of this struct was known
                        transaction.meta["input_dedup"] = True
                    stack_head.integrate(transaction, offset)
                    state[client] = stack_head.id.clock + stack_head.length
                else:
                    # fully-known struct skipped
                    transaction.meta["input_dedup"] = True
        # next struct
        if stack:
            stack_head = stack.pop()
        elif cur_target is not None and cur_target["i"] < len(cur_target["refs"]):
            stack_head = cur_target["refs"][cur_target["i"]]
            cur_target["i"] += 1
        else:
            cur_target = get_next_target()
            if cur_target is None:
                break
            stack_head = cur_target["refs"][cur_target["i"]]
            cur_target["i"] += 1

    if rest_structs:
        encoder = Encoder()
        encoder.write_var_uint(len(rest_structs))
        for client in sorted(rest_structs, reverse=True):
            structs = rest_structs[client]
            # the v1 reader assigns each struct's id from the RUNNING
            # clock, so clock holes (merged sections for one client, or
            # refs buffered around a wire Skip) must be made explicit as
            # Skip structs — exactly what the format uses them for.
            # Without them the pending retry decodes shifted ids and
            # corrupts the store (fuzz: "struct for clock N not found").
            with_skips: list[Struct] = [structs[0]]
            for struct in structs[1:]:
                prev = with_skips[-1]
                prev_end = prev.id.clock + prev.length
                gap = struct.id.clock - prev_end
                if gap > 0:
                    with_skips.append(Skip(ID(client, prev_end), gap))
                with_skips.append(struct)
            encoder.write_var_uint(len(with_skips))
            encoder.write_var_uint(client)
            encoder.write_var_uint(with_skips[0].id.clock)
            for struct in with_skips:
                struct.write(encoder, 0)
        encoder.write_var_uint(0)  # empty delete set
        return {"missing": missing_sv, "update": encoder.to_bytes()}
    return None


def _read_and_apply_delete_set(
    decoder: Decoder, transaction: "Transaction", store: StructStore
) -> Optional[bytes]:
    unapplied = DeleteSet()
    num_clients = decoder.read_var_uint()
    for _ in range(num_clients):
        client = decoder.read_var_uint()
        number_of_deletes = decoder.read_var_uint()
        structs = store.clients.get(client, [])
        state = store.get_state(client)
        for _ in range(number_of_deletes):
            clock = decoder.read_var_uint()
            dlen = decoder.read_var_uint()
            clock_end = clock + dlen
            if clock < state:
                if state < clock_end:
                    unapplied.add(client, state, clock_end - state)
                index = StructStore.find_index(structs, clock)
                struct = structs[index]
                if not struct.deleted and struct.id.clock < clock and isinstance(struct, Item):
                    structs.insert(index + 1, struct.split(transaction, clock - struct.id.clock))
                    index += 1
                while index < len(structs):
                    struct = structs[index]
                    index += 1
                    if struct.id.clock < clock_end:
                        if not struct.deleted and isinstance(struct, Item):
                            if clock_end < struct.id.clock + struct.length:
                                structs.insert(
                                    index, struct.split(transaction, clock_end - struct.id.clock)
                                )
                            struct.delete(transaction)
                        else:
                            # range covers already-deleted/GC'd content:
                            # the transaction's delete set will be
                            # narrower than the wire's
                            transaction.meta["input_dedup"] = True
                    else:
                        break
            elif dlen > 0:
                unapplied.add(client, clock, dlen)
    if unapplied.clients:
        return unapplied.encode()
    return None


def _is_redundant_update(store: StructStore, update: bytes) -> bool:
    """True when applying ``update`` is provably a state no-op: its delete
    set is empty and every struct run ends at or below the local clock
    frontier (the store's per-client lists are contiguous — anything
    ahead of the frontier goes to pending, so end <= state means fully
    known). Uses the native frontier scan (~µs); an update the scan
    cannot read is never claimed redundant."""
    from ..native import get_codec

    try:
        frontier, ds_empty = get_codec().scan_update_frontier(update)
    except ValueError:
        return False
    if not ds_empty:
        return False
    get_state = store.get_state
    return all(end <= get_state(client) for client, end in frontier)


def apply_update(doc: "Doc", update: bytes, transaction_origin: Any = None) -> None:
    # wire reuse is only sound when THIS call owns the whole transaction
    # (nested applies share a transaction whose content exceeds this
    # update; beforeTransaction-era listener mutations would too)
    dedicated = doc._transaction is None
    # Idempotent-redelivery fast-drop: broadcast storms, replication
    # echo, and catch-up replays routinely redeliver updates the doc
    # already integrated. A full decode+transact of such an update is a
    # pure no-op (~70µs); the native byte scan proves redundancy in ~2µs
    # and skips it. Only when this call owns the transaction — a nested
    # apply must keep feeding the shared transaction's bookkeeping.
    if dedicated and _is_redundant_update(doc.store, update):
        return

    def run(transaction: "Transaction") -> None:
        store = doc.store
        ds_had_pending = store.pending_ds is not None
        # a beforeTransaction listener may have already mutated the doc
        # inside this very transaction — then its content exceeds the
        # update even though we own the transact call
        pre_dirty = bool(transaction.changed) or bool(transaction.delete_set.clients)
        decoder = Decoder(update)
        refs = _read_client_struct_refs(decoder)
        rest = _integrate_structs(transaction, store, refs)
        pending = store.pending_structs
        if pending is not None:
            # check if the pending update now applies
            for client, clock in pending["missing"].items():
                if clock < store.get_state(client):
                    transaction.meta["retry_pending"] = True
                    break
            if rest is not None:
                for client, clock in rest["missing"].items():
                    if client not in pending["missing"] or pending["missing"][client] > clock:
                        pending["missing"][client] = clock
                pending["update"] = merge_updates([pending["update"], rest["update"]])
        else:
            store.pending_structs = rest
        ds_rest = _read_and_apply_delete_set(decoder, transaction, store)
        if store.pending_ds is not None:
            pending_ds_decoder = Decoder(store.pending_ds)
            pending_ds_decoder.read_var_uint()  # skip struct section (always 0 structs)
            ds_rest2 = _read_and_apply_delete_set(pending_ds_decoder, transaction, store)
            if ds_rest is None and ds_rest2 is None:
                store.pending_ds = None
            else:
                merged = merge_delete_sets(
                    [
                        DeleteSet.read(Decoder(d)) if d else DeleteSet()
                        for d in (ds_rest, ds_rest2)
                        if d is not None
                    ]
                )
                encoder = Encoder()
                encoder.write_var_uint(0)  # 0 structs
                merged.write(encoder)
                store.pending_ds = encoder.to_bytes()
        elif ds_rest is not None:
            encoder = Encoder()
            encoder.write_var_uint(0)
            DeleteSet.read(Decoder(ds_rest)).write(encoder)
            store.pending_ds = encoder.to_bytes()

        if (
            dedicated
            and not pre_dirty
            and rest is None
            and ds_rest is None
            and not ds_had_pending
            and not transaction.meta.get("input_dedup")
        ):
            # CLEAN apply: every struct integrated at offset 0, every
            # delete range was fresh, nothing went to (or drained from)
            # the pending buffers — the transaction's content is exactly
            # this update, so the "update" event can re-emit the wire
            # bytes verbatim instead of re-encoding from the store
            # (the remote-apply hot path: server fan-out and provider
            # receive both skip one full update encode)
            transaction.meta["wire_update"] = bytes(update)

    doc.transact(run, origin=transaction_origin, local=False)
    retry = doc.store.pending_structs is not None and any(
        clock < doc.store.get_state(client)
        for client, clock in doc.store.pending_structs["missing"].items()
    )
    if retry:
        pending_update = doc.store.pending_structs["update"]
        doc.store.pending_structs = None
        apply_update(doc, pending_update, transaction_origin)


def encode_state_as_update(doc: "Doc", encoded_target_sv: Optional[bytes] = None) -> bytes:
    target_sv = decode_state_vector(encoded_target_sv) if encoded_target_sv else {}
    encoder = Encoder()
    _write_clients_structs(encoder, doc.store, target_sv)
    create_delete_set_from_struct_store(doc.store).write(encoder)
    updates = [encoder.to_bytes()]
    if doc.store.pending_ds is not None:
        updates.append(doc.store.pending_ds)
    if doc.store.pending_structs is not None:
        updates.append(diff_update(doc.store.pending_structs["update"], encoded_target_sv or b"\x00"))
    if len(updates) > 1:
        return merge_updates(updates)
    return updates[0]


def create_delete_set_from_struct_store(store: StructStore) -> DeleteSet:
    ds = DeleteSet()
    for client, structs in store.clients.items():
        ranges: list[tuple[int, int]] = []
        i = 0
        while i < len(structs):
            struct = structs[i]
            if struct.deleted and not isinstance(struct, Skip):
                clock = struct.id.clock
                length = struct.length
                while i + 1 < len(structs) and structs[i + 1].deleted and not isinstance(structs[i + 1], Skip):
                    i += 1
                    length += structs[i].length
                ranges.append((clock, length))
            i += 1
        if ranges:
            ds.clients[client] = ranges
    return ds


# -- docless update utilities (merge/diff/sv-from-update) ------------------


def _read_update_parts(update: bytes) -> tuple[dict[int, list[Struct]], DeleteSet]:
    decoder = Decoder(update)
    refs = _read_client_struct_refs(decoder)
    ds = DeleteSet.read(decoder)
    return {client: entry["refs"] for client, entry in refs.items()}, ds


def merge_updates(updates: list[bytes]) -> bytes:
    """Merge updates without a Doc (yjs mergeUpdates equivalent).

    Combines struct runs per client (later/overlapping clocks deduplicated,
    gaps bridged with Skip structs) and merges delete sets.
    """
    if len(updates) == 1:
        return updates[0]
    all_structs: dict[int, list[Struct]] = {}
    dss: list[DeleteSet] = []
    for update in updates:
        structs, ds = _read_update_parts(update)
        dss.append(ds)
        for client, refs in structs.items():
            all_structs.setdefault(client, []).extend(refs)

    encoder = Encoder()
    client_sections: list[tuple[int, list[tuple[Struct, int]]]] = []
    for client in sorted(all_structs, reverse=True):
        refs = sorted(all_structs[client], key=lambda s: s.id.clock)
        # emit non-overlapping coverage; bridge gaps with Skip
        section: list[tuple[Struct, int]] = []  # (struct, offset)
        cur_clock = refs[0].id.clock
        for struct in refs:
            if isinstance(struct, Skip):
                continue
            end = struct.id.clock + struct.length
            if end <= cur_clock:
                continue
            if struct.id.clock > cur_clock:
                section.append((Skip(ID(client, cur_clock), struct.id.clock - cur_clock), 0))
                cur_clock = struct.id.clock
            offset = cur_clock - struct.id.clock
            section.append((struct, offset))
            cur_clock = end
        # drop trailing skip
        while section and isinstance(section[-1][0], Skip):
            section.pop()
        if section:
            client_sections.append((client, section))

    encoder.write_var_uint(len(client_sections))
    for client, section in client_sections:
        encoder.write_var_uint(len(section))
        encoder.write_var_uint(client)
        first_struct, first_offset = section[0]
        encoder.write_var_uint(first_struct.id.clock + first_offset)
        for struct, offset in section:
            struct.write(encoder, offset)
    merge_delete_sets(dss).write(encoder)
    return encoder.to_bytes()


def diff_update(update: bytes, encoded_sv: bytes) -> bytes:
    """Portion of `update` not covered by state vector `encoded_sv`."""
    sv = decode_state_vector(encoded_sv)
    structs, ds = _read_update_parts(update)
    encoder = Encoder()
    client_sections: list[tuple[int, list[tuple[Struct, int]]]] = []
    for client in sorted(structs, reverse=True):
        known = sv.get(client, 0)
        refs = [s for s in structs[client] if s.id.clock + s.length > known]
        section: list[tuple[Struct, int]] = []
        prev_end: Optional[int] = None
        for struct in refs:
            offset = max(0, known - struct.id.clock)
            if isinstance(struct, Skip):
                continue
            start_clock = struct.id.clock + offset
            if prev_end is not None and start_clock > prev_end:
                section.append((Skip(ID(client, prev_end), start_clock - prev_end), 0))
            section.append((struct, offset))
            prev_end = struct.id.clock + struct.length
        if section:
            client_sections.append((client, section))
    encoder.write_var_uint(len(client_sections))
    for client, section in client_sections:
        encoder.write_var_uint(len(section))
        encoder.write_var_uint(client)
        first_struct, first_offset = section[0]
        encoder.write_var_uint(first_struct.id.clock + first_offset)
        for struct, offset in section:
            struct.write(encoder, offset)
    ds.write(encoder)
    return encoder.to_bytes()


def encode_state_vector_from_update(update: bytes) -> bytes:
    structs, _ = _read_update_parts(update)
    sv: dict[int, int] = {}
    for client, refs in structs.items():
        refs = sorted(refs, key=lambda s: s.id.clock)
        clock = 0
        for struct in refs:
            if struct.id.clock != clock or isinstance(struct, Skip):
                break
            clock = struct.id.clock + struct.length
        if clock > 0:
            sv[client] = clock
    return encode_state_vector(sv)


# -- snapshots -------------------------------------------------------------


class Snapshot:
    __slots__ = ("ds", "sv")

    def __init__(self, ds: DeleteSet, sv: dict[int, int]) -> None:
        self.ds = ds
        self.sv = sv

    def encode(self) -> bytes:
        encoder = Encoder()
        self.ds.write(encoder)
        encoder.write_bytes(encode_state_vector(self.sv))
        return encoder.to_bytes()

    @staticmethod
    def decode(data: bytes) -> "Snapshot":
        decoder = Decoder(data)
        ds = DeleteSet.read(decoder)
        sv: dict[int, int] = {}
        for _ in range(decoder.read_var_uint()):
            client = decoder.read_var_uint()
            sv[client] = decoder.read_var_uint()
        return Snapshot(ds, sv)

    def equals(self, other: "Snapshot") -> bool:
        return self.sv == other.sv and self.ds.equals(other.ds)


def snapshot(doc: "Doc") -> Snapshot:
    return Snapshot(create_delete_set_from_struct_store(doc.store), doc.store.get_state_vector())


def is_visible(item: "Item", snap: "Optional[Snapshot]") -> bool:
    """Was this item's content visible at snapshot time? (yjs isVisible:
    created before the snapshot's state vector and not in its delete
    set; None means 'now' — simply not deleted.)"""
    if snap is None:
        return not item.deleted
    return (
        item.id.client in snap.sv
        and snap.sv.get(item.id.client, 0) > item.id.clock
        and not snap.ds.is_deleted(item.id.client, item.id.clock)
    )


def split_snapshot_affected_structs(transaction: "Transaction", snap: Snapshot) -> None:
    """Split structs at the snapshot's SV and delete-set boundaries so
    is_visible answers per whole item (yjs splitSnapshotAffectedStructs;
    memoized per transaction)."""
    # memoize the OBJECTS (not ids): an id() key outlives its object
    # and a recycled address would falsely skip a different snapshot
    seen = transaction.meta.setdefault("split_snapshots", set())
    if snap in seen:
        return
    store = transaction.doc.store
    for client, clock in snap.sv.items():
        if clock < store.get_state(client):
            store.get_item_clean_start(transaction, ID(client, clock))
    for client, clock, length in list(snap.ds.iterate()):
        store.iterate_structs(transaction, client, clock, length, lambda _s: None)
    seen.add(snap)


def create_doc_from_snapshot(origin: "Doc", snap: Snapshot, new_doc: "Optional[Doc]" = None) -> "Doc":
    """Materialize a NEW doc holding `origin` as of `snap` (yjs
    createDocFromSnapshot). Requires gc disabled on the origin —
    collected tombstones make historic states unreconstructable."""
    if origin.gc:
        raise ValueError(
            "createDocFromSnapshot requires Doc(gc=False) on the origin "
            "(collected structs cannot be restored)"
        )
    from .doc import Doc as _Doc

    if new_doc is None:
        new_doc = _Doc()
    encoder = Encoder()

    def run(transaction) -> None:
        active = [(c, clk) for c, clk in snap.sv.items() if clk > 0]
        encoder.write_var_uint(len(active))
        for client, clk in sorted(active, reverse=True):
            if clk < origin.store.get_state(client):
                origin.store.get_item_clean_start(transaction, ID(client, clk))
            structs = origin.store.clients[client]
            last = StructStore.find_index(structs, clk - 1)
            encoder.write_var_uint(last + 1)
            encoder.write_var_uint(client)
            encoder.write_var_uint(0)
            for i in range(last + 1):
                structs[i].write(encoder, 0)
        snap.ds.write(encoder)

    origin.transact(run)
    apply_update(new_doc, encoder.to_bytes(), "snapshot")
    return new_doc


def snapshot_contains_update(snap: Snapshot, update: bytes) -> bool:
    """True iff the snapshot already covers everything in `update`.

    Used by the server read-only path (reference
    `packages/server/src/MessageReceiver.ts:161-178`).
    """
    structs, ds = _read_update_parts(update)
    for client, refs in structs.items():
        known = snap.sv.get(client, 0)
        for struct in refs:
            if isinstance(struct, Skip):
                continue
            if struct.id.clock + struct.length > known:
                return False
    merged = merge_delete_sets([snap.ds, ds])
    return snap.ds.equals(merged)
