"""PermanentUserData — durable client-id -> user attribution.

Y.js-compatible (vendored bundle class eS): client ids are ephemeral
(every session mints a new one), so attributing edits and deletions to
HUMANS needs a CRDT-replicated registry. A shared map (root "users" by
default) holds one entry per user description with two arrays:

    users.<description>.ids : YArray[int]      every client id the user ever used
    users.<description>.ds  : YArray[bytes]    encoded DeleteSets of their deletions

`set_user_mapping` registers the local client and appends the delete
set of every local transaction; lookups answer "whose insertion is
this client id?" and "who deleted this struct id?" — exactly what
`YText.to_delta(snapshot, prev_snapshot, compute_ychange)` needs to
render version diffs with author names (see extensions/history.py and
docs/crdt.md).
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional

from .delete_set import DeleteSet, merge_delete_sets
from .encoding import Decoder, Encoder
from .types.yarray import YArray
from .types.ymap import YMap


def _defer(fn: Callable[[], None]) -> None:
    """Run after the current transaction settles (yjs setTimeout(0)):
    on a running event loop via call_soon, else immediately."""
    try:
        asyncio.get_running_loop().call_soon(fn)
    except RuntimeError:
        fn()


def _decode_ds(data: bytes) -> DeleteSet:
    return DeleteSet.read(Decoder(bytes(data)))


def _decode_ds_safe(data: Any) -> Optional[DeleteSet]:
    """The registry replicates from UNTRUSTED peers; junk bytes must
    not crash the observer (which can run inside another client's
    update emit on a server archive)."""
    if not isinstance(data, (bytes, bytearray)):
        return None
    try:
        return _decode_ds(data)
    except Exception:
        return None


def _encode_ds(ds: DeleteSet) -> bytes:
    encoder = Encoder()
    ds.write(encoder)
    return encoder.to_bytes()


class PermanentUserData:
    def __init__(self, doc: Any, ystore: Optional[YMap] = None) -> None:
        self.yusers = ystore if ystore is not None else doc.get_map("users")
        self.doc = doc
        self.clients: dict[int, str] = {}
        self.dss: dict[str, DeleteSet] = {}

        def init_user(user: Any, description: str) -> None:
            # the registry replicates from peers: a malformed entry
            # (plain value, missing arrays) is IGNORED, never raised —
            # this observer can fire inside another client's update
            # emit on a server-side archive
            if not isinstance(user, YMap):
                return
            ds = user.get("ds")
            ids = user.get("ids")
            if not isinstance(ds, YArray) or not isinstance(ids, YArray):
                return

            def add_client_id(client_id: Any) -> None:
                if isinstance(client_id, int) or (
                    isinstance(client_id, float) and client_id.is_integer()
                ):
                    self.clients[int(client_id)] = description

            def on_ds(event, _transaction) -> None:
                for item in event.changes["added"]:
                    for encoded in item.content.get_content():
                        decoded = _decode_ds_safe(encoded)
                        if decoded is not None:
                            self.dss[description] = merge_delete_sets(
                                [self.dss.get(description, DeleteSet()), decoded]
                            )

            ds.observe(on_ds)
            decoded_all = [
                d for d in (_decode_ds_safe(e) for e in ds.to_array()) if d is not None
            ]
            self.dss[description] = merge_delete_sets(decoded_all or [DeleteSet()])

            def on_ids(event, _transaction) -> None:
                for item in event.changes["added"]:
                    for client_id in item.content.get_content():
                        add_client_id(client_id)

            ids.observe(on_ids)
            for client_id in ids.to_array():
                add_client_id(client_id)

        def on_users(event, _transaction) -> None:
            for key in event.keys_changed:
                entry = self.yusers.get(key)
                if entry is not None:
                    init_user(entry, key)

        self.yusers.observe(on_users)
        for key in list(self.yusers.keys()):
            init_user(self.yusers.get(key), key)

    def set_user_mapping(
        self,
        doc: Any,
        client_id: int,
        description: str,
        filter: Callable[[Any, DeleteSet], bool] = lambda _tr, _ds: True,
    ) -> None:
        users = self.yusers
        user = users.get(description)
        if user is None:
            user = YMap()
            user.set("ids", YArray())
            user.set("ds", YArray())
            users.set(description, user)
        user.get("ids").push([client_id])

        def on_users_overwrite(_event, _transaction) -> None:
            def check() -> None:
                nonlocal user
                overwrite = users.get(description)
                if overwrite is not user and overwrite is not None:
                    # a CONCURRENT set_user_mapping for the same
                    # description won the map slot: re-add everything we
                    # know into the surviving entry (yjs does the same)
                    user = overwrite
                    for cid, desc in list(self.clients.items()):
                        if desc == description:
                            user.get("ids").push([cid])
                    ds = self.dss.get(description)
                    if ds is not None and ds.clients:
                        user.get("ds").push([_encode_ds(ds)])

            _defer(check)

        users.observe(on_users_overwrite)

        def after_transaction(transaction: Any, _doc: Any) -> None:
            def record() -> None:
                yds = user.get("ds")
                ds = transaction.delete_set
                if transaction.local and ds.clients and filter(transaction, ds):
                    yds.push([_encode_ds(ds)])

            _defer(record)

        doc.on("afterTransaction", after_transaction)

    def get_user_by_client_id(self, client_id: int) -> Optional[str]:
        return self.clients.get(int(client_id))

    def get_user_by_deleted_id(self, struct_id: Any) -> Optional[str]:
        for description, ds in self.dss.items():
            if ds.is_deleted(struct_id.client, struct_id.clock):
                return description
        return None
