"""Generic persistence extension (reference `extension-database`).

The user supplies async `fetch`/`store` callables; onLoadDocument applies
the fetched update, onStoreDocument persists the full encoded state.
"""

from __future__ import annotations

from typing import Awaitable, Callable, Optional

from ..crdt import apply_update, encode_state_as_update
from ..server.types import Extension, Payload


class Database(Extension):
    def __init__(
        self,
        fetch: Optional[Callable[[Payload], Awaitable[Optional[bytes]]]] = None,
        store: Optional[Callable[[Payload], Awaitable[None]]] = None,
    ) -> None:
        self.fetch = fetch or (lambda data: _none())
        self.store = store or (lambda data: _noop())
        # WAL truncation seam (storage/extension.py): only a REAL store
        # may declare the log covered — a Database() with the default
        # no-op store persists nothing, and truncating on its "success"
        # would delete the only durable copy of every update
        self._covers_wal = store is not None

    async def on_load_document(self, data: Payload) -> None:
        update = await self.fetch(data)
        if update:
            apply_update(data.document, update)

    async def on_store_document(self, data: Payload) -> None:
        data["state"] = encode_state_as_update(data.document)
        await self.store(data)
        if self._covers_wal:
            # everything encoded into `state` is durable downstream:
            # the Durability extension may truncate the WAL through the
            # position it captured before this chain began
            data["wal_covered"] = True


async def _none() -> None:
    return None


async def _noop() -> None:
    return None
