"""Incremental append-log persistence with snapshot compaction.

The reference's persistence model rewrites the FULL document state on
every debounced store (`extension-database` Database.onStoreDocument →
`Y.encodeStateAsUpdate(document)`, reference
`packages/extension-database/src/Database.ts:55-60`), which scales with
document size, not edit size. This extension stores only the DELTA
since the last store (state-vector diff), appending rows to a log, and
periodically compacts the log into one snapshot row — the persistence
shape the catch-up-storm baseline (BASELINE.md config 5) wants:
snapshot + replay.

Correctness notes:
- A stale in-memory last-state-vector (e.g. after another instance
  stored under the distributed lock) only makes the next delta larger
  and overlapping — applying overlapping updates is idempotent.
- Deltas capture deletions too: encode_state_as_update(doc, sv)
  includes the delete set, and loading merges every row in order.
"""

from __future__ import annotations

import asyncio
import sqlite3
import threading
from typing import Optional

from ..crdt import encode_state_as_update, encode_state_vector, merge_updates
from ..server.types import Payload
from .database import Database

_EMPTY_DELTA = b"\x00\x00"  # 0 struct clients + empty delete set

SCHEMA = """CREATE TABLE IF NOT EXISTS "document_updates" (
  "seq" INTEGER PRIMARY KEY AUTOINCREMENT,
  "name" varchar(255) NOT NULL,
  "data" blob NOT NULL
);
CREATE INDEX IF NOT EXISTS "document_updates_name" ON "document_updates" ("name")"""


class IncrementalSQLite(Database):
    """SQLite-backed append-log store: deltas per store, compaction."""

    def __init__(
        self,
        database: str = ":memory:",
        compact_after: int = 64,
    ) -> None:
        super().__init__(fetch=self._fetch)  # store path overridden below
        self.database = database
        self.compact_after = compact_after
        self.db: Optional[sqlite3.Connection] = None
        self._last_sv: dict[str, bytes] = {}
        # save_mutex serializes stores per DOCUMENT; different documents
        # store concurrently on this one shared connection, so every db
        # access takes this lock — otherwise another document's commit()
        # lands mid-compaction and makes the DELETE durable without the
        # snapshot INSERT (data loss on crash)
        self._db_lock = threading.Lock()

    async def on_configure(self, data: Payload) -> None:
        if self.db is not None:
            self.db.close()
        self.db = sqlite3.connect(self.database, check_same_thread=False)
        self.db.executescript(SCHEMA)
        self.db.commit()

    async def _fetch(self, data: Payload) -> Optional[bytes]:
        if self.db is None:
            return None
        name = data.document_name

        def query() -> Optional[bytes]:
            with self._db_lock:
                rows = self.db.execute(
                    'SELECT data FROM "document_updates" WHERE name = ? ORDER BY seq',
                    (name,),
                ).fetchall()
            if not rows:
                return None
            return merge_updates([row[0] for row in rows])

        merged = await asyncio.to_thread(query)
        return merged

    async def on_load_document(self, data: Payload) -> None:
        await super().on_load_document(data)
        # remember what is durable so the first store is a pure delta
        self._last_sv[data.document_name] = encode_state_vector(data.document)

    async def on_store_document(self, data: Payload) -> None:
        if self.db is None:
            return
        name = data.document_name
        delta = encode_state_as_update(data.document, self._last_sv.get(name))
        if delta == _EMPTY_DELTA:
            # nothing new since the last store — the log rows already
            # cover everything, so the WAL may still truncate
            data["wal_covered"] = True
            return
        current_sv = encode_state_vector(data.document)

        def count_rows() -> int:
            with self._db_lock:
                return self.db.execute(
                    'SELECT COUNT(*) FROM "document_updates" WHERE name = ?', (name,)
                ).fetchone()[0]

        # document.save_mutex serializes stores per doc, so the count
        # cannot change between this read and the write below
        count = await asyncio.to_thread(count_rows)
        # compact when the log is long: one snapshot row replaces it
        # (encoded here, on the event loop, so the doc cannot mutate
        # mid-encode)
        snapshot = (
            encode_state_as_update(data.document)
            if count + 1 > self.compact_after
            else None
        )

        def write() -> None:
            with self._db_lock:
                if snapshot is not None:
                    self.db.execute(
                        'DELETE FROM "document_updates" WHERE name = ?', (name,)
                    )
                    self.db.execute(
                        'INSERT INTO "document_updates" ("name", "data") VALUES (?, ?)',
                        (name, snapshot),
                    )
                else:
                    self.db.execute(
                        'INSERT INTO "document_updates" ("name", "data") VALUES (?, ?)',
                        (name, delta),
                    )
                self.db.commit()

        await asyncio.to_thread(write)
        self._last_sv[name] = current_sv
        # delta (or snapshot) row committed: the WAL suffix up to the
        # Durability extension's captured position is covered
        data["wal_covered"] = True

    async def after_unload_document(self, data: Payload) -> None:
        self._last_sv.pop(data.document_name, None)

    async def on_destroy(self, data: Payload) -> None:
        if self.db is not None:
            self.db.close()
            self.db = None

    def log_length(self, name: str) -> int:
        """Rows currently in the log for `name` (tests/operations)."""
        if self.db is None:
            return 0
        with self._db_lock:
            return self.db.execute(
                'SELECT COUNT(*) FROM "document_updates" WHERE name = ?', (name,)
            ).fetchone()[0]
