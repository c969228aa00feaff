"""SQLite persistence extension (reference `extension-sqlite`).

Uses the stdlib sqlite3 driver; blocking calls run in a worker thread.
Schema: documents(name UNIQUE, data BLOB) with upsert-on-conflict.
"""

from __future__ import annotations

import asyncio
import sqlite3
import threading
from typing import Optional

from ..server.types import Payload
from .database import Database

SQLITE_INMEMORY = ":memory:"

SCHEMA = """CREATE TABLE IF NOT EXISTS "documents" (
  "name" varchar(255) NOT NULL,
  "data" blob NOT NULL,
  UNIQUE(name)
)"""

SELECT_QUERY = 'SELECT data FROM "documents" WHERE name = :name ORDER BY rowid DESC'

UPSERT_QUERY = """INSERT INTO "documents" ("name", "data") VALUES (:name, :data)
  ON CONFLICT(name) DO UPDATE SET data = :data"""


class SQLite(Database):
    def __init__(self, database: str = SQLITE_INMEMORY, schema: str = SCHEMA) -> None:
        super().__init__(fetch=self._fetch, store=self._store)
        self.database = database
        self.schema = schema
        self.db: Optional[sqlite3.Connection] = None
        # one connection, shared by the worker threads of concurrent loads
        # and stores: sqlite3 answers "bad parameter or other API misuse"
        # when two threads use it at once (a load storm of many docs), so
        # every access takes this lock, as IncrementalSQLite's do
        self._db_lock = threading.Lock()

    async def on_configure(self, data: Payload) -> None:
        self.db = sqlite3.connect(self.database, check_same_thread=False)
        self.db.execute(self.schema)
        self.db.commit()

    async def on_listen(self, data: Payload) -> None:
        if self.database == SQLITE_INMEMORY:
            import logging

            logging.getLogger("hocuspocus_tpu_torch").warning(
                "The SQLite extension is configured as an in-memory database. "
                "All changes will be lost on restart!"
            )

    async def _fetch(self, data: Payload) -> Optional[bytes]:
        if self.db is None:
            return None

        def query() -> Optional[bytes]:
            with self._db_lock:
                row = self.db.execute(SELECT_QUERY, {"name": data.document_name}).fetchone()
            return row[0] if row else None

        return await asyncio.to_thread(query)

    async def _store(self, data: Payload) -> None:
        if self.db is None:
            return

        def write() -> None:
            with self._db_lock:
                self.db.execute(
                    UPSERT_QUERY, {"name": data.document_name, "data": data["state"]}
                )
                self.db.commit()

        await asyncio.to_thread(write)

    async def on_destroy(self, data: Payload) -> None:
        if self.db is not None:
            self.db.close()
            self.db = None
