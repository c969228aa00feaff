"""`Durability` extension: wires the WAL into the document lifecycle.

Placement in the hook chain (priority 900 — after the Metrics bracket,
before every persistence extension at the default 100):

- `on_store_document` (runs FIRST): capture the WAL position. Updates
  appended before this point are covered by the store about to run;
  anything appended later stays in the log. The window between this
  capture and the persistence extension's state encode is double
  -covered (in the store AND the WAL) — replay is idempotent, so
  conservative is correct.
- `after_store_document` (runs first, only on success): truncate the
  log through the captured position — but ONLY when a persistence
  extension actually confirmed coverage by setting `wal_covered` on the
  payload (the JAX package's `extensions/database.py` / `incremental.py`
  do; the port's persistence extensions are still to come). A server
  with no store backend keeps its whole WAL: it is the only durable
  state.
- `after_load_document` (runs BEFORE lower-priority hooks like the
  Redis join publish): replay the WAL suffix on top of whatever the
  persistence extension fetched. CRDT convergence makes replay order
  irrelevant; torn tail records were already dropped by the scan. The
  recovery report lands in the flight recorder and the WAL stats.
- capture seam: after replay the document's `wal_sink` is attached —
  `Document._handle_update` appends every update (except WAL-origin
  replays) BEFORE broadcast and gates the fan-out tick on the group
  commit future: no client is shown an update before its commit
  completes. A commit completing WITH a disk error still releases the
  gate — availability over durability; the error is counted,
  `/healthz` degrades, and the store pipeline remains the durability
  floor. `wal_checkpoint` lets the residency manager fold an eviction
  snapshot into the log (tpu/residency.py).
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

from ..crdt import apply_update
from ..observability.flight_recorder import get_flight_recorder
from ..server import logger
from ..server.types import Extension, Payload, WAL_ORIGIN
from .faults import FaultInjector
from .wal import REC_UPDATE, WalManager


class Durability(Extension):
    priority = 900

    def __init__(
        self,
        wal_dir: str,
        fsync: str = "tick",
        segment_max_bytes: int = 4 * 1024 * 1024,
        truncate_on_store: bool = True,
        store_after_recovery: bool = True,
        gate_broadcasts: bool = True,
        faults: Optional[FaultInjector] = None,
    ) -> None:
        self.wal = WalManager(
            wal_dir,
            fsync=fsync,
            segment_max_bytes=segment_max_bytes,
            faults=faults,
        )
        self.truncate_on_store = truncate_on_store
        self.store_after_recovery = store_after_recovery
        self.gate_broadcasts = gate_broadcasts
        self.last_recovery: "dict[str, dict]" = {}
        self._instance = None
        # degraded-health recency tracking: one transient disk error
        # must not latch /healthz degraded for the process lifetime
        self._seen_append_errors = 0
        self._last_append_error_at = 0.0
        self.error_degrade_window_s = 300.0

    # -- lifecycle ---------------------------------------------------------

    async def on_configure(self, data: Payload) -> None:
        self._instance = data.instance
        # overload control plane: group-commit latency feeds the
        # ladder's wal_commit_ms signal (server/overload.py)
        from ..server.overload import get_overload_controller

        get_overload_controller().register_wal(self.wal)

    async def after_load_document(self, data: Payload) -> None:
        document = data.document
        name = data.document_name
        records, report = await self.wal.replay(name)
        replayed = 0
        if records:
            for _rec_type, payload in records:
                try:
                    apply_update(document, payload, WAL_ORIGIN)
                    replayed += 1
                except Exception as error:
                    logger.log_error(
                        f"WAL replay: update rejected for {name!r}: {error!r}"
                    )
            report = {**report, "applied": replayed}
            self.last_recovery[name] = report
            get_flight_recorder().record(
                name,
                "wal_recovered",
                records=report["records"],
                bytes=report["bytes"],
                torn=report["torn_tail_records"],
                corrupt=report["corrupt_records"],
            )
        self._attach(document)
        if replayed and self.store_after_recovery and self._instance is not None:
            # fold the recovered suffix into a fresh snapshot soon, so
            # the log truncates instead of replaying forever
            self._instance.store_document_hooks(document, data)

    def _attach(self, document) -> None:
        name = document.name
        wal = self.wal

        def sink(update: bytes, origin: Any):
            if origin == WAL_ORIGIN:
                return None  # replays must not re-log themselves
            future = wal.append(name, update, REC_UPDATE)
            return future if self.gate_broadcasts else None

        def checkpoint(snapshot: bytes):
            return wal.checkpoint(name, snapshot)

        document.wal_sink = sink
        document.wal_checkpoint = checkpoint

    # -- store coverage ----------------------------------------------------

    async def on_store_document(self, data: Payload) -> None:
        data["_wal_position"] = self.wal.position(data.document_name)

    async def after_store_document(self, data: Payload) -> None:
        if not self.truncate_on_store or not data.get("wal_covered"):
            return
        position = data.get("_wal_position")
        if position is not None:
            self.wal.truncate_through(data.document_name, position - 1)

    async def after_unload_document(self, data: Payload) -> None:
        # drop the open handle; files survive unload exactly like the
        # store row does
        self.wal.forget(data.document_name)
        self.last_recovery.pop(data.document_name, None)

    async def on_destroy(self, data: Payload) -> None:
        try:
            await asyncio.wait_for(self.wal.flush(), timeout=5.0)
        except Exception:
            pass
        self.wal.close()

    # -- drain / health / metrics seams ------------------------------------

    async def flush_wal(self) -> None:
        """Drain seam (server/hocuspocus.py `drain`): everything
        buffered becomes durable before dirty docs are stored."""
        await self.wal.flush()

    def wal_stats(self) -> dict:
        return dict(self.wal.stats)

    def health_status(self) -> dict:
        import time

        stats = self.wal.stats
        if stats["append_errors"] > self._seen_append_errors:
            self._seen_append_errors = stats["append_errors"]
            self._last_append_error_at = time.monotonic()
        # degraded only while errors are RECENT: a healed disk stops
        # steering traffic away once the window passes
        degraded = (
            self._last_append_error_at > 0
            and time.monotonic() - self._last_append_error_at
            < self.error_degrade_window_s
        )
        return {
            "state": "append_errors" if degraded else "ok",
            "degraded": degraded,
            "wal": {
                "appended_records": stats["appended_records"],
                "append_errors": stats["append_errors"],
                "recovered_docs": stats["recovered_docs"],
                "torn_tail_records": stats["torn_tail_records"],
            },
        }
