"""HistoryClient — awaitable client API over the History extension.

Wraps the stateless JSON protocol (extensions/history.py) into
futures: requests correlate to their replies by a client-generated
request id the server echoes back (kind-in-order fallback for rid-less
events), broadcast events (`history.checkpointed` / `history.restored`)
surface through the provider's observable interface, and previews come
back as a reconstructed `Doc`.

    history = HistoryClient(provider)
    version = await history.checkpoint("before cleanup")
    versions = await history.list()
    old_doc = await history.preview(versions[0]["id"])
    delta = await history.diff(versions[0]["id"], root="t")
    await history.restore(versions[0]["id"])
"""

from __future__ import annotations

import asyncio
import base64
import json
import uuid
from typing import Any, Optional

from ..crdt import Doc, apply_update


class HistoryError(Exception):
    pass


# reply event each request resolves on
_REPLY_EVENT = {
    "history.checkpoint": "history.checkpointed",
    "history.list": "history.versions",
    "history.preview": "history.preview",
    "history.restore": "history.restored",
    "history.diff": "history.diff",
}


class HistoryClient:
    """Correlation: every request carries a client-generated "rid" the
    server echoes in its reply/error AND in the broadcasts the request
    triggers (`history.checkpointed` / `history.restored`), so each
    event resolves exactly the request that caused it — another
    client's concurrent same-kind broadcast (a different rid) can no
    longer resolve your waiter, and an error rejects the request that
    actually failed instead of the oldest pending one. Events without
    a rid (older servers, server-initiated store checkpoints) fall
    back to the legacy kind-in-send-order match."""

    def __init__(self, provider: Any, timeout: float = 10.0) -> None:
        self.provider = provider
        self.timeout = timeout
        self._pending: list = []  # (rid, reply_kind, future), send order
        self._rid_prefix = uuid.uuid4().hex[:12]
        self._rid_seq = 0
        provider.on("stateless", self._on_stateless)

    def _on_stateless(self, data: dict) -> None:
        try:
            event = json.loads(data["payload"])
        except (TypeError, ValueError, KeyError):
            return
        if not isinstance(event, dict):
            return
        kind = event.get("event", "")
        if not kind.startswith("history."):
            return
        rid = event.get("rid")
        if kind == "history.error":
            if rid is not None:
                # exact routing: reject the request that failed
                for i, (want_rid, _want, future) in enumerate(self._pending):
                    if want_rid == rid:
                        del self._pending[i]
                        if not future.done():
                            future.set_exception(
                                HistoryError(event.get("error", "unknown"))
                            )
                        return
                return  # someone else's failure
            # legacy server (no rid echo): the failing request is the
            # OLDEST one still outstanding
            if self._pending:
                _rid, _kind, future = self._pending.pop(0)
                if not future.done():
                    future.set_exception(HistoryError(event.get("error", "unknown")))
            return
        if rid is not None:
            for i, (want_rid, want, future) in enumerate(self._pending):
                if want_rid == rid and want == kind:
                    del self._pending[i]
                    if not future.done():
                        future.set_result(event)
                    return
            return  # another client's action: not ours to resolve
        if event.get("origin") == "store":
            # server-initiated store checkpoint: a broadcast, never the
            # reply to a pending request — resolving a waiter with it
            # would hand back the wrong version id
            return
        # rid-less event (legacy server): kind-in-send-order fallback
        for i, (_rid, want, future) in enumerate(self._pending):
            if want == kind:
                del self._pending[i]
                if not future.done():
                    future.set_result(event)
                return

    async def _request(self, action: str, **fields: Any) -> dict:
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._rid_seq += 1
        rid = f"{self._rid_prefix}-{self._rid_seq}"
        entry = (rid, _REPLY_EVENT[action], future)
        self._pending.append(entry)
        self.provider.send_stateless(
            json.dumps({"action": action, "rid": rid, **fields})
        )
        try:
            return await asyncio.wait_for(future, self.timeout)
        finally:
            # a timed-out request must unregister, or its dead entry
            # swallows the next same-kind reply (and error routing)
            if entry in self._pending:
                self._pending.remove(entry)

    async def checkpoint(self, label: Optional[str] = None) -> dict:
        """Mint a version; resolves with {id, label, ts} (the broadcast
        every client receives)."""
        fields = {"label": label} if label is not None else {}
        event = await self._request("history.checkpoint", **fields)
        return {k: event[k] for k in ("id", "label", "ts")}

    async def list(self) -> list[dict]:
        event = await self._request("history.list")
        return event["versions"]

    async def preview(self, version_id: int) -> Doc:
        """The checkpointed document, reconstructed client-side."""
        event = await self._request("history.preview", id=version_id)
        doc = Doc()
        apply_update(doc, base64.b64decode(event["update"]), "history.preview")
        return doc

    async def diff(
        self,
        version_id: int,
        root: str = "default",
        until: Optional[int] = None,
    ) -> list[dict]:
        """ychange-marked delta of `root` between a version and now (or
        `until`), author-attributed when the doc replicates a
        PermanentUserData registry."""
        fields: dict = {"id": version_id, "root": root}
        if until is not None:
            fields["until"] = until
        event = await self._request("history.diff", **fields)
        return event["delta"]

    async def restore(self, version_id: int) -> None:
        await self._request("history.restore", id=version_id)

    def destroy(self) -> None:
        self.provider.off("stateless", self._on_stateless)
        for _rid, _kind, future in self._pending:
            if not future.done():
                future.cancel()
        self._pending.clear()
