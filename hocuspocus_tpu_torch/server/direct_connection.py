"""In-process document editing without a socket (reference
`DirectConnection.ts` equivalent)."""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional

from .types import Payload


class DirectConnection:
    def __init__(self, document, instance, context: Any = None) -> None:
        self.document = document
        self.instance = instance
        self.context = context
        document.add_direct_connection()

    def _store_payload(self) -> Payload:
        return Payload(
            clients_count=self.document.get_connections_count(),
            context=self.context,
            document=self.document,
            document_name=self.document.name,
            instance=self.instance,
            request_headers={},
            request_parameters={},
            socket_id="server",
        )

    async def transact(self, transaction: Callable) -> None:
        if self.document is None:
            raise RuntimeError("direct connection closed")
        result = transaction(self.document)
        if asyncio.iscoroutine(result):
            await result
        task = self.instance.store_document_hooks(
            self.document, self._store_payload(), immediately=True
        )
        if task is not None:
            await task

    async def disconnect(self) -> None:
        if self.document is None:
            return
        document = self.document
        document.remove_direct_connection()
        task = self.instance.store_document_hooks(
            document, self._store_payload(), immediately=True
        )
        if task is not None:
            await task
        if document.get_connections_count() == 0 and not document.save_mutex.locked():
            await self.instance.hooks(
                "on_disconnect",
                Payload(
                    instance=self.instance,
                    clients_count=document.get_connections_count(),
                    context=self.context,
                    document=document,
                    socket_id="server",
                    document_name=document.name,
                    request_headers={},
                    request_parameters={},
                ),
            )
            await self.instance.unload_document(document)
        self.document = None
