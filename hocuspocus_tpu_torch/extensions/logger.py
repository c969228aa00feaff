"""Hook-event logging extension (reference `extension-logger`)."""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Callable, Optional


from ..server.types import Extension, Payload


class Logger(Extension):
    def __init__(
        self,
        log: Optional[Callable[[str], None]] = None,
        on_load_document: bool = True,
        on_change: bool = True,
        on_store_document: bool = True,
        on_connect: bool = True,
        on_disconnect: bool = True,
        on_upgrade: bool = True,
        on_request: bool = True,
        on_destroy: bool = True,
        on_configure: bool = True,
    ) -> None:
        self._log = log or print
        self.flags = {
            "on_load_document": on_load_document,
            "on_change": on_change,
            "on_store_document": on_store_document,
            "on_connect": on_connect,
            "on_disconnect": on_disconnect,
            "on_upgrade": on_upgrade,
            "on_request": on_request,
            "on_destroy": on_destroy,
            "on_configure": on_configure,
        }
        self.name: Optional[str] = None

    def log(self, message: str) -> None:
        meta = datetime.now(timezone.utc).isoformat()
        if self.name:
            meta = f"{self.name} {meta}"
        self._log(f"[{meta}] {message}")

    async def on_configure(self, data: Payload) -> None:
        self.name = data.instance.configuration.name

    async def on_load_document(self, data: Payload) -> None:
        if self.flags["on_load_document"]:
            self.log(f'Loaded document "{data.document_name}".')

    async def on_change(self, data: Payload) -> None:
        if self.flags["on_change"]:
            self.log(f'Document "{data.document_name}" changed.')

    async def on_store_document(self, data: Payload) -> None:
        if self.flags["on_store_document"]:
            self.log(f'Store "{data.document_name}".')

    async def on_connect(self, data: Payload) -> None:
        if self.flags["on_connect"]:
            self.log(f'New connection to "{data.document_name}".')

    async def on_disconnect(self, data: Payload) -> None:
        if self.flags["on_disconnect"]:
            self.log(f'Connection to "{data.document_name}" closed.')

    async def on_upgrade(self, data: Payload) -> None:
        if self.flags["on_upgrade"]:
            self.log("Upgrading connection …")

    async def on_request(self, data: Payload) -> None:
        if self.flags["on_request"]:
            self.log(f"Incoming HTTP Request to {data.request.rel_url}")

    async def on_listen(self, data: Payload) -> None:
        pass

    async def on_destroy(self, data: Payload) -> None:
        if self.flags["on_destroy"]:
            self.log("Shut down.")
