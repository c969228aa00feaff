"""Behavior shared by every provider-socket transport.

`HocuspocusProviderWebsocket` (OS socket) and `InProcessProviderSocket`
(same-process seam) must stay behaviorally identical from a provider's
point of view — status transitions, the detach close-message, and
inbound frame routing by peeked document name (reference
`HocuspocusProviderWebsocket.ts:127-132, 231-243`). Centralizing them
here keeps the two transports from drifting.
"""

from __future__ import annotations

from enum import Enum
from typing import Any

from ..crdt.doc import Observable
from ..crdt.encoding import Decoder


class WebSocketStatus(str, Enum):
    Connecting = "connecting"
    Connected = "connected"
    Disconnected = "disconnected"


class ProviderSocketBase(Observable):
    """Common provider-facing surface of a socket transport."""

    provider_map: dict[str, Any]
    status: WebSocketStatus

    def detach(self, provider) -> None:
        if provider.name in self.provider_map:
            from ..protocol.message import OutgoingMessage

            provider.send(OutgoingMessage(provider.name).write_close_message("closed"))
            del self.provider_map[provider.name]

    def _set_status(self, status: WebSocketStatus) -> None:
        if self.status != status:
            self.status = status
            self.emit("status", {"status": status})

    def _route_frame(self, data: bytes) -> None:
        """Emit the raw frame and deliver it to the provider whose
        document name prefixes it (multiplexing seam)."""
        self.emit("message", {"data": data})
        try:
            document_name = Decoder(data).read_var_string()
        except Exception:
            return
        provider = self.provider_map.get(document_name)
        if provider is not None:
            provider.on_message(data)
