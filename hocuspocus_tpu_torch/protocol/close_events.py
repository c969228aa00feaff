"""WebSocket close events (reference `packages/common/src/CloseEvents.ts`)."""

from __future__ import annotations

from typing import NamedTuple


class CloseEvent(NamedTuple):
    code: int
    reason: str


MESSAGE_TOO_BIG = CloseEvent(1009, "Message Too Big")
# graceful drain (docs/guides/durability.md): 1012 is the standard
# "Service Restart" code — clients SHOULD reconnect (another instance,
# or this one after restart), unlike the 4xxx application rejections
SERVICE_RESTART = CloseEvent(1012, "Service Restart")
# overload control plane (docs/guides/overload.md): 1013 is the
# standard "Try Again Later" code — the server is shedding load, the
# client should back off and reconnect (the transport overflow policy
# and RED-state ingress enforcement both close with it)
TRY_AGAIN_LATER = CloseEvent(1013, "Try Again Later")
RESET_CONNECTION = CloseEvent(4205, "Reset Connection")
UNAUTHORIZED = CloseEvent(4401, "Unauthorized")
FORBIDDEN = CloseEvent(4403, "Forbidden")
CONNECTION_TIMEOUT = CloseEvent(4408, "Connection Timeout")


class CloseError(Exception):
    """Raised to close a connection with a specific close event."""

    def __init__(self, event: CloseEvent) -> None:
        super().__init__(event.reason)
        self.event = event
