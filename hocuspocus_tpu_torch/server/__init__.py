"""The Hocuspocus server core: hook bus, documents, connections, fan-out.

A copy of the JAX package's `server/`. `Server` (the aiohttp HTTP and
WebSocket front end) resolves lazily, so the core imports where aiohttp
is not installed and drives clients through the in-process transport
(`provider.InProcessProviderSocket`) or `DirectConnection`.
"""

from .client_connection import ClientConnection
from .connection import Connection
from .debounce import Debouncer
from .direct_connection import DirectConnection
from .document import Document
from .hocuspocus import Hocuspocus, RequestInfo, REDIS_ORIGIN
from .types import REPLICA_ORIGIN, WAL_ORIGIN
from .message_receiver import MessageReceiver
from .overload import (
    OverloadController,
    OverloadExtension,
    get_overload_controller,
    resolve_tenant,
)
from .transports import CallbackWebSocketTransport
from .types import Configuration, ConnectionConfiguration, Extension, Payload


def __getattr__(name):
    if name == "Server":
        from .server import Server

        return Server
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ClientConnection",
    "Connection",
    "Debouncer",
    "DirectConnection",
    "Document",
    "Hocuspocus",
    "RequestInfo",
    "REDIS_ORIGIN",
    "WAL_ORIGIN",
    "REPLICA_ORIGIN",
    "MessageReceiver",
    "OverloadController",
    "OverloadExtension",
    "get_overload_controller",
    "resolve_tenant",
    "Server",
    "CallbackWebSocketTransport",
    "Configuration",
    "ConnectionConfiguration",
    "Extension",
    "Payload",
]
