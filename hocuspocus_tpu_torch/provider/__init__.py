"""The client provider: a Doc and its awareness bound to a server document
over a multiplexing socket.

A copy of the JAX package's `provider/`, with the history client. The
websocket socket (aiohttp) resolves lazily, so the in-process socket
works where aiohttp is not installed.
"""

from .history import HistoryClient, HistoryError
from .inprocess import InProcessProviderSocket
from .message_receiver import MessageReceiver
from .provider import AwarenessError, HocuspocusProvider
from .socket_base import WebSocketStatus


def __getattr__(name):
    if name == "HocuspocusProviderWebsocket":
        from .websocket import HocuspocusProviderWebsocket

        return HocuspocusProviderWebsocket
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "HistoryClient",
    "HistoryError",
    "InProcessProviderSocket",
    "MessageReceiver",
    "AwarenessError",
    "HocuspocusProvider",
    "HocuspocusProviderWebsocket",
    "WebSocketStatus",
]
