"""In-process provider socket: full provider semantics with no OS socket.

Binds `HocuspocusProvider` instances directly to a `Hocuspocus` server
in the same process through the transport seam
(`Hocuspocus.handle_connection` + `CallbackWebSocketTransport`), so
embedders — and the at-scale load harness (the JAX package's `loadgen`) —
get the complete client pipeline (auth, SyncStep1/2, awareness,
unsynced-changes acking, multiplexing many documents per "socket")
without websockets, fd limits, or network framing overhead.

The reference's only in-process editing API is the hook-level
`DirectConnection` (`packages/server/src/DirectConnection.ts`); this
class goes further: the real provider runs against the real server
message pipeline (`ClientConnection.handleMessage` equivalent), which
is what makes socket-free load generation representative of production
behavior. The interface and event sequence mirror
`HocuspocusProviderWebsocket`
(`packages/provider/src/HocuspocusProviderWebsocket.ts`): construction
starts Connecting, and one scheduled "connect moment" flips status to
Connected, emits open/connect, and runs `on_open` for every attached
provider — so `on_connect`/`on_status` callbacks fire exactly as they
would over a real socket.

Ordering: both directions are drained by single pump tasks —
client→server frames apply strictly in send order (the server path is
awaited sequentially), and server→client frames arrive in transport
send order (CallbackWebSocketTransport's writer queue).
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

import logging

from ..aio import spawn_tracked
from .socket_base import ProviderSocketBase, WebSocketStatus

logger = logging.getLogger("hocuspocus_tpu_torch")


class InProcessProviderSocket(ProviderSocketBase):
    """Provider-socket lookalike wired straight into a Hocuspocus core.

    Parameters:
    - hocuspocus: the server core (a `Hocuspocus`, or a `Server` whose
      `.hocuspocus` is used).
    - context: default context dict passed to the connection's hook
      payloads (what the websocket host derives from the upgrade).
    - request: optional RequestInfo; defaults to a plain "/" request.
    """

    def __init__(self, hocuspocus, context: Optional[dict] = None, request=None) -> None:
        super().__init__()
        core = getattr(hocuspocus, "hocuspocus", hocuspocus)
        from ..server.hocuspocus import RequestInfo
        from ..server.transports import CallbackWebSocketTransport

        self._core = core
        self.provider_map: dict[str, Any] = {}
        self.status = WebSocketStatus.Connecting
        self.should_connect = True
        self._destroyed = False
        self._bg_tasks: set = set()
        self._in_queue: asyncio.Queue = asyncio.Queue()
        self._connected_event = asyncio.Event()

        self._transport = CallbackWebSocketTransport(
            send_async=self._deliver_to_client,
            close_async=self._closed_by_server,
        )
        # honor the server's session factory when given a Server: the
        # edge role (edge/server.py) terminates sessions in a relaying
        # EdgeClientSession, not a document-owning ClientConnection —
        # in-process load generation must exercise the same path the
        # websocket host serves
        session_factory = getattr(hocuspocus, "_create_session", None)
        if session_factory is not None:
            self._client_connection = session_factory(
                self._transport, request or RequestInfo(), dict(context or {})
            )
        else:
            self._client_connection = core.handle_connection(
                self._transport,
                request or RequestInfo(),
                dict(context or {}),
            )
        self._pump_task = asyncio.ensure_future(self._pump())
        # the "connect moment": scheduled, not inline, so providers
        # constructed right after this socket still observe the
        # Connecting→Connected transition (open/connect/status events +
        # on_open) in websocket order
        spawn_tracked(self._bg_tasks, self._establish())

    # -- lifecycle (socket-interface no-ops / teardown) --------------------

    async def _establish(self) -> None:
        if self._destroyed:
            return
        self._set_status(WebSocketStatus.Connected)
        self._connected_event.set()
        self.emit("open", {})
        self.emit("connect")
        for provider in list(self.provider_map.values()):
            spawn_tracked(self._bg_tasks, provider.on_open())

    def connect(self) -> None:
        pass

    async def wait_connected(self, timeout: float = 30) -> None:
        await asyncio.wait_for(self._connected_event.wait(), timeout)

    def disconnect(self) -> None:
        self.destroy()

    def destroy(self, code: int = 1000, reason: str = "destroyed") -> None:
        if self._destroyed:
            return
        self._destroyed = True
        self.emit("destroy")
        self._pump_task.cancel()
        self._transport.abort()
        task = asyncio.ensure_future(
            self._client_connection.handle_transport_close(code, reason)
        )
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)
        # same event sequence the websocket transport emits when the
        # connection dies (status -> close -> disconnect): providers
        # reset synced/authenticated in their "close" handler, so
        # skipping it would leave them synced=True on a dead socket
        self._set_status(WebSocketStatus.Disconnected)
        event = {"code": code, "reason": reason}
        self.emit("close", {"event": event})
        self.emit("disconnect", {"event": event})
        self._observers = {}

    # -- provider attachment (mirrors HocuspocusProviderWebsocket) ---------

    def attach(self, provider) -> None:
        self.provider_map[provider.name] = provider
        if not self._destroyed and self.status == WebSocketStatus.Connected:
            spawn_tracked(self._bg_tasks, provider.on_open())
        # else: _establish runs on_open at the connect moment

    # -- IO ----------------------------------------------------------------

    def send(self, data: bytes) -> None:
        if not self._destroyed:
            self._in_queue.put_nowait(data)

    async def _pump(self) -> None:
        while True:
            data = await self._in_queue.get()
            try:
                await self._client_connection.handle_message(data)
            except Exception as error:
                # mirror the websocket host (server.py websocket loop):
                # log, then tear the whole client connection down — a
                # silently dropped frame would leave providers hanging
                # un-synced with no diagnostic trail
                logger.error(f"in-process socket error: {error!r}")
                if not self._destroyed:
                    self.destroy(code=1011, reason="internal error")
                return

    async def _deliver_to_client(self, data: bytes) -> None:
        self._route_frame(data)

    async def _closed_by_server(self, code: int, reason: str) -> None:
        if self._destroyed:
            return
        self._set_status(WebSocketStatus.Disconnected)
        event = {"code": code, "reason": reason}
        self.emit("close", {"event": event})
        self.emit("disconnect", {"event": event})
