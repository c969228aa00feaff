"""Shared client websocket (reference `HocuspocusProviderWebsocket.ts`).

Multiplexes many providers over one socket (routing inbound frames by the
peeked document name), reconnects with exponential backoff + jitter,
queues outbound messages while disconnected, and closes the socket when
no message arrives within `message_reconnect_timeout`.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Any, Optional

import aiohttp

from ..aio import spawn_tracked

from .socket_base import ProviderSocketBase, WebSocketStatus

__all__ = ["HocuspocusProviderWebsocket", "WebSocketStatus"]


class HocuspocusProviderWebsocket(ProviderSocketBase):
    def __init__(
        self,
        url: str,
        auto_connect: bool = True,
        message_reconnect_timeout: float = 30000,
        delay: float = 1000,
        initial_delay: float = 0,
        factor: float = 2,
        max_attempts: int = 0,
        min_delay: float = 1000,
        max_delay: float = 30000,
        min_reconnect_delay_ms: Optional[float] = None,
        max_reconnect_delay_ms: Optional[float] = None,
        jitter: bool = True,
        **callbacks: Any,
    ) -> None:
        super().__init__()
        self.url = url.rstrip("/")
        self.auto_connect = auto_connect
        self.message_reconnect_timeout = message_reconnect_timeout
        self.delay = delay
        self.initial_delay = initial_delay
        self.factor = factor
        self.max_attempts = max_attempts
        # min/max_reconnect_delay_ms are the configuration-surface
        # names (provider options); min_delay/max_delay kept as the
        # historical aliases
        self.min_delay = (
            min_reconnect_delay_ms if min_reconnect_delay_ms is not None else min_delay
        )
        self.max_delay = (
            max_reconnect_delay_ms if max_reconnect_delay_ms is not None else max_delay
        )
        self.jitter = jitter

        self.provider_map: dict[str, Any] = {}
        self.message_queue: list[bytes] = []
        self.status = WebSocketStatus.Disconnected
        self.should_connect = auto_connect
        self.last_message_received = 0.0
        self.ws: Optional[aiohttp.ClientWebSocketResponse] = None
        self._session: Optional[aiohttp.ClientSession] = None
        self._run_task: Optional[asyncio.Task] = None
        self._checker_task: Optional[asyncio.Task] = None
        self._connected_event = asyncio.Event()
        self._destroyed = False
        # outbound pump: ONE writer task drains this queue in order.
        # Per-send ensure_future tasks would be weakly referenced (the
        # loop can GC an unreferenced task mid-flight — a silent frame
        # drop) and could interleave under write backpressure.
        self._out_queue: asyncio.Queue = asyncio.Queue()
        self._pump_task: Optional[asyncio.Task] = None
        # strong refs for fire-and-forget helper tasks (on_open, closes)
        self._bg_tasks: set = set()

        for name, fn in callbacks.items():
            if name.startswith("on_") and callable(fn):
                self.on(name[3:], fn)

        if auto_connect:
            self.connect()

    # -- lifecycle ---------------------------------------------------------

    def connect(self) -> None:
        self.should_connect = True
        if self._run_task is None or self._run_task.done():
            self._run_task = asyncio.ensure_future(self._run())
        if self._checker_task is None or self._checker_task.done():
            self._checker_task = asyncio.ensure_future(self._connection_checker())

    async def wait_connected(self, timeout: float = 30) -> None:
        await asyncio.wait_for(self._connected_event.wait(), timeout)

    def disconnect(self) -> None:
        self.should_connect = False
        self.message_queue = []
        if self.ws is not None and not self.ws.closed:
            self._spawn(self.ws.close())

    def destroy(self) -> None:
        if self._destroyed:
            return
        self._destroyed = True
        self.emit("destroy")
        self.disconnect()
        for task in (self._run_task, self._checker_task):
            if task is not None:
                task.cancel()
        if self._pump_task is not None:
            self._pump_task.cancel()
        if self._session is not None:
            self._spawn(self._session.close())
        self._observers = {}

    # -- provider attachment ----------------------------------------------

    def attach(self, provider) -> None:
        self.provider_map[provider.name] = provider
        if self.status == WebSocketStatus.Disconnected and self.should_connect:
            self.connect()
        if self.status == WebSocketStatus.Connected:
            self._spawn(provider.on_open())

    # -- IO ----------------------------------------------------------------

    def send(self, data: bytes) -> None:
        if self.ws is not None and not self.ws.closed and self.status == WebSocketStatus.Connected:
            self._out_queue.put_nowait(data)
        else:
            self.message_queue.append(data)

    def _spawn(self, coro) -> None:
        spawn_tracked(self._bg_tasks, coro)

    async def _pump(self, ws) -> None:
        """Drain the outbound queue to one socket, preserving order.
        A send failure re-queues nothing — the reconnect SyncStep1/2
        exchange makes recovery lossless (reference provider behavior
        on reopen) — but it MUST tear the socket down: otherwise the
        read side can stay open with no outbound consumer, status
        stuck Connected, every later frame silently swallowed."""
        while True:
            data = await self._out_queue.get()
            try:
                await ws.send_bytes(data)
            except Exception:
                try:
                    await ws.close()
                except Exception:
                    pass
                return

    @property
    def min_reconnect_delay_ms(self) -> float:
        return self.min_delay

    @property
    def max_reconnect_delay_ms(self) -> float:
        return self.max_delay

    async def _run(self) -> None:
        # two ladders: `failures` counts CONSECUTIVE connect failures
        # (the max_attempts give-up check — resets on any successful
        # connect, the original semantic); `flap` counts connections
        # that dropped instantly without a message (accept-then-drop
        # servers), feeding the backoff only — an established-then-
        # flapped connection must never burn the give-up budget
        failures = 0
        flap = 0
        if self.initial_delay:
            await asyncio.sleep(self.initial_delay / 1000)
        while self.should_connect and not self._destroyed:
            if self._session is None or self._session.closed:
                self._session = aiohttp.ClientSession()
            self._set_status(WebSocketStatus.Connecting)
            try:
                ws = await self._session.ws_connect(
                    self.url, autoping=True, max_msg_size=0, heartbeat=None
                )
            except Exception:
                failures += 1
                if self.max_attempts and failures >= self.max_attempts:
                    self._set_status(WebSocketStatus.Disconnected)
                    return
                await asyncio.sleep(self._backoff_delay(max(failures, flap)))
                continue
            failures = 0
            self.ws = ws
            connected_at = time.monotonic()
            self.last_message_received = 0.0
            self._out_queue = asyncio.Queue()  # no frames from a dead socket
            self._pump_task = asyncio.ensure_future(self._pump(ws))
            self._set_status(WebSocketStatus.Connected)
            self._connected_event.set()
            self.emit("open", {})
            self.emit("connect")
            # notify providers so they authenticate + start sync
            for provider in list(self.provider_map.values()):
                self._spawn(provider.on_open())
            # flush messages queued while disconnected
            queue, self.message_queue = self.message_queue, []
            for data in queue:
                self._out_queue.put_nowait(data)
            close_event = {"code": 1000, "reason": ""}
            try:
                async for msg in ws:
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        self._on_message(msg.data)
                    elif msg.type in (aiohttp.WSMsgType.ERROR, aiohttp.WSMsgType.CLOSED):
                        break
            except Exception:
                pass
            close_event = {"code": ws.close_code or 1000, "reason": ""}
            self.ws = None
            if self._pump_task is not None:
                self._pump_task.cancel()
                self._pump_task = None
            # frames queued but never written survive into the
            # disconnected buffer: sync frames are idempotent and
            # stateless/awareness frames are NOT recovered by the
            # reopen sync exchange, so dropping them would lose them
            while not self._out_queue.empty():
                self.message_queue.append(self._out_queue.get_nowait())
            self._connected_event.clear()
            self._set_status(WebSocketStatus.Disconnected)
            self.emit("close", {"event": close_event})
            self.emit("disconnect", {"event": close_event})
            # a connection that RECEIVED something (or survived a while)
            # resets the flap ladder; a flapping server that accepts
            # then immediately drops keeps climbing — without this,
            # every successful-but-instant connect snapped the delay
            # back to the floor and reconnects hammered at a fixed
            # cadence
            if self.last_message_received or time.monotonic() - connected_at >= 1.0:
                flap = 0
            else:
                flap += 1
            if self.should_connect and not self._destroyed:
                await asyncio.sleep(self._backoff_delay(max(flap, 1)))

    def _backoff_delay(self, attempt: int) -> float:
        """Capped exponential backoff with full jitter: the ceiling
        doubles per consecutive failed attempt (bounded by
        max_reconnect_delay_ms) and the actual delay is drawn uniformly
        from [min_reconnect_delay_ms, ceiling] — a herd of reconnecting
        clients spreads instead of thundering."""
        ceiling = min(
            self.delay * (self.factor ** max(attempt - 1, 0)), self.max_delay
        )
        ceiling = max(ceiling, self.min_delay)
        if self.jitter:
            return random.uniform(self.min_delay, ceiling) / 1000
        return ceiling / 1000

    def _on_message(self, data: bytes) -> None:
        self.last_message_received = time.monotonic()
        self._route_frame(data)

    async def _connection_checker(self) -> None:
        interval = self.message_reconnect_timeout / 10 / 1000
        close_tries = 0
        while not self._destroyed:
            await asyncio.sleep(interval)
            if self.status != WebSocketStatus.Connected or not self.last_message_received:
                continue
            elapsed_ms = (time.monotonic() - self.last_message_received) * 1000
            if elapsed_ms <= self.message_reconnect_timeout:
                continue
            # No message for too long — not even awareness pings.
            close_tries += 1
            if self.ws is not None:
                self.message_queue = []
                await self.ws.close()
            if close_tries > 2:
                close_tries = 0
