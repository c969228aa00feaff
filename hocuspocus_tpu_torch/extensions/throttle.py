"""Connection throttling by IP (reference `extension-throttle`).

Sliding window: more than `throttle` connection attempts within
`considered_seconds` bans the IP for `ban_time` minutes; onConnect
rejects while banned (aborting the hook chain = connection refused).
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..server.types import Extension, Payload


class ThrottleRejection(Exception):
    def __init__(self) -> None:
        # empty message: rejection without an error log (reference throws
        # an empty rejection)
        super().__init__("")
        self.reason = "Too many connection attempts"


class Throttle(Extension):
    def __init__(
        self,
        throttle: Optional[int] = 15,
        considered_seconds: float = 60,
        ban_time: float = 5,
        cleanup_interval: float = 90,
    ) -> None:
        self.throttle_limit = throttle
        self.considered_seconds = considered_seconds
        self.ban_time = ban_time
        self.cleanup_interval = cleanup_interval
        self.connections_by_ip: dict[str, list[float]] = {}
        self.banned_ips: dict[str, float] = {}
        self._cleanup_task: Optional[asyncio.Task] = None

    async def on_configure(self, data: Payload) -> None:
        if self._cleanup_task is None:
            self._cleanup_task = asyncio.ensure_future(self._cleanup_loop())

    async def on_destroy(self, data: Payload) -> None:
        if self._cleanup_task is not None:
            self._cleanup_task.cancel()
            self._cleanup_task = None

    async def _cleanup_loop(self) -> None:
        while True:
            await asyncio.sleep(self.cleanup_interval)
            self.clear_maps()

    def clear_maps(self) -> None:
        now = time.monotonic()
        for ip in list(self.connections_by_ip):
            fresh = [
                t for t in self.connections_by_ip[ip] if t + self.considered_seconds > now
            ]
            if fresh:
                self.connections_by_ip[ip] = fresh
            else:
                del self.connections_by_ip[ip]
        for ip in list(self.banned_ips):
            if not self.is_banned(ip):
                del self.banned_ips[ip]

    def is_banned(self, ip: str) -> bool:
        banned_at = self.banned_ips.get(ip)
        if banned_at is None:
            return False
        return time.monotonic() < banned_at + self.ban_time * 60

    def _throttle(self, ip: str) -> bool:
        if not self.throttle_limit:
            return False
        if self.is_banned(ip):
            return True
        self.banned_ips.pop(ip, None)
        now = time.monotonic()
        attempts = self.connections_by_ip.get(ip, [])
        attempts.append(now)
        attempts = [t for t in attempts if t + self.considered_seconds > now]
        self.connections_by_ip[ip] = attempts
        if len(attempts) > self.throttle_limit:
            self.banned_ips[ip] = now
            return True
        return False

    async def on_connect(self, data: Payload) -> None:
        headers = data.request_headers or {}
        ip = (
            headers.get("x-real-ip")
            or headers.get("X-Real-IP")
            or headers.get("x-forwarded-for")
            or headers.get("X-Forwarded-For")
            or getattr(data.get("request"), "remote", None)
            or ""
        )
        if self._throttle(str(ip)):
            raise ThrottleRejection()
