"""Minimal asyncio Redis (RESP2) client.

The runtime image has no redis driver, so the framework ships its own:
a command client and a dedicated pub/sub subscriber connection — the two
roles the Redis fan-out extension needs (reference `extension-redis`
uses ioredis pub + sub clients the same way).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Callable, Optional, Union

CRLF = b"\r\n"

RELEASE_LOCK_SCRIPT = (
    'if redis.call("get",KEYS[1]) == ARGV[1] then return redis.call("del",KEYS[1]) '
    "else return 0 end"
)

# compare-and-pexpire: extend a held lock without a release/re-acquire
# window (the reference's redlock extends the same way)
EXTEND_LOCK_SCRIPT = (
    'if redis.call("get",KEYS[1]) == ARGV[1] then return redis.call("pexpire",KEYS[1],ARGV[2]) '
    "else return 0 end"
)

# CRC16-CCITT (XModem) — redis cluster's key->slot hash
_CRC16_TABLE = []
for _byte in range(256):
    _crc = _byte << 8
    for _ in range(8):
        _crc = ((_crc << 1) ^ 0x1021) if (_crc & 0x8000) else (_crc << 1)
    _CRC16_TABLE.append(_crc & 0xFFFF)


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[((crc >> 8) & 0xFF) ^ b]
    return crc


def key_hash_slot(key: Union[str, bytes]) -> int:
    """Redis cluster slot for a key, honoring {hash tags}."""
    if isinstance(key, str):
        key = key.encode()
    start = key.find(b"{")
    if start != -1:
        end = key.find(b"}", start + 1)
        if end != -1 and end != start + 1:
            key = key[start + 1 : end]
    return crc16(key) % 16384


def encode_command(*args: Union[bytes, str, int, float]) -> bytes:
    out = bytearray(b"*%d\r\n" % len(args))
    for arg in args:
        if isinstance(arg, (int, float)):
            arg = str(arg)
        if isinstance(arg, str):
            arg = arg.encode()
        out += b"$%d\r\n" % len(arg)
        out += arg
        out += CRLF
    return bytes(out)


def encode_publish_segments(
    channel: str, segments: "list[bytes | memoryview]"
) -> "tuple[bytes | memoryview, ...]":
    """Zero-copy PUBLISH: the RESP framing is built fresh but the payload
    segments (e.g. an envelope header + a memoryview of the shared
    broadcast frame — edge/relay.py encode_envelope_view) ride through
    to the socket write untouched; the flush's ``b"".join`` is the one
    and only copy. Segments must alias immutable buffers: they sit in
    the outbox until the flush (and through one resend on transport
    failure)."""
    total = sum(len(s) for s in segments)
    head = bytearray(b"*3\r\n$7\r\nPUBLISH\r\n")
    ch = channel.encode() if isinstance(channel, str) else channel
    head += b"$%d\r\n" % len(ch)
    head += ch
    head += CRLF
    head += b"$%d\r\n" % total
    return (bytes(head), *segments, CRLF)


class RespError(Exception):
    pass


async def read_reply(reader: asyncio.StreamReader) -> Any:
    line = await reader.readline()
    if not line:
        raise ConnectionError("redis connection closed")
    kind, rest = line[:1], line[1:-2]
    if kind == b"+":
        return rest.decode()
    if kind == b"-":
        raise RespError(rest.decode())
    if kind == b":":
        return int(rest)
    if kind == b"$":
        length = int(rest)
        if length == -1:
            return None
        data = await reader.readexactly(length + 2)
        return data[:-2]
    if kind == b"*":
        count = int(rest)
        if count == -1:
            return None
        return [await read_reply(reader) for _ in range(count)]
    raise RespError(f"unexpected RESP reply type {kind!r}")


class RedisCommands:
    """Convenience commands shared by the single-node and cluster
    clients. `execute(*args, key=...)` routes by key on the cluster."""

    async def execute(self, *args, key: Optional[Union[str, bytes]] = None) -> Any:
        raise NotImplementedError

    async def ping(self) -> bool:
        return await self.execute("PING") == "PONG"

    async def get(self, key: str) -> Optional[bytes]:
        return await self.execute("GET", key, key=key)

    async def set(
        self,
        key: str,
        value: Union[bytes, str],
        nx: bool = False,
        px: Optional[int] = None,
    ) -> Optional[str]:
        args: list = ["SET", key, value]
        if px is not None:
            args += ["PX", px]
        if nx:
            args.append("NX")
        return await self.execute(*args, key=key)

    async def delete(self, *keys: str) -> int:
        return await self.execute("DEL", *keys, key=keys[0] if keys else None)

    async def publish(
        self, channel: str, data: "Union[bytes, str, list, tuple]"
    ) -> int:
        if isinstance(data, (list, tuple)):
            # segment-list callers (zero-copy publish lane) degrade to a
            # joined payload on the plain per-RTT client
            data = b"".join(data)
        return await self.execute("PUBLISH", channel, data)

    async def eval(self, script: str, keys: list[str], args: list) -> Any:
        return await self.execute(
            "EVAL", script, len(keys), *keys, *args, key=keys[0] if keys else None
        )

    async def flushall(self) -> None:
        await self.execute("FLUSHALL")

    async def acquire_lock(self, key: str, token: str, ttl_ms: int) -> bool:
        want = token.encode() if isinstance(token, str) else token
        execute_many = getattr(self, "execute_many", None)
        if execute_many is not None:
            # ONE pipelined round trip: the SET NX and the holder probe
            # share a single write+drain instead of two serialized RTTs.
            # The GET doubles as the lost-reply self-acquisition check:
            # if the FIRST transport attempt executed server-side with
            # its reply lost, execute_many's no-reply-consumed retry
            # re-runs both commands — SET NX then fails (our token holds
            # the key) but the GET returns our token, proving this call
            # acquired the lock. Tokens are unique per attempt.
            replies = await execute_many(
                [("SET", key, token, "PX", ttl_ms, "NX"), ("GET", key)]
            )
            set_reply, holder = replies
            if isinstance(set_reply, RespError):
                raise set_reply
            return set_reply == "OK" or (
                not isinstance(holder, RespError) and holder == want
            )
        if await self.set(key, token, nx=True, px=ttl_ms) == "OK":
            return True
        # Lost-reply self-acquisition (clients without execute_many):
        # execute() retries a transport failure once, and the FIRST
        # attempt may have executed server-side with its reply lost —
        # the retry then sees the key held and reports the lock
        # unavailable while OUR token holds it for a full TTL. A GET
        # matching this token proves this call acquired the lock.
        current = await self.get(key)
        return current == want

    async def release_lock(self, key: str, token: str) -> bool:
        return bool(await self.eval(RELEASE_LOCK_SCRIPT, [key], [token]))

    async def extend_lock(self, key: str, token: str, ttl_ms: int) -> bool:
        return bool(await self.eval(EXTEND_LOCK_SCRIPT, [key], [token, ttl_ms]))


class RedisClient(RedisCommands):
    """Request/response command client over one connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379) -> None:
        self.host = host
        self.port = port
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()
        self._closed = False

    async def connect(self) -> "RedisClient":
        if self._closed:
            raise ConnectionError("redis client closed")
        reader, writer = await asyncio.open_connection(self.host, self.port)
        if self._closed:
            # close() landed while the socket was opening: honor it —
            # installing the fresh pair would leak a connection nobody
            # ever closes
            writer.close()
            raise ConnectionError("redis client closed")
        self.reader, self.writer = reader, writer
        return self

    @property
    def connected(self) -> bool:
        return self.writer is not None and not self.writer.is_closing()

    def _drop_connection(self) -> None:
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
        self.reader = self.writer = None

    async def execute(self, *args: Union[bytes, str, int, float], key=None) -> Any:
        # connect under the same lock that serializes stream use: a
        # concurrent execute (or a close() racing the connected check)
        # must never see a half-replaced reader/writer pair
        async with self._lock:
            if self._closed:
                # close() is terminal: a late command (e.g. a store
                # racing teardown) must fail, not silently reopen a
                # connection nobody will ever close
                raise ConnectionError("redis client closed")
            # retry ONCE on a fresh socket: after a server restart the
            # old transport still reports connected (is_closing() only
            # flips on first failed IO), so the first command after an
            # outage would otherwise just die with "Connection lost".
            # One retry is safe for this client's command set: PUBLISH
            # is at-most-once anyway; SET NX / EVAL compare-and-del
            # re-runs fail toward NOT holding the lock
            for attempt in (0, 1):
                try:
                    if not self.connected:
                        await self.connect()
                    self.writer.write(encode_command(*args))
                    await self.writer.drain()
                    return await read_reply(self.reader)
                except RespError:
                    raise  # a server REPLY, not a transport failure
                except (OSError, ConnectionError, asyncio.IncompleteReadError):
                    self._drop_connection()
                    if attempt:
                        raise

    async def execute_many(self, commands: list[tuple]) -> list[Any]:
        """Pipeline several commands atomically on this connection (no
        interleaving — needed for ASKING + redirected command pairs).
        Error replies come back as RespError values, not raises, so the
        stream stays in sync."""
        async with self._lock:
            if self._closed:
                raise ConnectionError("redis client closed")
            for attempt in (0, 1):
                replies: list[Any] = []
                try:
                    if not self.connected:
                        await self.connect()
                    for command in commands:
                        self.writer.write(encode_command(*command))
                    await self.writer.drain()
                    for _ in commands:
                        try:
                            replies.append(await read_reply(self.reader))
                        except RespError as error:
                            replies.append(error)
                    return replies
                except (OSError, ConnectionError, asyncio.IncompleteReadError):
                    self._drop_connection()
                    # retry only when NO reply was consumed (otherwise a
                    # partial pipeline could double-execute a command)
                    if attempt or replies:
                        raise

    def close(self) -> None:
        self._closed = True
        if self.writer is not None:
            self.writer.close()
            self.writer = None
            self.reader = None


class _PipelinedCommand:
    __slots__ = (
        "encoded",
        "nbytes",
        "future",
        "attempts",
        "enqueued_at",
        "is_publish",
    )

    def __init__(
        self,
        encoded: "bytes | tuple",
        future: Optional[asyncio.Future],
        is_publish: bool = False,
    ) -> None:
        # bytes, or a tuple of (bytes | memoryview) segments for the
        # zero-copy publish path (encode_publish_segments) — flattened
        # by the flush's b"".join, never concatenated earlier
        self.encoded = encoded
        self.nbytes = (
            sum(len(s) for s in encoded)
            if isinstance(encoded, tuple)
            else len(encoded)
        )
        self.future = future
        self.attempts = 0
        self.enqueued_at = time.perf_counter()
        self.is_publish = is_publish


class PipelinedRedisClient(RedisClient):
    """Fire-and-forget RESP pipeline lane over one connection.

    The plain client's `execute` pays one serialized round trip per
    command under the connection lock — write, drain, await the reply.
    The replication hot path (extensions/redis.py) publishes once per
    (doc, tick) across potentially hundreds of busy docs, so per-command
    RTTs make the cross-instance cost O(updates x instances). This lane
    makes it O(ticks x channels):

    - `publish_nowait` is ENQUEUE-ONLY: it appends the encoded command
      to an outgoing buffer and returns. A flush task scheduled once per
      event-loop tick concatenates everything buffered and ships it in
      a single `write` + `drain` — N same-tick publishes cost one
      syscall pair and one RTT, not N.
    - A background reply reader consumes acks asynchronously in command
      order (RESP replies are strictly ordered), counts `-ERR` replies
      (`counters["reply_errors"]`, surfaced via wire telemetry) without
      desyncing the stream, and resolves the futures of commands that
      went through `execute`/`execute_many` — which ride the same lane,
      so concurrent lock traffic coalesces into the tick flush too.
    - On a transport failure the stream RESYNCS: the connection drops,
      unacked in-flight commands are requeued at the front of the
      buffer (ONE resend attempt each — publishes are at-most-once for
      the extension, and the CRDT payloads are idempotent so a
      duplicate from the ack-lost window is harmless) and the next
      flush re-sends complete encoded commands on the fresh socket.
      Buffered commands are therefore either flushed or resent — never
      half-written: partial bytes died with the old socket.
    - If the server stays unreachable (two connect attempts per flush
      cycle), pending work is SHED: futures fail with ConnectionError,
      publishes are counted dropped. The extension's anti-entropy
      SyncStep1 exchange heals dropped replication frames.
    - The outbox is BYTE-bounded (`max_outbox_bytes`) as well as
      command-bounded: during a transport outage, enqueues past the cap
      shed the OLDEST buffered publishes first (counted in
      `counters["dropped"]`/`["shed_bytes"]`) instead of growing toward
      OOM — newest state wins, and everything shed is recoverable
      because CRDT sync is state-based. Any shed (cap, overflow, or
      unreachable-server) arms `on_resync`: the first successful
      reconnect afterwards fires it once, so the owner (the Redis
      extension) can run its anti-entropy exchange and heal exactly the
      window the outage dropped.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6379,
        max_pending: int = 65536,
        max_outbox_bytes: int = 8 * 1024 * 1024,
        reconnect_delay: float = 0.05,
    ) -> None:
        super().__init__(host, port)
        self._outbox: "deque[_PipelinedCommand]" = deque()
        self._inflight: "deque[_PipelinedCommand]" = deque()
        self._flush_task: Optional[asyncio.Task] = None
        self._reply_task: Optional[asyncio.Task] = None
        self.max_pending = max_pending
        self.max_outbox_bytes = max_outbox_bytes
        self.reconnect_delay = reconnect_delay
        self.counters = {
            "publishes": 0,
            "flushes": 0,
            "commands_flushed": 0,
            "max_batch": 0,
            "reply_errors": 0,
            "resyncs": 0,
            "dropped": 0,
            "shed_bytes": 0,
        }
        # armed by any shed; fired (once) after the next successful
        # reconnect so the owner can anti-entropy-heal the gap. May be
        # sync or async; async callbacks run as tracked tasks.
        self.on_resync: Optional[Callable[[], Any]] = None
        self._needs_resync = False
        self._resync_tasks: set = set()
        self._outbox_bytes = 0
        from ..observability.wire import get_wire_telemetry

        get_wire_telemetry().track_redis_pipeline(self)

    # -- enqueue lane ------------------------------------------------------

    @property
    def pending(self) -> int:
        """Commands buffered or awaiting their ack (the depth gauge)."""
        return len(self._outbox) + len(self._inflight)

    def publish_nowait(
        self, channel: str, data: "Union[bytes, str, list, tuple]"
    ) -> None:
        """Enqueue one PUBLISH; returns immediately. The ack is consumed
        by the background reply reader. Overflow past `max_pending` is
        counted dropped (at-most-once — anti-entropy heals).

        ``data`` may be a list/tuple of (bytes | memoryview) segments —
        the zero-copy path: they are framed by reference
        (encode_publish_segments) and first materialize inside the
        flush's socket write."""
        if self._closed:
            raise ConnectionError("redis client closed")
        if self.pending >= self.max_pending:
            self.counters["dropped"] += 1
            self._needs_resync = True
            return
        self.counters["publishes"] += 1
        if isinstance(data, (list, tuple)):
            encoded: "bytes | tuple" = encode_publish_segments(channel, data)
        else:
            encoded = encode_command("PUBLISH", channel, data)
        self._enqueue(encoded, None, is_publish=True)

    async def execute(self, *args: Union[bytes, str, int, float], key=None) -> Any:
        if self._closed:
            raise ConnectionError("redis client closed")
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._enqueue(encode_command(*args), future)
        return await future

    async def execute_many(self, commands: list[tuple]) -> list[Any]:
        """Pipeline semantics match RedisClient.execute_many: error
        replies come back as RespError VALUES; transport failures (after
        the resend attempt) raise. All commands ride one flush batch."""
        if self._closed:
            raise ConnectionError("redis client closed")
        loop = asyncio.get_running_loop()
        futures = [loop.create_future() for _ in commands]
        for command, future in zip(commands, futures):
            self._enqueue(encode_command(*command), future)
        replies = await asyncio.gather(*futures, return_exceptions=True)
        for reply in replies:
            if isinstance(reply, Exception) and not isinstance(reply, RespError):
                raise reply
        return list(replies)

    def _enqueue(
        self,
        encoded: bytes,
        future: Optional[asyncio.Future],
        is_publish: bool = False,
    ) -> None:
        command = _PipelinedCommand(encoded, future, is_publish)
        self._outbox.append(command)
        self._outbox_bytes += command.nbytes
        if self._outbox_bytes > self.max_outbox_bytes:
            self._shed_outbox_overflow()
        self._schedule_flush()

    def _shed_outbox_overflow(self) -> None:
        """Byte cap crossed (the server is unreachable or drowning):
        shed the OLDEST buffered publishes until the outbox fits.
        Commands carrying futures (lock traffic) are never silently
        dropped — they keep their order and fail through the normal
        shed/resend paths — and the NEWEST command always survives:
        the cap bounds accumulation across an outage, not single-frame
        size, so one outsized full-state frame still ships (shedding it
        on enqueue would loop forever: the anti-entropy heal republishes
        the same frame). Newest-state-wins is safe: CRDT sync is
        state-based and the armed `on_resync` heals the gap."""
        kept: "list[_PipelinedCommand]" = []
        shed = 0
        while len(self._outbox) > 1 and self._outbox_bytes > self.max_outbox_bytes:
            command = self._outbox.popleft()
            if command.is_publish and command.future is None:
                self._outbox_bytes -= command.nbytes
                self.counters["dropped"] += 1
                self.counters["shed_bytes"] += command.nbytes
                shed += 1
            else:
                kept.append(command)
        self._outbox.extendleft(reversed(kept))
        if shed:
            self._needs_resync = True

    def _schedule_flush(self) -> None:
        if self._flush_task is not None and not self._flush_task.done():
            return
        try:
            # get_RUNNING_loop, strictly: get_event_loop() would hand
            # back a non-running loop outside async context and pin
            # _flush_task to a task that never executes — wedging every
            # later flush behind its not-done() check
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop: flushed when the next async call runs one
        # the task's first step runs via call_soon, i.e. AFTER the
        # current callback finishes — every same-tick enqueue lands in
        # this flush's batch
        self._flush_task = loop.create_task(self._flush_loop())

    # -- the flush ---------------------------------------------------------

    async def _flush_loop(self) -> None:
        try:
            while self._outbox and not self._closed:
                if not self.connected:
                    if not await self._reconnect():
                        self._shed_pending()
                        return
                    self._fire_resync_if_armed()
                self._ensure_reply_reader()
                batch = list(self._outbox)
                self._outbox.clear()
                self._outbox_bytes = 0
                self._inflight.extend(batch)
                oldest_wait = time.perf_counter() - batch[0].enqueued_at
                try:
                    # ONE write + drain for the whole batch: the
                    # concatenation is the entire point of the lane.
                    # Segment tuples (zero-copy publishes) flatten here —
                    # this join is the single copy their payloads pay.
                    parts: list = []
                    for c in batch:
                        if isinstance(c.encoded, tuple):
                            parts.extend(c.encoded)
                        else:
                            parts.append(c.encoded)
                    self.writer.write(b"".join(parts))
                    await self.writer.drain()
                except (OSError, ConnectionError):
                    self._resync()
                    continue
                # account only SUCCESSFUL flushes: a failed write is
                # re-flushed after the resync and must not double-count
                # the same commands in the batch-size profile
                self.counters["flushes"] += 1
                self.counters["commands_flushed"] += len(batch)
                if len(batch) > self.counters["max_batch"]:
                    self.counters["max_batch"] = len(batch)
                from ..observability.wire import get_wire_telemetry

                wire = get_wire_telemetry()
                if wire.enabled:
                    wire.record_redis_flush(len(batch), oldest_wait)
        finally:
            self._flush_task = None
            if self._outbox and not self._closed:
                # commands enqueued during the final drain await
                self._schedule_flush()

    async def _reconnect(self) -> bool:
        for attempt in (0, 1):
            try:
                await self.connect()
                return True
            except (OSError, ConnectionError):
                if self._closed:
                    return False
                if attempt == 0:
                    await asyncio.sleep(self.reconnect_delay)
        return False

    def _fire_resync_if_armed(self) -> None:
        """First successful reconnect after a shed: hand the owner one
        anti-entropy opportunity (the Redis extension publishes
        SyncStep1 + QueryAwareness per loaded doc, pulling every frame
        the outage window dropped)."""
        if not self._needs_resync:
            return
        self._needs_resync = False
        callback = self.on_resync
        if callback is None:
            return
        try:
            result = callback()
        except Exception:
            return
        if asyncio.iscoroutine(result):
            task = asyncio.ensure_future(result)
            self._resync_tasks.add(task)
            task.add_done_callback(self._resync_tasks.discard)

    def _shed_pending(self) -> None:
        """Server unreachable after retries: fail futures, count dropped
        publishes. Pending work must not wedge callers forever."""
        error = ConnectionError("redis unreachable; pipelined commands shed")
        for queue in (self._inflight, self._outbox):
            while queue:
                self._fail(queue.popleft(), error)
        self._outbox_bytes = 0
        self._needs_resync = True

    def _fail(self, command: _PipelinedCommand, error: Exception) -> None:
        if command.future is not None:
            if not command.future.done():
                command.future.set_exception(error)
        elif command.is_publish:
            self.counters["dropped"] += 1

    def _resync(self) -> None:
        """Transport failure with commands possibly executed but unacked:
        drop the socket, requeue unacked commands (one resend each) at
        the FRONT of the outbox so order is preserved on the fresh
        connection. Half-written bytes died with the old socket — the
        resend writes complete encoded commands."""
        self._drop_connection()
        # retire the reply reader bound to the dead stream: left alive,
        # it could still drain the old socket's buffered replies and
        # pop REQUEUED commands out of _inflight against the wrong
        # attempt — and _ensure_reply_reader would see it not-done and
        # never start a reader for the fresh connection
        task = self._reply_task
        if task is not None and not task.done():
            try:
                current = asyncio.current_task()
            except RuntimeError:
                current = None
            if task is not current:
                task.cancel()
        self._reply_task = None
        self.counters["resyncs"] += 1
        requeue = []
        while self._inflight:
            command = self._inflight.popleft()
            command.attempts += 1
            if command.attempts >= 2:
                self._fail(command, ConnectionError("redis connection lost"))
                if command.is_publish:
                    self._needs_resync = True
            else:
                requeue.append(command)
                self._outbox_bytes += command.nbytes
        self._outbox.extendleft(reversed(requeue))

    # -- the reply reader --------------------------------------------------

    def _ensure_reply_reader(self) -> None:
        if self._reply_task is None or self._reply_task.done():
            self._reply_task = asyncio.ensure_future(self._reply_loop(self.reader))

    async def _reply_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while not self._closed:
                try:
                    reply = await read_reply(reader)
                except RespError as error:
                    # a server ERROR reply — the stream is still in
                    # sync (the line was consumed); account and move on
                    self.counters["reply_errors"] += 1
                    from ..observability.wire import get_wire_telemetry

                    wire = get_wire_telemetry()
                    if wire.enabled:
                        wire.record_redis_reply_error()
                    command = self._inflight.popleft() if self._inflight else None
                    if command is not None and command.future is not None:
                        if not command.future.done():
                            command.future.set_exception(error)
                    continue
                command = self._inflight.popleft() if self._inflight else None
                if command is not None and command.future is not None:
                    if not command.future.done():
                        command.future.set_result(reply)
        except asyncio.CancelledError:
            return
        except (OSError, ConnectionError, asyncio.IncompleteReadError):
            # the connection died under the reader. Only resync if the
            # stream we were reading is still the live one — a flush
            # write failure (or close) already handled replacement
            if reader is self.reader and not self._closed:
                self._resync()
                if self._outbox:
                    self._schedule_flush()

    def close(self) -> None:
        self._closed = True
        if self._reply_task is not None:
            self._reply_task.cancel()
            self._reply_task = None
        error = ConnectionError("redis client closed")
        for queue in (self._inflight, self._outbox):
            while queue:
                command = queue.popleft()
                if command.future is not None and not command.future.done():
                    command.future.set_exception(error)
        self._outbox_bytes = 0
        for task in list(self._resync_tasks):
            task.cancel()
        self._resync_tasks.clear()
        super().close()


class RedisClusterClient(RedisCommands):
    """Slot-routed Redis Cluster client with MOVED/ASK redirects.

    The capability the reference gets from ioredis Cluster
    (`extension-redis/src/Redis.ts:119-135` `nodes` + `options`): route
    each keyed command to the node owning its hash slot, follow MOVED by
    refreshing the slot map, honor one-shot ASK redirects. Pub/sub and
    un-keyed commands go to any reachable node (cluster pub/sub is
    broadcast across the bus server-side).
    """

    def __init__(self, nodes: list) -> None:
        self.nodes: list[tuple[str, int]] = [self._normalize(n) for n in nodes]
        if not self.nodes:
            raise ValueError("RedisClusterClient needs at least one node")
        self._clients: dict[tuple[str, int], RedisClient] = {}
        # (start, end, (host, port)) ranges from CLUSTER SLOTS
        self._ranges: list[tuple[int, int, tuple[str, int]]] = []
        # rotates on connection failures so non-keyed commands (PUBLISH,
        # PING) fail over instead of pinning to a dead seed
        self._preferred = 0

    @staticmethod
    def _normalize(node) -> tuple[str, int]:
        if isinstance(node, dict):
            return (node.get("host", "127.0.0.1"), int(node.get("port", 6379)))
        host, port = node
        return (host, int(port))

    def _client(self, node: tuple[str, int]) -> RedisClient:
        client = self._clients.get(node)
        if client is None:
            client = RedisClient(*node)
            self._clients[node] = client
        return client

    async def refresh_slots(self) -> None:
        last_error: Optional[Exception] = None
        for node in self.nodes:
            try:
                slots = await self._client(node).execute("CLUSTER", "SLOTS")
            except Exception as error:  # node down — try the next seed
                last_error = error
                continue
            ranges = []
            for entry in slots or []:
                start, end, master = entry[0], entry[1], entry[2]
                host = master[0].decode() if isinstance(master[0], bytes) else master[0]
                ranges.append((int(start), int(end), (host, int(master[1]))))
            if ranges:
                self._ranges = ranges
                return
        if last_error is not None:
            raise last_error

    def _node_for(self, key) -> tuple[str, int]:
        if key is None or not self._ranges:
            return self.nodes[self._preferred % len(self.nodes)]
        slot = key_hash_slot(key)
        for start, end, node in self._ranges:
            if start <= slot <= end:
                return node
        return self.nodes[self._preferred % len(self.nodes)]

    async def execute(self, *args, key=None) -> Any:
        if not self._ranges:
            try:
                await self.refresh_slots()
            except Exception:
                pass  # single-node clusters may not speak CLUSTER SLOTS
        node = self._node_for(key)
        last_error: Optional[Exception] = None
        for attempt in range(max(5, len(self.nodes) + 1)):
            try:
                return await self._client(node).execute(*args)
            except (OSError, ConnectionError) as error:
                # node unreachable: drop its connection and fail over to
                # the next seed (a healthy node answers, possibly with a
                # MOVED that re-routes us properly)
                last_error = error
                self._clients.pop(node, None)
                self._preferred += 1
                node = self.nodes[self._preferred % len(self.nodes)]
                continue
            except RespError as error:
                message = str(error)
                if message.startswith("MOVED "):
                    _, _, target = message.split(" ", 2)
                    host, _, port = target.rpartition(":")
                    node = (host, int(port))
                    try:
                        await self.refresh_slots()
                    except Exception:
                        pass
                    continue
                if message.startswith("ASK "):
                    _, _, target = message.split(" ", 2)
                    host, _, port = target.rpartition(":")
                    ask_client = self._client((host, int(port)))
                    # ASKING + command must not interleave with other
                    # users of the connection
                    replies = await ask_client.execute_many([("ASKING",), tuple(args)])
                    if isinstance(replies[1], RespError):
                        raise replies[1]
                    return replies[1]
                raise
        raise last_error if last_error else RespError("too many MOVED redirects")

    def close(self) -> None:
        for client in self._clients.values():
            client.close()
        self._clients.clear()


class RedisSubscriber:
    """Dedicated pub/sub connection; delivers messages to a callback."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6379,
        on_message: Optional[Callable[[bytes, bytes], None]] = None,
        reconnect: bool = True,
        reconnect_delay: float = 0.25,
        reconnect_max_delay: float = 5.0,
    ) -> None:
        self.host = host
        self.port = port
        self.on_message = on_message
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._subscribed: dict[bytes, asyncio.Future] = {}
        self.channels: set[bytes] = set()
        self._conn_lock = asyncio.Lock()
        self._closed = False
        # a dead read loop on an IDLE subscriber must heal itself: the
        # extension only touches the subscriber on doc load/unload, so
        # without this a Redis restart leaves every already-loaded doc
        # deaf to cross-instance updates until the next load
        self.reconnect = reconnect
        self.reconnect_delay = reconnect_delay
        self.reconnect_max_delay = reconnect_max_delay
        self._reconnect_task: Optional[asyncio.Task] = None
        # awaited after a SELF-HEALED reconnect: pub/sub is at-most-once,
        # so anything published during the outage/reconnect window is
        # gone — the owner hooks a resync here (e.g. the Redis extension
        # publishes SyncStep1 per loaded doc to pull what it missed)
        self.on_reconnect: Optional[Callable[[], Any]] = None

    async def connect(self) -> "RedisSubscriber":
        # concurrent subscribes during startup must not each open a
        # connection: two _read_loops on one stream raise "readuntil()
        # called while another coroutine is already waiting"
        async with self._conn_lock:
            if self._closed:
                # close() is terminal: a late unsubscribe racing
                # teardown must not reopen a connection nobody closes
                raise ConnectionError("redis subscriber closed")
            if self.connected:
                return self
            if self._reader_task is not None:
                self._reader_task.cancel()
            if self.writer is not None:
                # a half-closed server FIN leaves is_closing() False; the
                # dead transport must be closed, not just overwritten, or
                # every self-healed reconnect leaks one socket
                try:
                    self.writer.close()
                except Exception:
                    pass
                self.reader = self.writer = None
            reader, writer = await asyncio.open_connection(self.host, self.port)
            if self._closed:  # close() landed while the socket opened
                writer.close()
                raise ConnectionError("redis subscriber closed")
            self.reader, self.writer = reader, writer
            self._reader_task = asyncio.ensure_future(self._read_loop())
            # recover subscriptions that died with the previous
            # connection — without this, a Redis restart silently stops
            # cross-instance updates for every already-loaded doc
            if self.channels:
                for channel in self.channels:
                    self.writer.write(encode_command("SUBSCRIBE", channel))
                await self.writer.drain()
            return self

    @property
    def connected(self) -> bool:
        # liveness includes the read loop: a server half-close (FIN on
        # idle timeout / failover) kills _read_loop long before
        # writer.is_closing() flips, and a subscriber without a reader
        # is deaf — it must count as disconnected so connect() heals it
        return (
            self.writer is not None
            and not self.writer.is_closing()
            and self._reader_task is not None
            and not self._reader_task.done()
        )

    async def _read_loop(self) -> None:
        # bind the stream locally: a reconnect replaces self.reader, and
        # the outgoing loop must never start reading the new stream
        reader = self.reader
        assert reader is not None
        try:
            while True:
                reply = await read_reply(reader)
                if not isinstance(reply, list) or not reply:
                    continue
                kind = reply[0]
                if kind == b"message":
                    _, channel, payload = reply
                    if self.on_message is not None:
                        self.on_message(channel, payload)
                elif kind in (b"subscribe", b"unsubscribe"):
                    _, channel, _count = reply
                    waiter = self._subscribed.pop(channel, None)
                    if waiter is not None and not waiter.done():
                        waiter.set_result(True)
        except asyncio.CancelledError:
            return  # deliberate teardown/replacement: no reconnect
        except (OSError, asyncio.IncompleteReadError):
            # OSError, not just ConnectionError: an ETIMEDOUT keepalive
            # death raises TimeoutError (an OSError), and a loop that
            # doesn't catch it never reaches the reconnect below
            pass
        # the connection died underneath us (server restart, half-close)
        if not self._closed and self.reconnect and self.channels:
            self._schedule_reconnect()

    def _schedule_reconnect(self) -> None:
        if self._reconnect_task is not None and not self._reconnect_task.done():
            return
        self._reconnect_task = asyncio.ensure_future(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        delay = self.reconnect_delay
        while not self._closed and not self.connected and self.channels:
            await asyncio.sleep(delay)
            try:
                await self.connect()  # connect() re-issues every SUBSCRIBE
            except (OSError, ConnectionError):
                delay = min(delay * 2, self.reconnect_max_delay)
                continue
            if self.on_reconnect is not None:
                try:
                    result = self.on_reconnect()
                    if asyncio.iscoroutine(result):
                        await result
                except Exception:
                    pass  # resync is best-effort; the next change heals
            # loop (don't return): if the fresh connection died while
            # on_reconnect was awaited, the new read loop's
            # _schedule_reconnect() no-oped because THIS task was still
            # running — the while condition is the only re-check
            delay = self.reconnect_delay

    async def _send(self, *args: Union[bytes, str]) -> None:
        if not self.connected:
            await self.connect()
        assert self.writer is not None
        self.writer.write(encode_command(*args))
        await self.writer.drain()

    async def subscribe(self, channel: str) -> None:
        key = channel.encode()
        waiter: asyncio.Future = asyncio.get_event_loop().create_future()
        self._subscribed[key] = waiter
        await self._send("SUBSCRIBE", channel)
        await asyncio.wait_for(waiter, 10)
        self.channels.add(key)

    async def unsubscribe(self, channel: str) -> None:
        key = channel.encode()
        self.channels.discard(key)
        if self.connected:
            await self._send("UNSUBSCRIBE", channel)

    def close(self) -> None:
        self._closed = True
        if self._reader_task is not None:
            self._reader_task.cancel()
            self._reader_task = None
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
            self._reconnect_task = None
        if self.writer is not None:
            self.writer.close()
            self.writer = None
            self.reader = None


class ClusterSubscriber(RedisSubscriber):
    """Pub/sub over a cluster: subscribe on the first reachable node
    (redis propagates published messages to every node's subscribers)."""

    def __init__(self, nodes: list, on_message: Optional[Callable[[bytes, bytes], None]] = None) -> None:
        self.nodes = [RedisClusterClient._normalize(n) for n in nodes]
        if not self.nodes:
            raise ValueError("ClusterSubscriber needs at least one node")
        super().__init__(self.nodes[0][0], self.nodes[0][1], on_message=on_message)

    async def connect(self) -> "ClusterSubscriber":
        last_error: Optional[Exception] = None
        for host, port in self.nodes:
            self.host, self.port = host, port
            try:
                await super().connect()
                return self
            except OSError as error:
                last_error = error
        raise last_error if last_error else ConnectionError("no cluster nodes reachable")
