"""In-process mini Redis server (RESP2) for tests and single-host dev.

Implements the command subset the Redis extension uses: GET/SET(NX/PX)/
DEL/EXPIRE-via-PX, PUBLISH/SUBSCRIBE/UNSUBSCRIBE, EVAL (compare-and-del
release script only), PING, FLUSHALL. The reference test-suite runs a
real Redis container (`docker-compose.yml`); this keeps the two-instance
fan-out tests self-contained in one process.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..observability.wire import get_wire_telemetry
from .resp import CRLF, EXTEND_LOCK_SCRIPT, RELEASE_LOCK_SCRIPT, key_hash_slot, read_reply


def _bulk(data: Optional[bytes]) -> bytes:
    if data is None:
        return b"$-1\r\n"
    return b"$%d\r\n%s\r\n" % (len(data), data)


def _array(items: list[bytes]) -> bytes:
    return b"*%d\r\n%s" % (len(items), b"".join(items))


def _int(value: int) -> bytes:
    return b":%d\r\n" % value


class MiniRedis:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        subscriber_queue_limit: int = 1024,
    ) -> None:
        self.host = host
        self.port = port
        self.data: dict[bytes, tuple[bytes, Optional[float]]] = {}
        # channel -> set of writer streams
        self.subscribers: dict[bytes, set[asyncio.StreamWriter]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.StreamWriter] = set()
        # per-subscriber bounded outbound queues: a subscriber that
        # stops reading fills its queue and gets DISCONNECTED (like a
        # real redis hitting client-output-buffer-limit pubsub) instead
        # of growing an unbounded transport buffer; counters let
        # replication tests assert loss-healing end to end
        self.subscriber_queue_limit = subscriber_queue_limit
        self._sub_queues: dict[asyncio.StreamWriter, asyncio.Queue] = {}
        self._pump_tasks: dict[asyncio.StreamWriter, asyncio.Task] = {}
        self.counters = {
            "delivered": 0,
            "dropped_injected": 0,
            "dropped_slow": 0,
            "slow_disconnects": 0,
            "dropped_partition": 0,
        }
        # cluster emulation: list of (start, end, MiniRedis) covering the
        # slot space; keyed commands off this node's ranges answer MOVED,
        # publishes fan out to every node's subscribers (the cluster bus)
        self.cluster_ranges: Optional[list[tuple[int, int, "MiniRedis"]]] = None
        # fault injection (tests): PUBLISH silently drops the next N
        # messages — models real pub/sub's at-most-once delivery, which
        # the extension's anti-entropy must heal. When drop_channel is
        # set, only publishes to that channel count (determinism: an
        # unrelated keepalive can't eat the injected fault)
        self.drop_publishes = 0
        self.drop_channel: Optional[bytes] = None
        # latency injection (scenario harness): every delivered publish
        # is delayed by this many ms before it reaches the subscriber's
        # queue — models cross-region replication lag. FIFO order is
        # preserved even when the latency is LOWERED mid-run: new
        # deliveries floor their deadline to the latest already
        # scheduled one (`_deliver_floor`), so a fast frame can never
        # overtake a slow one still in flight
        self.publish_latency_ms = 0
        self._deliver_floor = 0.0
        # partition injection (chaos hardening): a ONE-WAY network
        # partition modeled at the pub/sub hop. Payloads from the Redis
        # extension are identifier-prefixed ([1-byte idLen][identifier]
        # [frame]); publishes whose identifier is in this set vanish in
        # flight — the publisher's write succeeds (it is none the
        # wiser, exactly like a blackholed link), subscribers never see
        # the frame, and every drop is ACCOUNTED in
        # counters["dropped_partition"] so partition-heal tests can
        # assert zero silent loss. The reverse direction (and every
        # other publisher) keeps flowing: that is what makes it
        # one-way. Heal with `heal_partition()`; the extensions'
        # anti-entropy SyncStep1 exchange then closes the gap.
        self.partitioned_identifiers: "set[bytes]" = set()
        # keys mid-migration (ASK emulation): a keyed command on such a
        # key answers -ASK <slot> target; the target executes it only
        # on an ASKING-flagged connection, like a real resharding window
        self.migrating: dict[bytes, "MiniRedis"] = {}

    def configure_cluster(self, ranges: list[tuple[int, int, "MiniRedis"]]) -> None:
        self.cluster_ranges = ranges

    # -- partition injection -------------------------------------------------

    def partition_publisher(self, identifier: "str | bytes") -> None:
        """Blackhole every publish whose payload carries `identifier`
        (one-way partition: that instance's outbound replication dies,
        everything else keeps flowing)."""
        if isinstance(identifier, str):
            identifier = identifier.encode()
        self.partitioned_identifiers.add(identifier)

    def heal_partition(self, identifier: "str | bytes | None" = None) -> None:
        """End the partition (one identifier, or all when None)."""
        if identifier is None:
            self.partitioned_identifiers.clear()
            return
        if isinstance(identifier, str):
            identifier = identifier.encode()
        self.partitioned_identifiers.discard(identifier)

    def _partition_drops(self, payload: bytes) -> bool:
        """True when the payload's publisher identifier is partitioned."""
        if not self.partitioned_identifiers:
            return False
        try:
            id_len = payload[0]
            identifier = payload[1 : id_len + 1]
        except Exception:
            return False
        return identifier in self.partitioned_identifiers

    def _owns(self, key: bytes) -> Optional["MiniRedis"]:
        """None if this node owns the key's slot, else the owning node."""
        if self.cluster_ranges is None:
            return None
        slot = key_hash_slot(key)
        for start, end, node in self.cluster_ranges:
            if start <= slot <= end:
                return None if node is self else node
        return None

    def _deliver(self, channel: bytes, payload: bytes) -> int:
        """Returns the receiver count for the PUBLISH reply; the
        `delivered` counter is incremented at ACTUAL enqueue time (in
        `_enqueue`), so a delayed frame that later hits a full queue or
        a departed subscriber never double-counts against the drop
        counters."""
        receivers = self.subscribers.get(channel, set())
        message = _array([_bulk(b"message"), _bulk(channel), _bulk(payload)])
        targeted = 0
        loop = asyncio.get_running_loop()
        now = loop.time()
        # floor STRICTLY past the latest in-flight deadline: lowering
        # the injected latency must not let new frames overtake
        # scheduled ones, and an EQUAL deadline is not enough — the
        # event loop's timer heap breaks ties arbitrarily
        deadline = now + self.publish_latency_ms / 1000.0
        if self._deliver_floor > now and deadline <= self._deliver_floor:
            deadline = self._deliver_floor + 1e-4
        for sub_writer in list(receivers):
            if sub_writer not in self._sub_queues:
                receivers.discard(sub_writer)  # connection already gone
                continue
            if deadline > now:
                # injected replication lag: the frame sits "in flight"
                # until its deadline before landing in the queue; the
                # reply counts it optimistically (outcome unknown yet)
                loop.call_later(deadline - now, self._enqueue, sub_writer, message)
                targeted += 1
            else:
                targeted += self._enqueue(sub_writer, message)
        if deadline > now:
            self._deliver_floor = deadline
        return targeted

    def _enqueue(self, sub_writer: asyncio.StreamWriter, message: bytes) -> int:
        queue = self._sub_queues.get(sub_writer)
        if queue is None:
            return 0  # subscriber left while the frame was in flight
        try:
            queue.put_nowait(message)
            self.counters["delivered"] += 1
            return 1
        except asyncio.QueueFull:
            # slow subscriber: drop the frame AND the client (its
            # backlog dies with it) — matches real redis pub/sub
            # under client-output-buffer-limit, and the extension's
            # anti-entropy must absorb exactly this
            self.counters["dropped_slow"] += 1
            self._disconnect_slow(sub_writer)
            wire = get_wire_telemetry()
            if wire.enabled:
                wire.record_publish(0, dropped=True)
            return 0

    def _disconnect_slow(self, writer: asyncio.StreamWriter) -> None:
        self.counters["slow_disconnects"] += 1
        for receivers in self.subscribers.values():
            receivers.discard(writer)
        task = self._pump_tasks.pop(writer, None)
        if task is not None:
            task.cancel()
        self._sub_queues.pop(writer, None)
        try:
            writer.close()
        except Exception:
            pass

    def _ensure_pump(self, writer: asyncio.StreamWriter) -> None:
        if writer in self._sub_queues:
            return
        queue: asyncio.Queue = asyncio.Queue(self.subscriber_queue_limit)
        self._sub_queues[writer] = queue
        self._pump_tasks[writer] = asyncio.ensure_future(self._pump(queue, writer))

    async def _pump(self, queue: asyncio.Queue, writer: asyncio.StreamWriter) -> None:
        """Drain one subscriber's queue: whole backlog per wake, one
        drain() for the batch (the transport writer's batching idiom)."""
        try:
            while True:
                writer.write(await queue.get())
                while not queue.empty():
                    writer.write(queue.get_nowait())
                await writer.drain()
        except asyncio.CancelledError:
            return
        except (OSError, ConnectionError):
            return

    async def start(self) -> "MiniRedis":
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # drop live client connections like a real redis restart
            # would (and Python 3.12's wait_closed otherwise blocks on
            # handlers that sit in read_reply forever)
            for task in list(self._pump_tasks.values()):
                task.cancel()
            self._pump_tasks.clear()
            self._sub_queues.clear()
            for writer in list(self._conns):
                writer.close()
            await self._server.wait_closed()
            self._server = None

    def _get(self, key: bytes) -> Optional[bytes]:
        entry = self.data.get(key)
        if entry is None:
            return None
        value, expires_at = entry
        if expires_at is not None and time.monotonic() > expires_at:
            del self.data[key]
            return None
        return value

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        subscribed: set[bytes] = set()
        asking = False  # one-shot ASKING flag (consumed by next keyed command)
        self._conns.add(writer)
        try:
            while True:
                try:
                    request = await read_reply(reader)
                except (ConnectionError, asyncio.IncompleteReadError):
                    break
                if not isinstance(request, list) or not request:
                    writer.write(b"-ERR protocol error\r\n")
                    continue
                command = request[0].upper()
                args = request[1:]
                # cluster slot check for keyed commands
                routed_key: Optional[bytes] = None
                if command in (b"SET", b"GET", b"DEL") and args:
                    routed_key = args[0]
                elif command == b"EVAL" and len(args) > 2 and int(args[1]) > 0:
                    routed_key = args[2]
                if routed_key is not None:
                    was_asking, asking = asking, False
                    target = self.migrating.get(routed_key)
                    if target is not None:
                        # slot migration window: the source answers ASK
                        writer.write(
                            b"-ASK %d %s:%d\r\n"
                            % (key_hash_slot(routed_key), target.host.encode(), target.port)
                        )
                        try:
                            await writer.drain()
                        except (ConnectionError, OSError):
                            break
                        continue
                    owner = self._owns(routed_key)
                    if owner is not None and not was_asking:
                        writer.write(
                            b"-MOVED %d %s:%d\r\n"
                            % (key_hash_slot(routed_key), owner.host.encode(), owner.port)
                        )
                        try:
                            await writer.drain()
                        except (ConnectionError, OSError):
                            break
                        continue
                if command == b"ASKING":
                    asking = True
                    writer.write(b"+OK\r\n")
                elif command == b"PING":
                    writer.write(b"+PONG\r\n")
                elif command == b"CLUSTER" and args and args[0].upper() == b"SLOTS":
                    if self.cluster_ranges is None:
                        writer.write(b"-ERR This instance has cluster support disabled\r\n")
                    else:
                        entries = []
                        for start, end, node in self.cluster_ranges:
                            entries.append(
                                _array(
                                    [
                                        _int(start),
                                        _int(end),
                                        _array([_bulk(node.host.encode()), _int(node.port)]),
                                    ]
                                )
                            )
                        writer.write(_array(entries))
                elif command == b"SET":
                    key, value = args[0], args[1]
                    nx = False
                    px: Optional[int] = None
                    i = 2
                    while i < len(args):
                        opt = args[i].upper()
                        if opt == b"NX":
                            nx = True
                            i += 1
                        elif opt == b"PX":
                            px = int(args[i + 1])
                            i += 2
                        elif opt == b"EX":
                            px = int(args[i + 1]) * 1000
                            i += 2
                        else:
                            i += 1
                    if nx and self._get(key) is not None:
                        writer.write(b"$-1\r\n")
                    else:
                        expires = time.monotonic() + px / 1000 if px is not None else None
                        self.data[key] = (value, expires)
                        writer.write(b"+OK\r\n")
                elif command == b"GET":
                    writer.write(_bulk(self._get(args[0])))
                elif command == b"DEL":
                    count = 0
                    for key in args:
                        if self._get(key) is not None:
                            del self.data[key]
                            count += 1
                    writer.write(b":%d\r\n" % count)
                elif command == b"EVAL":
                    script = args[0].decode()
                    numkeys = int(args[1])
                    keys = args[2 : 2 + numkeys]
                    script_args = args[2 + numkeys :]
                    if script == RELEASE_LOCK_SCRIPT:
                        if keys and self._get(keys[0]) == (script_args[0] if script_args else None):
                            del self.data[keys[0]]
                            writer.write(b":1\r\n")
                        else:
                            writer.write(b":0\r\n")
                    elif script == EXTEND_LOCK_SCRIPT:
                        if keys and self._get(keys[0]) == (script_args[0] if script_args else None):
                            value, _ = self.data[keys[0]]
                            ttl_ms = int(script_args[1])
                            self.data[keys[0]] = (value, time.monotonic() + ttl_ms / 1000)
                            writer.write(b":1\r\n")
                        else:
                            writer.write(b":0\r\n")
                    else:
                        writer.write(b"-ERR unsupported script\r\n")
                elif command == b"PUBLISH":
                    channel, payload = args[0], args[1]
                    if self._partition_drops(payload):
                        # one-way partition: the publisher's command
                        # succeeds (a blackholed link gives no error),
                        # the frame never reaches any subscriber, the
                        # drop is accounted — never silent
                        self.counters["dropped_partition"] += 1
                        wire = get_wire_telemetry()
                        if wire.enabled:
                            wire.record_publish(0, dropped=True)
                        writer.write(b":0\r\n")
                        try:
                            await writer.drain()
                        except (ConnectionError, OSError):
                            break
                        continue
                    if self.drop_publishes > 0 and (
                        self.drop_channel is None or channel == self.drop_channel
                    ):
                        # injected fault: the frame vanishes in flight
                        # (subscriber never sees it; publisher is none
                        # the wiser — pub/sub is at-most-once)
                        self.drop_publishes -= 1
                        self.counters["dropped_injected"] += 1
                        wire = get_wire_telemetry()
                        if wire.enabled:
                            wire.record_publish(0, dropped=True)
                        writer.write(b":0\r\n")
                        try:
                            await writer.drain()
                        except (ConnectionError, OSError):
                            break
                        continue
                    delivered = self._deliver(channel, payload)
                    if self.cluster_ranges is not None:
                        # cluster bus: published messages reach every
                        # node's subscribers (each node once)
                        seen: set[int] = set()
                        for _, _, node in self.cluster_ranges:
                            if node is not self and id(node) not in seen:
                                seen.add(id(node))
                                delivered += node._deliver(channel, payload)
                    wire = get_wire_telemetry()
                    if wire.enabled:
                        # pub/sub fan-out accounting: publishes vs the
                        # frames actually fanned out (cluster bus incl.)
                        wire.record_publish(delivered)
                    writer.write(b":%d\r\n" % delivered)
                elif command == b"SUBSCRIBE":
                    self._ensure_pump(writer)
                    for channel in args:
                        self.subscribers.setdefault(channel, set()).add(writer)
                        subscribed.add(channel)
                        writer.write(
                            _array(
                                [_bulk(b"subscribe"), _bulk(channel), b":%d\r\n" % len(subscribed)]
                            )
                        )
                elif command == b"UNSUBSCRIBE":
                    channels = args or list(subscribed)
                    for channel in channels:
                        self.subscribers.get(channel, set()).discard(writer)
                        subscribed.discard(channel)
                        writer.write(
                            _array(
                                [
                                    _bulk(b"unsubscribe"),
                                    _bulk(channel),
                                    b":%d\r\n" % len(subscribed),
                                ]
                            )
                        )
                elif command == b"FLUSHALL":
                    self.data.clear()
                    writer.write(b"+OK\r\n")
                elif command == b"INFO":
                    writer.write(_bulk(b"# mini-redis\r\nredis_version:7.0.0-mini"))
                else:
                    writer.write(b"-ERR unknown command\r\n")
                try:
                    await writer.drain()
                except (ConnectionError, OSError):
                    break  # client went away mid-reply (teardown/restart)
        finally:
            for channel in subscribed:
                self.subscribers.get(channel, set()).discard(writer)
            task = self._pump_tasks.pop(writer, None)
            if task is not None:
                task.cancel()
            self._sub_queues.pop(writer, None)
            self._conns.discard(writer)
            writer.close()
