"""Redis fan-out extension — the horizontal-scaling backbone.

Capability parity with reference `extension-redis/src/Redis.ts`:
one pub/sub channel per document named `{prefix}:{documentName}`, frames
prefixed `[1-byte idLen][identifier][payload]` for self-filtering, a
distributed store lock electing a single storer (SET NX PX + compare-
and-delete release), join protocol publishing SyncStep1 + QueryAwareness
on document load, and delayed unsubscribe on disconnect.

Beyond parity, the REPLICATION FAST PATH (docs/guides/
horizontal-scaling.md) makes the cross-instance cost O(ticks x
channels) instead of O(updates x instances):

- **Outbound: per-tick publish coalescing.** Local updates ride the
  broadcast tick (`server/fanout.py` hands the tick's local-origin
  updates — and the already-built wire frame when the whole tick is
  local — to this extension's publish lane); plane window broadcasts
  (`on_plane_broadcast`) enqueue into the same lane. One merged
  Y-update frame per (doc, tick), awareness piggybacked, everything
  shipped through the pipelined client's single write+drain per tick.
- **Inbound: batched apply.** Incoming frames land in a bounded
  per-doc inbox drained once per tick: contiguous update frames merge
  into ONE `apply_update` (one local fan-out tick) per doc per drain;
  overflow drops are healed by an anti-entropy SyncStep1 exchange —
  never silent loss.
- **Anti-entropy.** Pub/sub is at-most-once, so direct update frames
  can vanish; a rate-limited SyncStep1 exchange per doc (immediate
  past the window, trailing edge within it) bounds any divergence
  window for both CPU-doc and plane-served replication.
"""

from __future__ import annotations

import asyncio
import random
import uuid
from collections import deque
from typing import Any, Callable, Optional

from ..crdt import apply_update
from ..net.resp import (
    ClusterSubscriber,
    PipelinedRedisClient,
    RedisClient,
    RedisClusterClient,
    RedisSubscriber,
)
from ..observability.wire import get_wire_telemetry
from ..protocol.frames import (
    build_update_frame,
    parse_frame_header,
    parse_frame_headers_batch,
)
from ..protocol.message import IncomingMessage, MessageType, OutgoingMessage
from ..protocol.sync import MESSAGE_YJS_UPDATE, coalesce_updates
from ..aio import spawn_tracked
from ..crdt.encoding import Decoder
from ..server import REDIS_ORIGIN, logger
from ..server.message_receiver import MessageReceiver
from ..server.types import Extension, Payload


class LockContention(Exception):
    """Another instance holds the store lock. Silent: halts the store
    chain without logging an error (reference throws an empty Error)."""

    def __init__(self) -> None:
        super().__init__("")


class _HeldLock:
    __slots__ = ("token", "count", "extend_handle", "extends")

    def __init__(self, token: str) -> None:
        self.token = token
        self.count = 1
        self.extend_handle: Optional[asyncio.TimerHandle] = None
        self.extends = 0


class Redis(Extension):
    # Higher priority so onStoreDocument can intercept the chain before
    # database extensions store the document.
    priority = 1000

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6379,
        prefix: str = "hocuspocus",
        identifier: Optional[str] = None,
        lock_timeout: int = 1000,
        disconnect_delay: int = 1000,
        nodes: Optional[list] = None,
        create_client: Optional[Callable[[], Any]] = None,
        create_subscriber: Optional[Callable[[Callable[[bytes, bytes], None]], Any]] = None,
        lock_retry_count: int = 10,
        lock_retry_delay: int = 100,
        lock_auto_extend: bool = True,
        lock_max_extends: int = 20,
        pipeline: bool = True,
        coalesce: bool = True,
        inbox_batch: bool = True,
        inbox_limit: int = 512,
    ) -> None:
        """Production seams beyond host/port (reference
        `extension-redis/src/Redis.ts:19-50,96-140`): `nodes` switches to
        a slot-routed cluster client; `create_client`/`create_subscriber`
        inject arbitrary client objects (any `RedisCommands`-shaped /
        subscriber-shaped implementation); the store lock retries with
        jittered delay and auto-extends at ttl/2 while a slow store runs.

        Replication fast path knobs: `pipeline` uses the fire-and-forget
        `PipelinedRedisClient` publish lane (single-node only; clusters
        and injected clients keep their own transport), `coalesce`
        merges outbound publishes per (doc, tick) via the broadcast
        fan-out seam, `inbox_batch`/`inbox_limit` batch inbound frame
        application through a bounded per-doc inbox (overflow heals via
        anti-entropy, never silently). All default ON; turning them off
        restores per-op publish/apply for differential testing.
        """
        self.host = host
        self.port = port
        self.prefix = prefix
        self.identifier = identifier or f"host-{uuid.uuid4()}"
        self.lock_timeout = lock_timeout
        self.disconnect_delay = disconnect_delay
        self.lock_retry_count = lock_retry_count
        self.lock_retry_delay = lock_retry_delay
        self.lock_auto_extend = lock_auto_extend
        self.lock_max_extends = lock_max_extends
        self.coalesce = coalesce
        self.inbox_batch = inbox_batch
        self.inbox_limit = inbox_limit

        self.redis_transaction_origin = REDIS_ORIGIN
        if create_client is not None:
            self.pub = create_client()
        elif nodes:
            self.pub = RedisClusterClient(nodes)
        elif pipeline:
            self.pub = PipelinedRedisClient(host, port)
        else:
            self.pub = RedisClient(host, port)
        if create_subscriber is not None:
            self.sub = create_subscriber(self._handle_incoming_message)
        elif nodes:
            self.sub = ClusterSubscriber(nodes, on_message=self._handle_incoming_message)
        else:
            self.sub = RedisSubscriber(host, port, on_message=self._handle_incoming_message)
        # resync on self-healed resubscribe: frames published while this
        # instance's subscriber was down/reconnecting are gone forever
        # (pub/sub is at-most-once) — publishing our SyncStep1 per loaded
        # doc makes peers send back whatever we missed (and vice versa)
        if hasattr(self.sub, "on_reconnect"):
            self.sub.on_reconnect = self._resync_after_reconnect
        # the OUTBOUND half of the same story: the pipelined publish
        # lane arms its resync hook whenever an outage forced it to
        # shed buffered publishes (byte cap / overflow / unreachable
        # server) and fires it once on the next successful reconnect —
        # the join-batch exchange below pulls back exactly the window
        # the sheds dropped
        if hasattr(self.pub, "on_resync"):
            self.pub.on_resync = self._resync_after_reconnect
        self.instance = None
        # plane-served docs: last anti-entropy SyncStep1 publish per
        # doc, plus trailing timers so a QUIESCENT doc still gets one
        # final exchange after its last suppressed change (a dropped
        # window frame must heal even with no further edits)
        self._last_anti_entropy: dict[str, float] = {}
        self._anti_entropy_handles: dict[str, object] = {}
        self.plane_anti_entropy_seconds = 2.0
        # strong refs for fire-and-forget apply/publish tasks: the loop
        # only weakly references tasks, and under fan-out load a GC'd
        # unreferenced task silently drops the apply or the reply
        # publish (see aio.py)
        self._tasks: set = set()
        self.locks: dict[str, _HeldLock] = {}  # lock key -> held state
        self._pending_disconnects: dict[str, asyncio.TimerHandle] = {}
        self._pending_after_store: dict[str, asyncio.TimerHandle] = {}
        identifier_bytes = self.identifier.encode()
        self.message_prefix = bytes([len(identifier_bytes)]) + identifier_bytes
        # -- replication lane state -----------------------------------
        # outbound: doc -> {"updates": [bytes], "frame": reusable local
        # tick frame (valid only while it covers exactly "updates"),
        # "awareness": [frame bytes]} flushed once per event-loop tick
        self._pending_pub: dict[str, dict] = {}
        self._pub_scheduled = False
        # inbound: doc -> bounded deque of (msg_type, payload_offset,
        # raw frame); drained once per tick, serialized by _drain_lock
        self._inboxes: dict[str, deque] = {}
        # raw frames awaiting header parse: the subscriber callback only
        # stages — headers for the whole backlog are parsed in ONE
        # native batch call when the drain routes them (_route_staged)
        self._inbox_staging: list = []
        self._inbox_scheduled = False
        self._drain_lock = asyncio.Lock()
        self._overflowed: set[str] = set()
        # observability + bench accounting for the fast path
        self.replication_stats = {
            "updates_enqueued": 0,
            "update_frames_published": 0,
            "awareness_frames_published": 0,
            "frames_saved": 0,
            "frames_received": 0,
            "inbound_applies": 0,
            "inbound_merged_saved": 0,
            "inbox_overflows": 0,
        }
        get_wire_telemetry().track_redis_inbox(self)

    # -- keys / framing ----------------------------------------------------

    def get_key(self, document_name: str) -> str:
        return f"{self.prefix}:{document_name}"

    def lock_key(self, document_name: str) -> str:
        return f"{self.get_key(document_name)}:lock"

    def encode_message(self, message: bytes) -> bytes:
        return self.message_prefix + message

    def decode_message(self, data: bytes) -> tuple[str, bytes]:
        identifier_length = data[0]
        identifier = data[1 : identifier_length + 1].decode()
        return identifier, data[identifier_length + 1 :]

    # -- hooks -------------------------------------------------------------

    async def on_configure(self, data: Payload) -> None:
        self.instance = data.instance

    async def after_load_document(self, data: Payload) -> None:
        document_name = data.document_name
        await self.sub.subscribe(self.get_key(document_name))
        if self.coalesce:
            self._register_replication_seam(data.document)
        await self._publish_join_batch(document_name, data.document)

    async def _publish_join_batch(self, document_name: str, document) -> None:
        """The join/resync protocol: SyncStep1 + QueryAwareness leave as
        ONE pipelined batch (enqueue-only on the pipelined client, a
        single execute_many round trip otherwise) instead of two
        serialized publish RTTs."""
        step1 = (
            OutgoingMessage(document_name)
            .create_sync_message()
            .write_first_sync_step_for(document)
            .to_bytes()
        )
        query = OutgoingMessage(document_name).write_query_awareness().to_bytes()
        await self._publish_batch(document_name, [step1, query])

    def _register_replication_seam(self, document) -> None:
        """Point the document's broadcast tick at the publish lane: the
        tick's local-origin updates (and its awareness frame) replicate
        with the tick's own coalescing + encode."""
        fanout = getattr(document, "fanout", None)
        if fanout is None:
            return
        name = document.name

        def replicate_updates(frame, updates, _name=name):
            self._queue_replication(_name, updates, frame)

        def replicate_awareness(frame, _name=name):
            self._queue_awareness_frame(_name, frame)

        fanout.replicate_updates = replicate_updates
        fanout.replicate_awareness = replicate_awareness

    async def publish_first_sync_step(self, document_name: str, document) -> None:
        sync_message = (
            OutgoingMessage(document_name)
            .create_sync_message()
            .write_first_sync_step_for(document)
        )
        await self._publish(document_name, sync_message.to_bytes())

    # -- the publish lane --------------------------------------------------

    async def _publish(self, document_name: str, payload: bytes) -> None:
        """Publish one framed message; enqueue-only on the pipelined
        client (the ack is consumed by its reply reader), awaited
        round-trip otherwise."""
        channel = self.get_key(document_name)
        nowait = getattr(self.pub, "publish_nowait", None)
        if nowait is not None:
            # zero-copy: prefix + frame ride as segments; the pipelined
            # lane joins them straight into the socket write
            nowait(channel, (self.message_prefix, payload))
        else:
            await self.pub.publish(channel, self.encode_message(payload))

    def _publish_nowait(self, document_name: str, payload: bytes) -> None:
        """Sync-context publish: enqueue on the pipelined client, else a
        tracked fire-and-forget task."""
        channel = self.get_key(document_name)
        nowait = getattr(self.pub, "publish_nowait", None)
        if nowait is not None:
            # zero-copy segment publish (see _publish)
            nowait(channel, (self.message_prefix, payload))
        else:
            spawn_tracked(
                self._tasks, self.pub.publish(channel, self.encode_message(payload))
            )

    async def _publish_batch(self, document_name: str, payloads: list) -> None:
        """Ship several messages for one doc in ONE round trip."""
        channel = self.get_key(document_name)
        nowait = getattr(self.pub, "publish_nowait", None)
        if nowait is not None:
            for payload in payloads:
                # zero-copy segment publish (see _publish)
                nowait(channel, (self.message_prefix, payload))
            return
        execute_many = getattr(self.pub, "execute_many", None)
        if execute_many is not None:
            await execute_many(
                [
                    ("PUBLISH", channel, self.encode_message(payload))
                    for payload in payloads
                ]
            )
            return
        for payload in payloads:
            await self.pub.publish(channel, self.encode_message(payload))

    def _queue_replication(
        self, document_name: str, updates: list, frame: Optional[bytes] = None
    ) -> None:
        """Enqueue local update payloads for the per-tick replication
        flush. `frame` is the local tick's already-built wire frame,
        reusable only while it covers exactly this entry's updates."""
        entry = self._pending_pub.setdefault(
            document_name, {"updates": [], "frame": None, "awareness": []}
        )
        if entry["updates"]:
            entry["frame"] = None  # frame no longer covers the entry
        else:
            entry["frame"] = frame
        entry["updates"].extend(updates)
        self.replication_stats["updates_enqueued"] += len(updates)
        self._schedule_pub_flush()

    def _queue_awareness_frame(self, document_name: str, frame: bytes) -> None:
        entry = self._pending_pub.setdefault(
            document_name, {"updates": [], "frame": None, "awareness": []}
        )
        entry["awareness"].append(frame)
        self._schedule_pub_flush()

    def _schedule_pub_flush(self) -> None:
        if self._pub_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._flush_publishes()  # no loop (direct/test use)
            return
        self._pub_scheduled = True
        loop.call_soon(self._flush_publishes)

    def _flush_publishes(self) -> None:
        """One replication flush: per doc, merge the tick's updates into
        ONE frame (reusing the local tick frame when handed one; falling
        back to per-update frames on merge failure so nothing is lost),
        publish awareness piggybacked — all enqueued into the pipelined
        outbox, which ships the whole tick in one write+drain."""
        self._pub_scheduled = False
        pending = self._pending_pub
        if not pending:
            return
        self._pending_pub = {}
        stats = self.replication_stats
        wire = get_wire_telemetry()
        for name, entry in pending.items():
            updates = entry["updates"]
            frame = entry["frame"]
            if updates:
                saved = 0
                if frame is None:
                    merged = coalesce_updates(updates)
                    if merged is None:
                        # merge failure: per-update frames, no loss
                        for update in updates:
                            self._publish_nowait(
                                name, build_update_frame(name, update)
                            )
                        stats["update_frames_published"] += len(updates)
                    else:
                        self._publish_nowait(name, build_update_frame(name, merged))
                        stats["update_frames_published"] += 1
                        saved = len(updates) - 1
                else:
                    # encode-once across the boundary: the local tick's
                    # frame bytes ship as-is
                    self._publish_nowait(name, frame)
                    stats["update_frames_published"] += 1
                    saved = len(updates) - 1
                if saved:
                    stats["frames_saved"] += saved
                    if wire.enabled:
                        wire.record_redis_frames_saved(saved, direction="publish")
            for awareness_frame in entry["awareness"]:
                self._publish_nowait(name, awareness_frame)
                stats["awareness_frames_published"] += 1

    async def _resync_after_reconnect(self) -> None:
        """Subscriber self-healed after an outage: pull missed state.

        Publishing SyncStep1 (our state vector) per loaded doc makes
        every peer reply Step2 with what we lack + their own Step1, so
        both directions close the at-most-once gap. Awareness states
        are re-requested the same way. Best-effort: a doc that fails
        here heals on its next change exchange."""
        if self.instance is None:
            return
        for name, document in list(self.instance.documents.items()):
            try:
                await self._publish_join_batch(name, document)
            except Exception:
                logger.log_error(f"[redis] post-reconnect resync failed for {name!r}")

    async def on_store_document(self, data: Payload) -> None:
        """Acquire the distributed store lock; losing after all retries
        means another instance stores — halt the chain silently."""
        resource = self.lock_key(data.document_name)
        held = self.locks.get(resource)
        if held is not None:
            # concurrent store of the same doc on this instance (the
            # saveMutex makes this rare): reenter instead of clobbering
            # the token and orphaning the first holder's release
            held.count += 1
            return
        token = str(uuid.uuid4())
        for attempt in range(self.lock_retry_count + 1):
            if await self.pub.acquire_lock(resource, token, self.lock_timeout):
                held = _HeldLock(token)
                self.locks[resource] = held
                if self.lock_auto_extend:
                    self._schedule_lock_extend(resource, held)
                return
            if attempt < self.lock_retry_count:
                delay = self.lock_retry_delay * (0.5 + random.random())
                await asyncio.sleep(delay / 1000)
        raise LockContention()

    def _schedule_lock_extend(self, resource: str, held: _HeldLock) -> None:
        """Keep a held lock alive while a slow store runs (ttl/2 cadence;
        the reference's redlock extends the same way)."""

        def extend() -> None:
            if self.locks.get(resource) is not held:
                return
            # bounded: a leaked lock (process wedged mid-store) must
            # eventually expire so other instances can store again
            held.extends += 1
            if held.extends > self.lock_max_extends:
                return

            async def run() -> None:
                try:
                    still_held = await self.pub.extend_lock(
                        resource, held.token, self.lock_timeout
                    )
                except Exception:
                    return  # redis gone: the lock will expire on its own
                if still_held and self.locks.get(resource) is held:
                    self._schedule_lock_extend(resource, held)

            spawn_tracked(self._tasks, run())

        held.extend_handle = asyncio.get_event_loop().call_later(
            self.lock_timeout / 2000, extend
        )

    async def _release_store_lock(self, document_name: str) -> None:
        resource = self.lock_key(document_name)
        held = self.locks.get(resource)
        if held is not None:
            held.count -= 1
            if held.count <= 0:
                self.locks.pop(resource, None)
                if held.extend_handle is not None:
                    held.extend_handle.cancel()
                try:
                    await self.pub.release_lock(resource, held.token)
                except Exception:
                    pass  # lock expires on its own

    async def on_store_document_failed(self, data: Payload) -> None:
        """A later store hook failed: release our lock so other instances
        can store (after_store_document is skipped on chain failure)."""
        await self._release_store_lock(data.document_name)

    async def after_store_document(self, data: Payload) -> None:
        await self._release_store_lock(data.document_name)
        await self._direct_connection_grace(data)

    async def _direct_connection_grace(self, data: Payload) -> None:
        # Direct-connection stores need a grace period so sync messages
        # reach the subscription before disconnect tears it down.
        if data.socket_id == "server":
            document_name = data.document_name
            pending = self._pending_after_store.pop(document_name, None)
            if pending is not None:
                pending.cancel()
            waiter: asyncio.Future = asyncio.get_event_loop().create_future()

            def resolve() -> None:
                self._pending_after_store.pop(document_name, None)
                if not waiter.done():
                    waiter.set_result(None)

            self._pending_after_store[document_name] = asyncio.get_event_loop().call_later(
                self.disconnect_delay / 1000, resolve
            )
            await waiter

    async def on_awareness_update(self, data: Payload) -> None:
        document = data.document if hasattr(data, "document") else None
        fanout = getattr(document, "fanout", None)
        if (
            self.coalesce
            and fanout is not None
            and fanout.replicate_awareness is not None
        ):
            # piggybacked on the broadcast tick: the fan-out engine's
            # per-tick awareness frame replicates via the publish lane
            # (one encode, one publish per doc-tick) — publishing here
            # too would double every awareness frame
            return
        changed_clients = data.added + data.updated + data.removed
        message = OutgoingMessage(data.document_name).create_awareness_update_message(
            data.awareness, changed_clients
        )
        await self._publish(data.document_name, message.to_bytes())

    def _handle_incoming_message(self, channel: bytes, data: bytes) -> None:
        identifier, message_data = self.decode_message(data)
        if identifier == self.identifier:
            return
        if self.instance is None:
            return
        if not self.inbox_batch:
            message = IncomingMessage(message_data)
            document_name = message.read_var_string()
            message.write_var_string(document_name)
            document = self.instance.documents.get(document_name)
            if document is None:
                return
            receiver = MessageReceiver(message, self.redis_transaction_origin)
            spawn_tracked(
                self._tasks,
                receiver.apply(document, None, self._make_reply(document.name)),
            )
            return
        # stage only: the header parse for the whole backlog happens in
        # ONE native batch call when the drain routes it (_route_staged)
        self._inbox_staging.append(message_data)
        self._schedule_inbox_drain()

    def _route_staged(self) -> None:
        """Route staged raw frames into per-doc inboxes. Headers for the
        whole backlog are parsed in one native batch call (malformed
        frames yield None slots and are dropped — nothing safe to
        enqueue)."""
        staged = self._inbox_staging
        if not staged or self.instance is None:
            return
        self._inbox_staging = []
        headers = parse_frame_headers_batch(staged, skip_malformed=True)
        documents = self.instance.documents
        stats = self.replication_stats
        wire = get_wire_telemetry()
        for raw, header in zip(staged, headers):
            if header is None:
                continue  # malformed frame
            document_name, message_type, offset = header
            if document_name not in documents:
                continue
            inbox = self._inboxes.setdefault(document_name, deque())
            stats["frames_received"] += 1
            if len(inbox) >= self.inbox_limit:
                # bounded inbox: the frame is DROPPED, but never
                # silently — the drain publishes an anti-entropy
                # SyncStep1 for the doc, and the resulting state
                # exchange carries everything the dropped frames did
                # (sync is state-based)
                self._overflowed.add(document_name)
                stats["inbox_overflows"] += 1
                if wire.enabled:
                    wire.record_redis_inbox_overflow()
                continue
            inbox.append((message_type, offset, raw))

    def _make_reply(self, document_name: str) -> Callable[[bytes], None]:
        def reply(response: bytes) -> None:
            self._publish_nowait(document_name, response)

        return reply

    def inbox_depth(self) -> int:
        """Queued inbound frames (the wire-telemetry depth gauge),
        staged-but-unrouted frames included."""
        return len(self._inbox_staging) + sum(
            len(inbox) for inbox in self._inboxes.values()
        )

    def _schedule_inbox_drain(self) -> None:
        if self._inbox_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # subscriber callbacks only fire inside a loop
        self._inbox_scheduled = True
        loop.call_soon(self._start_inbox_drain)

    def _start_inbox_drain(self) -> None:
        self._inbox_scheduled = False
        # route BEFORE the drain task (which serializes on _drain_lock):
        # frames keep flowing into the bounded inboxes — and overflow is
        # counted — even while a slow drain holds the lock
        self._route_staged()
        if not self._inboxes and not self._overflowed:
            return
        spawn_tracked(self._tasks, self._drain_inboxes())

    async def _drain_inboxes(self) -> None:
        """One inbound tick: per doc, decode all queued frames, merge
        contiguous update frames into ONE apply_update (one local
        fan-out tick), apply everything else in arrival order through
        the normal receiver. Serialized: two drains must not interleave
        one doc's frames."""
        async with self._drain_lock:
            while self._inbox_staging or self._inboxes or self._overflowed:
                self._route_staged()
                inboxes = self._inboxes
                overflowed = self._overflowed
                self._inboxes = {}
                self._overflowed = set()
                wire = get_wire_telemetry()
                for document_name, frames in inboxes.items():
                    document = (
                        self.instance.documents.get(document_name)
                        if self.instance is not None
                        else None
                    )
                    if document is None:
                        continue  # unloaded while queued
                    if wire.enabled:
                        wire.record_redis_inbox_drain(len(frames))
                    try:
                        await self._apply_doc_frames(document, frames)
                    except Exception:
                        logger.log_error(
                            f"[redis] inbound drain failed for {document_name!r}"
                        )
                for document_name in overflowed:
                    # anti-entropy healing for dropped frames
                    document = (
                        self.instance.documents.get(document_name)
                        if self.instance is not None
                        else None
                    )
                    if document is None:
                        continue
                    try:
                        await self._publish_join_batch(document_name, document)
                    except Exception:
                        logger.log_error(
                            f"[redis] overflow resync failed for {document_name!r}"
                        )

    @staticmethod
    def _extract_update(message_type: int, offset: int, raw: bytes) -> Optional[bytes]:
        """The update payload of a Sync/SyncReply UPDATE frame, else
        None (anything with reply or hook semantics keeps the receiver
        path)."""
        if message_type not in (MessageType.Sync, MessageType.SyncReply):
            return None
        try:
            decoder = Decoder(raw)
            decoder.pos = offset
            if decoder.read_var_uint() != MESSAGE_YJS_UPDATE:
                return None
            return decoder.read_var_uint8_array()
        except Exception:
            return None

    async def _apply_doc_frames(self, document, frames) -> None:
        stats = self.replication_stats
        pending_updates: list = []

        def flush_updates() -> None:
            if not pending_updates:
                return
            updates = list(pending_updates)
            pending_updates.clear()
            merged = coalesce_updates(updates) if len(updates) > 1 else updates[0]
            if merged is not None:
                try:
                    apply_update(document, merged, self.redis_transaction_origin)
                    stats["inbound_applies"] += 1
                    saved = len(updates) - 1
                    if saved:
                        stats["inbound_merged_saved"] += saved
                        wire = get_wire_telemetry()
                        if wire.enabled:
                            wire.record_redis_frames_saved(saved, direction="apply")
                    return
                except Exception:
                    pass  # fall through to per-update application
            for update in updates:
                try:
                    apply_update(document, update, self.redis_transaction_origin)
                    stats["inbound_applies"] += 1
                except Exception:
                    logger.log_error(
                        f"[redis] inbound update apply failed for {document.name!r}"
                    )

        for message_type, offset, raw in frames:
            update = self._extract_update(message_type, offset, raw)
            if update is not None:
                pending_updates.append(update)
                continue
            # order matters: apply buffered updates before a frame with
            # handshake/reply semantics (Step1/Step2/awareness/...)
            flush_updates()
            message = IncomingMessage(raw)
            document_name = message.read_var_string()
            message.write_var_string(document_name)
            receiver = MessageReceiver(message, self.redis_transaction_origin)
            try:
                await receiver.apply(document, None, self._make_reply(document.name))
            except Exception:
                logger.log_error(
                    f"[redis] inbound frame apply failed for {document.name!r}"
                )
        flush_updates()

    async def on_plane_broadcast(self, data: Payload) -> None:
        """Cross-instance fan-out of a serve-mode plane window: publish
        the merged update frame itself — peers apply it directly. One
        coalesced message per doc-window instead of the per-op
        SyncStep1/Step2 round trips (which remain, rate-limited, as
        anti-entropy below and as the join protocol). With coalescing
        on, the window rides the per-tick publish lane — several
        windows landing in one event-loop tick merge into one frame,
        and the publish shares the pipelined flush with every other
        channel's tick traffic."""
        if self.coalesce:
            self._queue_replication(data.document_name, [data.update])
            return
        await self._publish(
            data.document_name, build_update_frame(data.document_name, data.update)
        )

    async def on_change(self, data: Payload) -> None:
        if data.transaction_origin == self.redis_transaction_origin:
            return
        document = data.document
        source = getattr(document, "broadcast_source", None)
        capturing = source is not None and (
            not hasattr(source, "is_capturing")
            or source.is_capturing(data.document_name)
        )
        fanout = getattr(document, "fanout", None)
        coalescing = (
            self.coalesce
            and fanout is not None
            and fanout.replicate_updates is not None
        )
        if capturing or coalescing:
            # steady propagation rides the coalesced update frames (the
            # plane's window broadcasts / the CPU tick's replication
            # seam); keep a LOW-RATE SyncStep1 exchange per doc as
            # anti-entropy so a dropped pub/sub message heals instead
            # of desyncing the peer forever
            name = data.document_name
            now = asyncio.get_event_loop().time()
            last = self._last_anti_entropy.get(name, 0.0)
            if now - last < self.plane_anti_entropy_seconds:
                # TRAILING edge: the final change before quiescence must
                # still trigger one exchange after the window closes
                if name not in self._anti_entropy_handles:
                    def fire(n=name):
                        self._anti_entropy_handles.pop(n, None)
                        doc_now = (
                            self.instance.documents.get(n) if self.instance else None
                        )
                        if doc_now is not None:
                            self._last_anti_entropy[n] = asyncio.get_event_loop().time()
                            spawn_tracked(
                                self._tasks, self.publish_first_sync_step(n, doc_now)
                            )

                    self._anti_entropy_handles[name] = asyncio.get_event_loop().call_later(
                        self.plane_anti_entropy_seconds, fire
                    )
                return
            self._last_anti_entropy[name] = now
            # a pending trailing-edge timer would fire a second SyncStep1
            # right after this fresh one, busting the rate limit
            handle = self._anti_entropy_handles.pop(name, None)
            if handle is not None:
                handle.cancel()
        await self.publish_first_sync_step(data.document_name, data.document)

    async def on_disconnect(self, data: Payload) -> None:
        document_name = data.document_name
        pending = self._pending_disconnects.pop(document_name, None)
        if pending is not None:
            pending.cancel()

        def disconnect() -> None:
            self._pending_disconnects.pop(document_name, None)
            self._last_anti_entropy.pop(document_name, None)
            handle = self._anti_entropy_handles.pop(document_name, None)
            if handle is not None:
                handle.cancel()
            document = self.instance.documents.get(document_name) if self.instance else None
            if document is not None and document.get_connections_count() > 0:
                return
            spawn_tracked(self._tasks, self.sub.unsubscribe(self.get_key(document_name)))
            if document is not None:
                spawn_tracked(self._tasks, self.instance.unload_document(document))

        # Delay to allow last-minute syncs to arrive on the subscription.
        self._pending_disconnects[document_name] = asyncio.get_event_loop().call_later(
            self.disconnect_delay / 1000, disconnect
        )

    async def before_broadcast_stateless(self, data: Payload) -> None:
        message = OutgoingMessage(data.document_name).write_broadcast_stateless(data.payload)
        await self._publish(data.document_name, message.to_bytes())

    async def on_destroy(self, data: Payload) -> None:
        for handle in list(self._pending_disconnects.values()):
            handle.cancel()
        for handle in list(self._anti_entropy_handles.values()):
            handle.cancel()
        self._anti_entropy_handles.clear()
        for handle in list(self._pending_after_store.values()):
            handle.cancel()
        for held in list(self.locks.values()):
            if held.extend_handle is not None:
                held.extend_handle.cancel()
        # ship what the lane already holds: enqueue pending frames, then
        # give the publish machinery one BOUNDED chance to drain before
        # close() sheds whatever is left (pub/sub is at-most-once and
        # peers heal via anti-entropy, so a timeout here loses nothing
        # that the protocol can't recover)
        try:
            self._flush_publishes()
            waitables = [task for task in self._tasks if not task.done()]
            flush_task = getattr(self.pub, "_flush_task", None)
            if flush_task is not None and not flush_task.done():
                waitables.append(flush_task)
            if waitables:
                await asyncio.wait_for(
                    asyncio.gather(*waitables, return_exceptions=True), timeout=1.0
                )
        except Exception:
            pass
        self._pending_pub.clear()
        self._inbox_staging.clear()
        self._inboxes.clear()
        self._overflowed.clear()
        self.pub.close()
        self.sub.close()
