"""Cell-side edge-session ingress.

A merge cell is an ordinary server (planes, WAL, overload ladder — the
whole stack) whose clients arrive over the relay lane instead of
websockets. `CellIngressExtension` subscribes to the cell's relay
channel and turns each OPEN envelope into a real session through
`Hocuspocus.handle_connection`: the same `ClientConnection` auth
handshake, the same per-doc `Connection`s, and — the point — the same
`DocumentFanout`, so the encode-once broadcast tick serves edge
sessions as plain audience members (one merged frame, one audience
snapshot, catch-up tiering for a slow edge, WAL delivery gates intact).

Outbound frames ride a `CallbackWebSocketTransport` whose writer
enqueues onto the pipelined RESP client — N frames in one event-loop
tick leave as ONE write+drain, the pipelined lane's economics applied to the
edge hop.

Lifecycle on the control channel: `CELL_UP` announces (and re-announces
on a heartbeat cadence — the router's liveness signal), the
graceful drain fires the new `on_drain` hook which announces
`CELL_DRAINING` BEFORE stores begin (edges remap and re-establish while
the old cell is still flushing), and `on_destroy` announces
`CELL_DOWN`.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

import json
import time

from ..aio import spawn_tracked
from ..net.resp import PipelinedRedisClient, RedisSubscriber
from ..observability.costs import get_cost_ledger
from ..observability.fleet import build_digest, get_fleet_view
from ..observability.flight_recorder import get_flight_recorder
from ..observability.tracing import get_tracer
from ..server import logger
from ..server.hocuspocus import RequestInfo
from ..server.transports import CallbackWebSocketTransport
from ..server.types import Extension, Payload
from ..fleet.roster import PeerRoster, qualify_cell_id
from . import relay
from .relay import DEFAULT_PREFIX
from .replica import ReplicaManager


class _CellEdgeSession:
    """One relay session: a synthetic transport + the real server-side
    session pipeline, with an ordered inbound pump (frames must apply
    in relay order or the auth/sync handshake interleaves)."""

    def __init__(
        self, ext: "CellIngressExtension", session_id: str, edge_id: str, aux: dict
    ) -> None:
        self.ext = ext
        self.session_id = session_id
        self.edge_id = edge_id
        self._closed = False
        # (payload, fleet trace context or None) — the context must ride
        # the queue so the pump can scope it to exactly its frame
        self._queue: "asyncio.Queue[Optional[tuple]]" = asyncio.Queue()
        headers = {"x-hocuspocus-edge": edge_id}
        context: dict = {"edge": edge_id}
        tenant = aux.get("tenant")
        if tenant:
            headers["x-tenant"] = str(tenant)
            context["tenant"] = str(tenant)
        self.transport = CallbackWebSocketTransport(
            send_async=self._send_to_edge,
            close_async=self._closed_by_server,
        )
        self.client = ext.instance.handle_connection(
            self.transport,
            RequestInfo(headers=headers, url="/__edge__", remote=edge_id),
            context,
        )
        self._pump_task = asyncio.ensure_future(self._pump())

    # -- inbound (edge -> cell) --------------------------------------------

    def feed(self, payload: bytes, trace_ctx: Optional[dict] = None) -> None:
        if not self._closed:
            self._queue.put_nowait((payload, trace_ctx))

    async def _pump(self) -> None:
        tracer = get_tracer()
        while True:
            item = await self._queue.get()
            if item is None:
                return
            payload, trace_ctx = item
            try:
                if trace_ctx is not None:
                    # cross-tier trace context (edge-sampled): visible
                    # to UpdateTraceBook.stamp for exactly this dispatch
                    tracer.fleet_context = trace_ctx
                try:
                    await self.client.handle_message(payload)
                finally:
                    if trace_ctx is not None:
                        tracer.fleet_context = None
            except Exception as error:
                logger.log_error(
                    f"[edge-cell] session {self.session_id} frame failed: {error!r}"
                )
                self.close(1011, "internal error")
                return

    def detach(self, document_name: str) -> None:
        """Close ONE doc channel (the edge remapped it elsewhere); the
        rest of the session keeps flowing."""
        connection = self.client.document_connections.get(document_name)
        if connection is not None:
            connection.close()

    # -- outbound (cell -> edge) -------------------------------------------

    async def _send_to_edge(self, data: bytes) -> None:
        # zero-copy: the broadcast frame (encode-once, shared by the
        # whole audience) rides as a memoryview segment — the pipelined
        # publish lane joins header+payload straight into the socket
        # write, so the frame bytes are copied exactly once
        self.ext.publish_to_edge(
            self.edge_id,
            relay.encode_envelope_view(relay.FRAME, self.session_id, "", data),
        )
        self.ext.counters["frames_out"] += 1

    async def _closed_by_server(self, code: int, reason: str) -> None:
        """The server side closed the session (drain 1012, overflow
        1013, destroy): tell the edge so it can re-establish on another
        cell instead of waiting on a dead channel."""
        self.ext.publish_to_edge(
            self.edge_id,
            relay.encode_envelope(
                relay.CLOSED, self.session_id, f"{code}:{reason}"
            ),
        )
        self._finish(code, reason)

    # -- teardown ----------------------------------------------------------

    def close(self, code: int = 1000, reason: str = "edge closed") -> None:
        self.transport.abort()
        self._finish(code, reason)

    def _finish(self, code: int, reason: str) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put_nowait(None)
        self.ext.sessions.pop(self.session_id, None)
        spawn_tracked(
            self.ext._tasks, self.client.handle_transport_close(code, reason)
        )


class CellIngressExtension(Extension):
    """Makes this server a merge cell: relay-session ingress + the
    control-channel lifecycle (announce/heartbeat/drain/down)."""

    # before ordinary extensions so the announce machinery configures
    # early, after Metrics (1000) so telemetry is lit first
    priority = 950

    def __init__(
        self,
        cell_id: str,
        host: str = "127.0.0.1",
        port: int = 6379,
        prefix: str = DEFAULT_PREFIX,
        create_client: Optional[Any] = None,
        create_subscriber: Optional[Any] = None,
        announce_interval_s: float = 2.0,
        host_id: Optional[str] = None,
    ) -> None:
        # cross-host fleets (fleet/roster.py): a host qualifier turns
        # the cell id into "host/cell" — rendezvous hashes the full
        # string, so qualified cells are first-class placement targets
        # and edges can tell foreign announcers from local ones
        self.cell_id = qualify_cell_id(host_id, cell_id)
        self.host_id = host_id
        self.prefix = prefix
        self.announce_interval_s = announce_interval_s
        self.instance = None
        self.draining = False
        self.sessions: "dict[str, _CellEdgeSession]" = {}
        self.counters = {
            "sessions_opened": 0,
            "sessions_closed": 0,
            "frames_in": 0,
            "frames_out": 0,
            "detaches": 0,
            "refused_draining": 0,
            "trace_returns_sent": 0,
        }
        self._tasks: set = set()
        # fleet-membership mirror: every control-channel lifecycle
        # transition (our own announce echo included — all subscribers
        # count the same stream) bumps roster.epoch, published in the
        # digest so /debug/fleet can flag cell-vs-cell roster skew
        self.roster = PeerRoster()
        # hot-doc replication roles (edge/replica.py): which docs this
        # cell owns (streams ticks for) vs follows (applies ticks for)
        self.replicas = ReplicaManager(self)
        self._announce_handle: Optional[asyncio.TimerHandle] = None
        # cross-tier trace-return drain: deposits may land from the
        # flush executor thread, so the wake-up crosses via
        # call_soon_threadsafe onto the loop captured at listen time
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._trace_flush_scheduled = False
        if create_client is not None:
            self.pub = create_client()
        else:
            self.pub = PipelinedRedisClient(host, port)
        if create_subscriber is not None:
            self.sub = create_subscriber(self._on_message)
        else:
            self.sub = RedisSubscriber(host, port, on_message=self._on_message)

    # -- wiring -------------------------------------------------------------

    def _publish(self, channel: str, envelope) -> None:
        """Publish one envelope (bytes, or a zero-copy segment list from
        `relay.encode_envelope_view`), preferring the pipelined
        enqueue-only path (per-tick coalesced lane) over a spawned
        await."""
        nowait = getattr(self.pub, "publish_nowait", None)
        if nowait is not None:
            nowait(channel, envelope)
        else:
            if isinstance(envelope, (list, tuple)):
                envelope = b"".join(envelope)
            spawn_tracked(self._tasks, self.pub.publish(channel, envelope))

    def publish_to_edge(self, edge_id: str, envelope) -> None:
        self._publish(relay.edge_channel(self.prefix, edge_id), envelope)

    def publish_to_cell(self, cell_id: str, envelope) -> None:
        """Cell → cell (the replica lane: FOLLOW/REPLICA_TICK/…)."""
        self._publish(relay.cell_channel(self.prefix, cell_id), envelope)

    def _announce(self, kind: int) -> None:
        self._publish(
            relay.control_channel(self.prefix),
            relay.encode_envelope(kind, self.cell_id),
        )

    def _schedule_announce(self) -> None:
        if self.draining:
            return
        loop = asyncio.get_event_loop()
        self._announce_handle = loop.call_later(
            self.announce_interval_s, self._heartbeat
        )

    def _heartbeat(self) -> None:
        self._announce_handle = None
        if self.draining:
            return
        self._announce(relay.CELL_UP)
        self._publish_digest()
        self._schedule_announce()

    def _publish_digest(self) -> None:
        """Telemetry federation (docs/guides/observability.md fleet
        view): one compact digest per heartbeat on the control channel,
        ingested locally too so this cell's own /debug/fleet includes
        itself. Gated on the fleet view being lit (by Metrics) — like
        every other collector, zero cost until observability is on."""
        view = get_fleet_view()
        if not view.enabled:
            return
        try:
            digest = build_digest(
                role="cell",
                node_id=self.cell_id,
                instance=self.instance,
                interval_s=self.announce_interval_s,
                extra={
                    "cell": {
                        "cell_id": self.cell_id,
                        "draining": self.draining,
                        "edge_sessions": len(self.sessions),
                    },
                    # dynamic-roster epoch: cells that watched the same
                    # control stream agree; divergence IS the skew
                    # /debug/fleet flags for the cell role
                    "roster_epoch": self.roster.epoch,
                    # replication topology: per-doc follower sets +
                    # tick seqs — edges harvest the seqs to pick the
                    # FRESHEST follower at promotion time, /debug/fleet
                    # renders the followers column off the same key
                    "replica": self.replicas.stats(),
                },
            )
        except Exception:
            return  # a digest must never fail the heartbeat
        view.ingest(digest)
        self._publish(
            relay.control_channel(self.prefix),
            relay.encode_envelope(
                relay.DIGEST,
                self.cell_id,
                "",
                json.dumps(digest, separators=(",", ":")).encode(),
            ),
        )

    # -- hooks ---------------------------------------------------------------

    async def on_configure(self, data: Payload) -> None:
        self.instance = data.instance
        # fleet identity: debug payload headers + cross-tier span lanes
        get_fleet_view().set_identity("cell", self.cell_id)
        # hocuspocus_replica_* metrics: adopted by a co-installed
        # Metrics extension's registry (same pattern as the edge's
        # hocuspocus_edge_* family)
        for extension in getattr(data.instance, "_extensions", []):
            registry = getattr(extension, "registry", None)
            if registry is not None and callable(
                getattr(registry, "register", None)
            ):
                for metric in self.replicas.metrics():
                    try:
                        registry.register(metric)
                    except ValueError:
                        pass  # already adopted (shared registry)
                break
        # pin THIS cell's id onto its planes' trace books: the
        # process-global identity is last-writer, so in a multi-cell
        # process the deposit-site fallback would attribute every
        # trace to whichever role configured last (the edge picks its
        # clock-offset estimator by this id). Supervised planes whose
        # runtime attaches later fall back to the process identity.
        extensions = getattr(data.instance, "_extensions", None) or getattr(
            data.instance.configuration, "extensions", []
        )
        for ext in extensions:
            planes = []
            plane = getattr(ext, "plane", None)
            if plane is not None:
                planes.append(plane)
            for shard in getattr(ext, "shards", None) or ():
                planes.append(shard.plane)
            for plane in planes:
                book = getattr(plane, "update_traces", None)
                if book is not None:
                    book.node_id = self.cell_id

    async def on_listen(self, data: Payload) -> None:
        await self.sub.subscribe(relay.cell_channel(self.prefix, self.cell_id))
        # the control channel too: peer digests (and peer lifecycle)
        # feed this cell's own FleetView, so /debug/fleet answers the
        # same on every role
        await self.sub.subscribe(relay.control_channel(self.prefix))
        # cross-tier trace returns: the trace book deposits a return
        # context when a traced relayed update closes; this cell ships
        # them back to the stamping edge as TRACE_RET envelopes
        self._loop = asyncio.get_running_loop()
        get_fleet_view().trace_returns.add_waker(self._wake_trace_flush)
        self._announce(relay.CELL_UP)
        self._publish_digest()
        self._schedule_announce()
        get_flight_recorder().record("__edge__", "cell_up", cell=self.cell_id)

    # -- cross-tier trace returns -------------------------------------------

    def _wake_trace_flush(self) -> None:
        """Outbox deposit seam — may fire on the flush executor thread,
        so the actual drain hops onto the event loop. The scheduled
        flag is a benign race: worst case two wakes drain once."""
        if self._trace_flush_scheduled or self._loop is None:
            return
        self._trace_flush_scheduled = True
        try:
            self._loop.call_soon_threadsafe(self._flush_trace_returns)
        except RuntimeError:
            self._trace_flush_scheduled = False  # loop already closed

    def _flush_trace_returns(self) -> None:
        self._trace_flush_scheduled = False
        by_edge: "dict[str, list]" = {}
        for _doc, contexts in get_fleet_view().trace_returns.take_all().items():
            for context in contexts:
                edge_id = str(context.get("e", ""))
                if edge_id:
                    by_edge.setdefault(edge_id, []).append(context)
        for edge_id, contexts in by_edge.items():
            self.publish_to_edge(
                edge_id,
                relay.encode_envelope(
                    relay.TRACE_RET,
                    self.cell_id,
                    relay.encode_trace_aux({"r": contexts}),
                ),
            )
            self.counters["trace_returns_sent"] += len(contexts)

    async def on_drain(self, data: Payload) -> None:
        """The graceful drain announces departure FIRST: edges remap
        this cell's docs and re-establish sessions elsewhere while the
        stores below are still flushing (the handoff half of the drain
        contract — docs/guides/edge-routing.md)."""
        self.draining = True
        if self._announce_handle is not None:
            self._announce_handle.cancel()
            self._announce_handle = None
        self._announce(relay.CELL_DRAINING)
        get_flight_recorder().record("__edge__", "cell_draining", cell=self.cell_id)
        # give the announcement its flush tick before stores monopolize
        # the loop (publish_nowait ships on the next tick)
        await asyncio.sleep(0)

    async def after_load_document(self, data: Payload) -> None:
        # a doc this cell owns/follows was (re)loaded: the fresh fanout
        # has no replica seam yet — re-attach before its first tick
        self.replicas.on_document_loaded(data.document_name, data.document)

    async def on_plane_broadcast(self, data: Payload) -> None:
        """Plane-served docs bypass the fanout tick; the merged window
        (remote/replica-origin ops already stripped) feeds the replica
        lane here — owner ticks it to followers, a follower pushes it
        up to its owner."""
        self.replicas.on_plane_broadcast(data.document_name, data.update)

    async def on_destroy(self, data: Payload) -> None:
        self.replicas.close()
        if self._announce_handle is not None:
            self._announce_handle.cancel()
            self._announce_handle = None
        get_fleet_view().trace_returns.remove_waker(self._wake_trace_flush)
        self._announce(relay.CELL_DOWN)
        for session in list(self.sessions.values()):
            session.close(1001, "cell shutdown")
        # bounded: let the CELL_DOWN/CLOSED envelopes flush before the
        # lane closes (peers heal via re-route even if this races)
        flush_task = getattr(self.pub, "_flush_task", None)
        if flush_task is not None and not flush_task.done():
            try:
                await asyncio.wait_for(asyncio.shield(flush_task), timeout=0.5)
            except Exception:
                pass
        self.pub.close()
        self.sub.close()

    def health_status(self) -> dict:
        return {
            "state": "draining" if self.draining else "serving",
            "degraded": False,
            "cell_id": self.cell_id,
            "edge_sessions": len(self.sessions),
            "replica_owned": len(self.replicas.owned),
            "replica_following": len(self.replicas.following),
        }

    # -- relay dispatch ------------------------------------------------------

    def _on_message(self, channel: bytes, data: bytes) -> None:
        try:
            t0 = time.perf_counter_ns()
            kind, session_id, aux, payload = relay.decode_envelope(data)
        except Exception:
            return  # malformed envelope: nothing safe to act on
        ledger = get_cost_ledger()
        if ledger.enabled:
            ledger.record(
                "envelope_decode", "Relay", time.perf_counter_ns() - t0, len(data)
            )
        if kind == relay.PING:
            # clock-offset probe (cross-tier tracing): echo the edge's
            # stamp plus our own clock, immediately — any queueing here
            # inflates the RTT and widens the edge's offset bound
            try:
                t_sent = float(json.loads(aux).get("t"))
            except Exception:
                return
            self.publish_to_edge(
                session_id,  # the pinging edge's id rides the session field
                relay.encode_envelope(
                    relay.PONG,
                    self.cell_id,
                    json.dumps(
                        {"t": t_sent, "tc": time.perf_counter()},
                        separators=(",", ":"),
                    ),
                ),
            )
            return
        if kind == relay.DIGEST:
            # a peer's telemetry digest off the control channel
            view = get_fleet_view()
            if view.enabled and session_id != self.cell_id:
                try:
                    view.ingest(json.loads(payload))
                except Exception:
                    pass
            return
        if kind == relay.CELL_DOWN:
            self.roster.note(session_id, "down")
            if session_id != self.cell_id:
                get_fleet_view().mark_down(session_id)
                self.replicas.on_peer_down(session_id)
            return
        if kind in (relay.CELL_UP, relay.CELL_DRAINING):
            # fold the membership transition into the roster mirror
            # (heartbeat re-announces are no-ops; only real transitions
            # bump the epoch) — routing stays the edges' job
            self.roster.note(
                session_id,
                "healthy" if kind == relay.CELL_UP else "draining",
            )
            if kind == relay.CELL_DRAINING and session_id != self.cell_id:
                # a draining peer stops serving its follower role
                self.replicas.on_peer_down(session_id)
            return
        if kind in (
            relay.FOLLOW,
            relay.UNFOLLOW,
            relay.REPLICA_TICK,
            relay.REPLICA_PUSH,
        ):
            # hot-doc replication lane (edge/replica.py): the sender's
            # id — peer cell, or the edge for FOLLOW hints — rides the
            # session field
            self.replicas.dispatch(kind, session_id, aux, payload)
            return
        if kind == relay.OPEN:
            if self.draining:
                # stale route: the edge hasn't seen CELL_DRAINING yet —
                # answer CLOSED so it re-routes instead of waiting
                self.counters["refused_draining"] += 1
                self.publish_to_edge(
                    relay.decode_open_aux(aux).get("edge", ""),
                    relay.encode_envelope(
                        relay.CLOSED, session_id, "1012:draining"
                    ),
                )
                return
            if session_id in self.sessions:
                return  # duplicate OPEN (edge retry): session exists
            open_aux = relay.decode_open_aux(aux)
            edge_id = str(open_aux.get("edge", ""))
            if not edge_id:
                return
            self.counters["sessions_opened"] += 1
            self.sessions[session_id] = _CellEdgeSession(
                self, session_id, edge_id, open_aux
            )
            return
        session = self.sessions.get(session_id)
        if session is None:
            return  # frames for a session that never opened / already died
        if kind == relay.FRAME:
            self.counters["frames_in"] += 1
            # optional versioned trace-context aux (edge-sampled update):
            # absent/foreign aux decodes to None and the frame relays
            # exactly as before — old envelopes keep parsing
            trace_ctx = relay.decode_trace_aux(aux) if aux else None
            session.feed(payload, trace_ctx)
        elif kind == relay.DETACH:
            self.counters["detaches"] += 1
            session.detach(aux)
        elif kind == relay.CLOSE:
            self.counters["sessions_closed"] += 1
            session.close(1000, "edge closed")
