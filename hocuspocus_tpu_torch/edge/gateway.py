"""The stateless websocket edge tier: terminate sockets, route docs.

An edge terminates client websockets, speaks the wire protocol far
enough to AUTHENTICATE each document channel at the door (the full
on_connect/on_authenticate hook chain plus the overload plane's per-tenant
admission quotas and RED-rung refusal — floods die here, cells never
see them), and relays everything else verbatim to the doc's owning
merge cell over the relay lane (edge/relay.py). The edge holds NO
document state: CRDT sync is order-insensitive and state-based, so the
only per-channel memory is two cached frames —

- the client's **Auth frame** (replayed to a new cell so a handed-off
  session re-authenticates without the client's involvement), and
- the client's latest **SyncStep1 frame** (replayed to a new cell as
  the resync exchange: the cell answers SyncStep2 — a superset diff,
  idempotent — plus its own SyncStep1, which makes the client re-offer
  everything the handoff window might have dropped).

**Connection handoff.** When a cell announces drain (or dies), the
router remaps its docs and every affected channel rebinds: DETACH from
the old session where still reachable, OPEN/reuse a session on the new
cell, replay Auth + SyncStep1, flush the channel's relay buffer. The
client keeps its socket the whole time — the only client-visible
traffic is the resync exchange. Frames still arriving from the OLD
session (late broadcasts, the drain's 1012 close) are dropped by the
current-session check, so a handoff can never leak a stale close or a
duplicate Authenticated to the client.

**Bounded relay queue.** A channel whose cell is unreachable (or not
yet routed) buffers outbound frames in a bounded deque; overflow drops
the OLDEST frame with accounting (`hocuspocus_edge_relay_overflow_total`
plus the shared `hocuspocus_wire_send_queue_overflow_total` family) —
a slow or dead cell can never OOM an edge, and everything dropped is
re-offered by the rebind's resync exchange.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import time
import uuid
from collections import deque
from typing import Any, Optional

from ..aio import spawn_tracked
from ..net.resp import PipelinedRedisClient, RedisSubscriber
from ..observability.costs import get_cost_ledger
from ..observability.fleet import build_digest, get_fleet_view
from ..observability.flight_recorder import get_flight_recorder
from ..observability.metrics import Counter, Gauge
from ..observability.tracing import get_tracer
from ..observability.wire import get_wire_telemetry
from ..protocol.auth import AuthMessageType
from ..protocol.frames import parse_frame_header
from ..protocol.message import IncomingMessage, MessageType, OutgoingMessage
from ..protocol.sync import (
    MESSAGE_YJS_SYNC_STEP1,
    MESSAGE_YJS_SYNC_STEP2,
    MESSAGE_YJS_UPDATE,
)
from ..crdt.encoding import Decoder
from ..fleet.roster import AdmissionGate
from ..server import logger
from ..server.overload import RED, get_overload_controller, resolve_tenant
from ..server.types import ConnectionConfiguration, Payload
from . import relay
from .relay import DEFAULT_PREFIX
from .router import CellRouter

# frames a parked/re-establishing doc channel may buffer before the
# oldest is shed (accounted; healed by the rebind resync)
DEFAULT_RELAY_QUEUE_LIMIT = 1024

# audience watermark for hot-doc replication
# (docs/guides/hot-doc-replication.md): a doc whose local established
# channels reach the watermark grows one follower cell per further
# watermark's worth of audience (capped at healthy-1) and this edge
# spreads its channels across owner + followers. Below the watermark
# routing is byte-identical to the single-owner path.
DEFAULT_REPLICA_WATERMARK = 256


class RelaySession:
    """One (client socket, cell) lane multiplexing that client's doc
    channels routed to that cell."""

    __slots__ = ("gateway", "session_id", "cell_id", "owner", "docs", "closed")

    def __init__(self, gateway: "EdgeGateway", session_id: str, cell_id: str, owner) -> None:
        self.gateway = gateway
        self.session_id = session_id
        self.cell_id = cell_id
        self.owner = owner
        self.docs: "set[str]" = set()
        self.closed = False

    def send(self, frame: bytes, aux: str = "") -> None:
        if self.closed:
            return
        # zero-copy: the client frame rides as a memoryview segment
        # through the pipelined publish lane (joined once, straight
        # into the socket write) instead of being re-copied into a
        # fresh envelope buffer per publish
        self.gateway.publish_to_cell(
            self.cell_id,
            relay.encode_envelope_view(relay.FRAME, self.session_id, aux, frame),
        )
        self.gateway.counters["frames_to_cell"] += 1
        self.gateway.frames_total.inc(direction="to_cell")


class EdgeDocChannel:
    """Per-(socket, document) relay state. The whole point of the edge
    being stateless is how little lives here."""

    __slots__ = (
        "name",
        "tenant",
        "established",
        "authenticated_seen",
        "auth_frame",
        "step1_frame",
        "session",
        "buffer",
        "heal_handle",
    )

    def __init__(self, name: str, tenant: str) -> None:
        self.name = name
        # admission identity is PER CHANNEL (one socket can multiplex
        # docs whose auth hooks stamp different tenants — a per-socket
        # tenant would bill one tenant's flood to another's bucket)
        self.tenant = tenant
        self.established = False
        self.authenticated_seen = False
        self.auth_frame: Optional[bytes] = None
        self.step1_frame: Optional[bytes] = None
        self.session: Optional[RelaySession] = None
        self.buffer: "deque[bytes]" = deque()
        self.heal_handle: Optional[asyncio.TimerHandle] = None


class EdgeClientSession:
    """Per-socket session manager on the edge (the `ClientConnection`
    of the edge role): door auth, admission, relay, handoff."""

    def __init__(
        self,
        transport,
        request,
        hocuspocus,
        gateway: "EdgeGateway",
        context: Optional[dict] = None,
    ) -> None:
        self.transport = transport
        self.request = request
        self.hocuspocus = hocuspocus
        self.gateway = gateway
        self.default_context = dict(context or {})
        self.socket_id = str(uuid.uuid4())
        self.channels: "dict[str, EdgeDocChannel]" = {}
        self.cell_sessions: "dict[str, RelaySession]" = {}
        self.hook_payloads: "dict[str, Payload]" = {}
        self._auth_pending: "set[str]" = set()
        self.tenant = resolve_tenant(request=request, context=self.default_context)
        self._closed = False
        gateway.client_sessions.add(self)
        wire = get_wire_telemetry()
        if wire.enabled:
            wire.record_socket_opened()

    # -- inbound from the client -------------------------------------------

    async def handle_message(self, data: bytes) -> None:
        # edge ingress stamp (cross-tier tracing): taken at the frame
        # receive so a sampled update's trace opens where the monolith's
        # would — one attribute read when tracing is off
        t_receive = time.perf_counter() if get_tracer().enabled else None
        try:
            document_name, message_type, offset = parse_frame_header(data)
        except Exception as error:
            logger.log_error(f"[edge] invalid client frame: {error!r}")
            self.transport.close(4401, "Unauthorized")
            return
        channel = self.channels.get(document_name)
        if channel is not None and channel.established:
            overload = get_overload_controller()
            if overload.enabled and not overload.admit_message(channel.tenant):
                # edge-local ingress quota: the flood dies HERE — the
                # cell never sees the frame. Same rung-gated policy as
                # the monolith's Connection.handle_message: 1013 at
                # RED, below RED drop + one deferred resync heal
                if overload.rung >= RED:
                    self._close_channel(channel, 1013, "Try again later")
                    return
                self._schedule_quota_heal(channel)
                return
            self._relay_client_frame(
                channel, data, message_type, offset, t_receive=t_receive
            )
            return
        if channel is None:
            channel = self.channels[document_name] = EdgeDocChannel(
                document_name, self.tenant
            )
            self.hook_payloads[document_name] = Payload(
                instance=self.hocuspocus,
                request=self.request,
                connection_config=ConnectionConfiguration(
                    read_only=False, is_authenticated=False
                ),
                request_headers=self.request.headers,
                request_parameters=self.request.parameters,
                socket_id=self.socket_id,
                context={**self.default_context},
            )
        if (
            message_type == MessageType.Auth
            and document_name not in self._auth_pending
            and not channel.established
        ):
            self._auth_pending.add(document_name)
            await self._door_auth(channel, data, offset)
            return
        # pre-establishment traffic (the client's Step1/awareness land
        # right behind its Auth): buffer until the channel binds
        self._buffer_frame(channel, data)

    async def _door_auth(self, channel: EdgeDocChannel, data: bytes, offset: int) -> None:
        """The front door: full auth hook chain + tenant admission
        run ON THE EDGE; only authenticated, admitted channels ever
        touch a cell."""
        document_name = channel.name
        hook_payload = self.hook_payloads[document_name]
        wire = get_wire_telemetry()
        auth_started = time.perf_counter() if wire.enabled else None
        try:
            try:
                tmp = IncomingMessage(data)
                tmp.decoder.pos = offset
                tmp.read_var_uint()  # auth submessage type (always Token)
                token = tmp.read_var_string()
            except Exception as error:
                # malformed Auth frame: same terminal behavior as the
                # monolith's establishment path (ClientConnection) —
                # log + reset the socket, never tear the loop down
                logger.log_error(f"[edge] malformed auth frame: {error!r}")
                self.transport.close(4205, "Reset Connection")
                return

            def merge_context(context_additions: Any) -> None:
                if isinstance(context_additions, dict):
                    hook_payload.context = {
                        **hook_payload.context,
                        **context_additions,
                    }

            try:
                await self.hocuspocus.hooks(
                    "on_connect",
                    Payload(
                        **{**hook_payload.__dict__, "document_name": document_name}
                    ),
                    merge_context,
                )
                await self.hocuspocus.hooks(
                    "on_authenticate",
                    Payload(
                        **{
                            **hook_payload.__dict__,
                            "token": token,
                            "document_name": document_name,
                        }
                    ),
                    merge_context,
                )
                if auth_started is not None:
                    wire.record_auth(time.perf_counter() - auth_started, ok=True)
            except Exception as error:
                if auth_started is not None:
                    wire.record_auth(time.perf_counter() - auth_started, ok=False)
                reason = getattr(error, "reason", None) or getattr(
                    getattr(error, "event", None), "reason", None
                )
                self._send_to_client(
                    OutgoingMessage(document_name)
                    .write_permission_denied(reason or "permission-denied")
                    .to_bytes()
                )
                self._drop_channel(channel)
                return
            # admission AFTER the hook chain (a tenant stamped into the
            # context by an auth hook is honored; an invalid token never
            # drains a victim's bucket) — identical to the monolith's
            # auth-time admission in server/client_connection.py
            channel.tenant = resolve_tenant(
                request=self.request, context=hook_payload.context
            )
            overload = get_overload_controller()
            if overload.enabled:
                refusal = overload.admit_connect(channel.tenant)
                if refusal is not None:
                    self._send_to_client(
                        OutgoingMessage(document_name)
                        .write_permission_denied(
                            f"overloaded: {refusal}; "
                            f"retry-after={overload.retry_after_s:g}s"
                        )
                        .to_bytes()
                    )
                    self._drop_channel(channel)
                    return
            hook_payload.connection_config.is_authenticated = True
            channel.established = True
            channel.auth_frame = data
            self.gateway.counters["channels_opened"] += 1
            # audience first: this channel's own bind should already see
            # the watermark it just crossed
            self.gateway.note_channel_opened(channel.name)
            self._bind_channel(channel)
        finally:
            self._auth_pending.discard(document_name)

    def _relay_client_frame(
        self,
        channel: EdgeDocChannel,
        data: bytes,
        message_type: Optional[int] = None,
        offset: int = 0,
        t_receive: Optional[float] = None,
    ) -> None:
        """Relay one established-channel frame toward the owning cell,
        caching the client's latest SyncStep1 (the handoff resync
        replay) on the way through. Callers that already parsed the
        header pass (message_type, offset) — the per-frame hot path
        must not pay the parse twice; buffered frames re-parse here.

        With tracing on, a sampled update/SyncStep2 frame arriving
        straight off the socket (`t_receive` set — buffered replays
        have no honest receive stamp and are never traced) is stamped
        with a cross-tier trace context in the envelope aux: the cell
        adopts the id, and the broadcast frame coming back closes the
        edge→cell→edge chain (docs/guides/edge-routing.md)."""
        if message_type is None:
            try:
                _name, message_type, offset = parse_frame_header(data)
            except Exception:
                return
        sync_type = None
        if message_type == MessageType.Sync:
            try:
                decoder = Decoder(data)
                decoder.pos = offset
                sync_type = decoder.read_var_uint()
            except Exception:
                sync_type = None
            if sync_type == MESSAGE_YJS_SYNC_STEP1:
                channel.step1_frame = data
        if channel.session is None or channel.session.closed:
            self._buffer_frame(channel, data)
            return
        aux = ""
        if t_receive is not None and sync_type in (
            MESSAGE_YJS_SYNC_STEP2,
            MESSAGE_YJS_UPDATE,
        ):
            aux = self.gateway.stamp_trace(channel.name, t_receive)
        channel.session.send(data, aux)

    def _buffer_frame(self, channel: EdgeDocChannel, data: bytes) -> None:
        """The bounded per-channel relay queue: a parked or
        re-establishing channel buffers; overflow sheds the OLDEST frame
        with accounting (newest state wins — the rebind resync re-offers
        whatever was shed)."""
        limit = self.gateway.relay_queue_limit
        while limit and len(channel.buffer) >= limit:
            channel.buffer.popleft()
            self.gateway.counters["relay_overflows"] += 1
            self.gateway.relay_overflow_total.inc()
            get_wire_telemetry().record_queue_overflow()
        channel.buffer.append(data)

    # -- binding / handoff ---------------------------------------------------

    def _session_for(self, cell_id: str) -> RelaySession:
        session = self.cell_sessions.get(cell_id)
        if session is None or session.closed:
            session = self.gateway.open_session(self, cell_id)
            self.cell_sessions[cell_id] = session
        return session

    def _bind_channel(
        self, channel: EdgeDocChannel, reason: Optional[str] = None
    ) -> bool:
        """Bind (or re-bind) a channel to its routed cell: replay Auth,
        replay the resync SyncStep1 on handoff, flush the buffer.
        Returns False when no healthy cell exists (channel parks)."""
        handoff = reason is not None
        # audience-aware: below the replica watermark this IS
        # router.route(); above it the channel spreads across the doc's
        # owner + follower cells (docs/guides/hot-doc-replication.md)
        cell_id = self.gateway.route_channel(channel.name, self.socket_id)
        if cell_id is None:
            self.gateway.counters["parked_binds"] += 1
            return False
        session = self._session_for(cell_id)
        channel.session = session
        session.docs.add(channel.name)
        if channel.auth_frame is not None:
            session.send(channel.auth_frame)
        if handoff and channel.step1_frame is not None:
            # THE resync exchange: the new cell answers SyncStep2 (a
            # superset diff — idempotent) + its own SyncStep1, which
            # makes the client re-offer anything the handoff dropped
            session.send(channel.step1_frame)
        while channel.buffer:
            self._relay_client_frame(channel, channel.buffer.popleft())
        if handoff:
            self.gateway.counters["handoffs"] += 1
            self.gateway.handoffs_total.inc(reason=reason)
            get_flight_recorder().record(
                "__edge__",
                "handoff",
                doc=channel.name,
                to_cell=cell_id,
                reason=reason,
            )
        return True

    def rebind_docs(self, session: RelaySession, reason: str) -> None:
        """A relay session died (cell drain/death/session CLOSED):
        every doc bound to it re-establishes on its re-routed cell."""
        if self.cell_sessions.get(session.cell_id) is session:
            self.cell_sessions.pop(session.cell_id, None)
        for name in sorted(session.docs):
            session.docs.discard(name)
            channel = self.channels.get(name)
            if channel is None or channel.session is not session:
                continue
            channel.session = None
            self._bind_channel(channel, reason=reason)

    def rebind_parked(self) -> None:
        """A cell came up: parked channels (no routable cell at bind
        time) try again; the replayed Step1 heals anything buffered or
        shed while parked."""
        for channel in list(self.channels.values()):
            if channel.established and (
                channel.session is None or channel.session.closed
            ):
                channel.session = None
                self._bind_channel(channel, reason="recovered")

    def detach_doc(self, channel: EdgeDocChannel) -> None:
        """Remove one doc from its session, telling a still-reachable
        cell to close the server-side Connection."""
        session = channel.session
        channel.session = None
        if session is None or session.closed:
            return
        session.docs.discard(channel.name)
        state = self.gateway.router.state_of(session.cell_id)
        if state == "healthy":
            self.gateway.publish_to_cell(
                session.cell_id,
                relay.encode_envelope(relay.DETACH, session.session_id, channel.name),
            )

    # -- inbound from cells --------------------------------------------------

    def deliver_from_cell(self, session: RelaySession, payload: bytes) -> None:
        try:
            document_name, message_type, offset = parse_frame_header(payload)
        except Exception:
            return
        channel = self.channels.get(document_name)
        if channel is None or channel.session is not session:
            # stale-session traffic: a late broadcast or the old cell's
            # drain-time 1012 close for a doc that already handed off —
            # never client-visible
            self.gateway.counters["stale_drops"] += 1
            self.gateway.stale_frames_total.inc()
            return
        if message_type == MessageType.Auth:
            try:
                decoder = Decoder(payload)
                decoder.pos = offset
                subtype = decoder.read_var_uint()
            except Exception:
                subtype = None
            if subtype == AuthMessageType.Authenticated:
                if channel.authenticated_seen:
                    return  # handoff re-auth: the client already has one
                channel.authenticated_seen = True
            elif subtype == AuthMessageType.PermissionDenied:
                # terminal from the cell (e.g. cell-side admission):
                # forward, then forget the channel so a retry re-auths
                self._send_to_client(payload)
                self.detach_doc(channel)
                self._drop_channel(channel)
                return
        self._send_to_client(payload)

    def _send_to_client(self, data: bytes) -> None:
        if self.transport.is_closed:
            return
        try:
            self.transport.send(data)
        except Exception:
            return
        self.gateway.counters["frames_to_client"] += 1
        self.gateway.frames_total.inc(direction="to_client")
        wire = get_wire_telemetry()
        if wire.enabled:
            wire.record_egress_frame(data)

    # -- quota heal ----------------------------------------------------------

    def _schedule_quota_heal(self, channel: EdgeDocChannel) -> None:
        """A dropped over-quota frame must not diverge the doc forever:
        after the bucket's refill window, replay the client's Step1 to
        the cell — the cell's SyncStep2 + Step1 exchange re-offers
        everything the drops lost (state-based sync, idempotent)."""
        if channel.heal_handle is not None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return

        def heal() -> None:
            channel.heal_handle = None
            if (
                self._closed
                or not channel.established
                or channel.session is None
                or channel.session.closed
            ):
                return
            if channel.step1_frame is not None:
                channel.session.send(channel.step1_frame)

        channel.heal_handle = loop.call_later(1.0, heal)

    # -- teardown ------------------------------------------------------------

    def _close_channel(self, channel: EdgeDocChannel, code: int, reason: str) -> None:
        wire = get_wire_telemetry()
        if wire.enabled:
            wire.record_channel_close(code)
        self._send_to_client(
            OutgoingMessage(channel.name).write_close_message(reason).to_bytes()
        )
        self.detach_doc(channel)
        self._drop_channel(channel)

    def _drop_channel(self, channel: EdgeDocChannel) -> None:
        if channel.heal_handle is not None:
            channel.heal_handle.cancel()
            channel.heal_handle = None
        if channel.established and self.channels.get(channel.name) is channel:
            self.gateway.note_channel_closed(channel.name)
        self.channels.pop(channel.name, None)
        self.hook_payloads.pop(channel.name, None)
        session = channel.session
        if session is not None:
            session.docs.discard(channel.name)
        channel.session = None
        channel.buffer.clear()

    async def handle_transport_close(self, code: int, reason: str) -> None:
        if self._closed:
            return
        self._closed = True
        wire = get_wire_telemetry()
        if wire.enabled:
            wire.record_socket_closed(code)
            wire.untrack_transport(self.transport)
        for channel in list(self.channels.values()):
            if channel.heal_handle is not None:
                channel.heal_handle.cancel()
                channel.heal_handle = None
            if channel.established:
                self.gateway.note_channel_closed(channel.name)
            channel.buffer.clear()
        for session in list(self.cell_sessions.values()):
            self.gateway.close_session(session)
        self.cell_sessions.clear()
        self.channels.clear()
        self.hook_payloads.clear()
        self.gateway.client_sessions.discard(self)


class EdgeGateway:
    """One edge process's relay fabric: the router, the RESP lane, the
    session registry and the edge metric surface."""

    def __init__(
        self,
        edge_id: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 6379,
        prefix: str = DEFAULT_PREFIX,
        router: Optional[CellRouter] = None,
        create_client: Optional[Any] = None,
        create_subscriber: Optional[Any] = None,
        relay_queue_limit: int = DEFAULT_RELAY_QUEUE_LIMIT,
        heartbeat_timeout_s: Optional[float] = None,
        heartbeat_sweep_s: Optional[float] = None,
        digest_interval_s: float = 2.0,
        replica_watermark: int = DEFAULT_REPLICA_WATERMARK,
        host_id: Optional[str] = None,
        admission: Optional[AdmissionGate] = None,
    ) -> None:
        self.edge_id = edge_id or f"edge-{uuid.uuid4().hex[:8]}"
        self.prefix = prefix
        # cross-host admission (fleet/roster.py): cells announcing with
        # a foreign host qualifier stay PENDING — probed, not routable —
        # until their clock offset resolves; local cells admit as before
        self.host_id = host_id
        self.admission = admission or AdmissionGate(local_host=host_id)
        if router is None:
            router = (
                CellRouter()
                if heartbeat_timeout_s is None
                else CellRouter(heartbeat_timeout_s=heartbeat_timeout_s)
            )
        self.router = router
        # heartbeat-expiry sweep: the timer that actually DRIVES
        # `CellRouter.expire_stale` — a cell that dies without a
        # CELL_DOWN (kill -9, network partition) flips to dead when its
        # CELL_UP heartbeats go quiet past the router timeout, and its
        # docs hand off exactly like an announced death. Half the
        # timeout by default: a cell expires at most 1.5x the timeout
        # after its last heartbeat.
        self.heartbeat_sweep_s = (
            heartbeat_sweep_s
            if heartbeat_sweep_s is not None
            else max(self.router.heartbeat_timeout_s / 2.0, 0.05)
        )
        self._sweep_handle: "Optional[asyncio.TimerHandle]" = None
        # telemetry federation + clock-offset probes: one digest on the
        # control channel (and one PING per healthy cell) per interval
        self.digest_interval_s = digest_interval_s
        self._digest_handle: "Optional[asyncio.TimerHandle]" = None
        self._trace_seq = 0
        self.relay_queue_limit = relay_queue_limit
        self.sessions: "dict[str, RelaySession]" = {}
        self.client_sessions: "set[EdgeClientSession]" = set()
        self._session_seq = 0
        self._tasks: set = set()
        self._started = False
        self.counters = {
            "frames_to_cell": 0,
            "frames_to_client": 0,
            "channels_opened": 0,
            "handoffs": 0,
            "stale_drops": 0,
            "relay_overflows": 0,
            "parked_binds": 0,
            "remaps": 0,
            "heartbeat_expiries": 0,
            "traces_stamped": 0,
            "traces_closed": 0,
            "digests_published": 0,
            "follow_hints": 0,
            "promotions": 0,
            "admissions_pending": 0,
            "admissions_foreign": 0,
        }
        # -- hot-doc replication (docs/guides/hot-doc-replication.md) ---
        # audience watermark (0 disables): per-doc ESTABLISHED channel
        # counts on this edge drive the follower count
        self.replica_watermark = replica_watermark
        self._doc_audience: "dict[str, int]" = {}
        # doc -> {"owner": cell, "followers": [cells], "hinted":
        #         {(cell, owner), ...}} — the replication topology this
        #         edge has grown (hints are idempotent per (cell, owner))
        self._replica_routes: "dict[str, dict]" = {}
        # doc -> cell -> last digest-reported tick seq: the freshness
        # signal behind promote-the-freshest-follower
        self._replica_seqs: "dict[str, dict[str, int]]" = {}
        if create_client is not None:
            self.pub = create_client()
        else:
            self.pub = PipelinedRedisClient(host, port)
        if create_subscriber is not None:
            self.sub = create_subscriber(self._on_message)
        else:
            self.sub = RedisSubscriber(host, port, on_message=self._on_message)
        # -- exposition (hocuspocus_edge_*; adopted by Metrics) ---------
        self.sessions_gauge = Gauge(
            "hocuspocus_edge_relay_sessions",
            "Live edge→cell relay sessions",
            fn=lambda: len(self.sessions),
        )
        self.cells_gauge = Gauge(
            "hocuspocus_edge_cells_healthy",
            "Merge cells the router considers healthy",
            fn=lambda: len(self.router.healthy_cells()),
        )
        self.channels_gauge = Gauge(
            "hocuspocus_edge_doc_channels",
            "Established per-document relay channels",
            fn=self._count_channels,
        )
        self.parked_gauge = Gauge(
            "hocuspocus_edge_parked_channels",
            "Established channels with no routable cell (buffering)",
            fn=self._count_parked,
        )
        self.relay_queue_gauge = Gauge(
            "hocuspocus_edge_relay_queue_depth",
            "Frames buffered across parked/re-establishing channels",
            fn=self._relay_queue_depth,
        )
        self.frames_total = Counter(
            "hocuspocus_edge_relay_frames_total",
            "Frames relayed through this edge, by direction",
        )
        self.handoffs_total = Counter(
            "hocuspocus_edge_handoffs_total",
            "Doc channels handed off between cells, by reason",
        )
        self.stale_frames_total = Counter(
            "hocuspocus_edge_stale_frames_total",
            "Frames from superseded sessions dropped by the edge",
        )
        self.relay_overflow_total = Counter(
            "hocuspocus_edge_relay_overflow_total",
            "Frames shed from bounded per-channel relay queues",
        )
        self.route_epoch_gauge = Gauge(
            "hocuspocus_edge_route_epoch",
            "Router epoch (bumps on every membership/override change)",
            fn=lambda: self.router.epoch,
        )
        self.replicated_docs_gauge = Gauge(
            "hocuspocus_replica_docs",
            "Docs this edge routes with an owner + follower set",
            fn=lambda: float(len(self._replica_routes)),
        )
        self.follow_hints_total = Counter(
            "hocuspocus_replica_follow_hints_total",
            "FOLLOW routing hints sent to follower cells",
        )
        self.edge_promotions_total = Counter(
            "hocuspocus_replica_edge_promotions_total",
            "Owner promotions driven by this edge, by reason",
        )

    def metrics(self) -> tuple:
        """Metric objects for MetricsRegistry.register adoption."""
        return (
            self.sessions_gauge,
            self.cells_gauge,
            self.channels_gauge,
            self.parked_gauge,
            self.relay_queue_gauge,
            self.frames_total,
            self.handoffs_total,
            self.stale_frames_total,
            self.relay_overflow_total,
            self.route_epoch_gauge,
            self.replicated_docs_gauge,
            self.follow_hints_total,
            self.edge_promotions_total,
        )

    def _count_channels(self) -> int:
        return sum(len(s.channels) for s in self.client_sessions)

    def _count_parked(self) -> int:
        return sum(
            1
            for s in self.client_sessions
            for c in s.channels.values()
            if c.established and (c.session is None or c.session.closed)
        )

    def _relay_queue_depth(self) -> int:
        return sum(
            len(c.buffer)
            for s in self.client_sessions
            for c in s.channels.values()
        )

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        # fleet identity: debug payload headers + cross-tier span lanes
        get_fleet_view().set_identity("edge", self.edge_id)
        await self.sub.subscribe(relay.edge_channel(self.prefix, self.edge_id))
        await self.sub.subscribe(relay.control_channel(self.prefix))
        get_flight_recorder().record("__edge__", "edge_up", edge=self.edge_id)
        self._schedule_heartbeat_sweep()
        self._digest_tick()

    def _schedule_heartbeat_sweep(self) -> None:
        if self.heartbeat_sweep_s <= 0 or self._sweep_handle is not None:
            return
        try:
            loop = asyncio.get_event_loop()
        except RuntimeError:
            return
        self._sweep_handle = loop.call_later(
            self.heartbeat_sweep_s, self._heartbeat_sweep
        )

    def _heartbeat_sweep(self) -> None:
        """Expiry-driven handoff: cells whose heartbeats went quiet past
        the router timeout flip to dead and their docs remap — the same
        transparent Auth+Step1-replay rebind an announced CELL_DOWN
        takes, so a kill -9'd cell strands its sessions for at most one
        timeout + sweep interval."""
        self._sweep_handle = None
        try:
            # pending (never-admitted) cells that stopped announcing
            # age out on the same liveness contract as routable ones
            for cell_id in self.admission.expire(
                self.router.heartbeat_timeout_s
            ):
                get_flight_recorder().record(
                    "__autoscale__",
                    "cell_pending_expired",
                    cell=cell_id,
                    edge=self.edge_id,
                )
            # per-cell isolation: expire_stale reports each dead cell
            # exactly ONCE, so a handoff failure for cell A must not
            # strand cell B's sessions for good
            for cell_id in self.router.expire_stale():
                self.counters["heartbeat_expiries"] += 1
                get_flight_recorder().record(
                    "__edge__",
                    "cell_expired",
                    cell=cell_id,
                    edge=self.edge_id,
                    timeout_s=self.router.heartbeat_timeout_s,
                )
                try:
                    self._handoff_cell(cell_id, "expired")
                except Exception as error:
                    logger.log_error(
                        f"[edge] expiry handoff for {cell_id!r} failed "
                        f"({error!r}); sessions heal on the next rebind"
                    )
        finally:
            if self._started:
                self._schedule_heartbeat_sweep()

    def _digest_tick(self) -> None:
        """Per-interval federation work: publish this edge's telemetry
        digest on the control channel (+ ingest locally), and PING every
        healthy cell so the clock-offset estimates stay fresh for the
        relay spans. Gated on the fleet view (lit by Metrics) for the
        digests; pings ride only while tracing is on — both are no-ops
        on an unobserved edge."""
        self._digest_handle = None
        view = get_fleet_view()
        try:
            if view.enabled:
                digest = build_digest(
                    role="edge",
                    node_id=self.edge_id,
                    interval_s=self.digest_interval_s,
                    extra={
                        "sessions": len(self.client_sessions),
                        "placement_epoch": self.router.epoch,
                        "edge": {
                            "cells_healthy": len(self.router.healthy_cells()),
                            "doc_channels": self._count_channels(),
                            "parked_channels": self._count_parked(),
                            "relay_queue_depth": self._relay_queue_depth(),
                            "relay_sessions": len(self.sessions),
                            "replicated_docs": len(self._replica_routes),
                        },
                    },
                )
                view.ingest(digest)
                self.publish_control(
                    relay.encode_envelope(
                        relay.DIGEST,
                        self.edge_id,
                        "",
                        json.dumps(digest, separators=(",", ":")).encode(),
                    )
                )
                self.counters["digests_published"] += 1
            if get_tracer().enabled:
                ping_aux = json.dumps(
                    {"t": time.perf_counter()}, separators=(",", ":")
                )
                for cell_id in self.router.healthy_cells():
                    self.publish_to_cell(
                        cell_id,
                        relay.encode_envelope(relay.PING, self.edge_id, ping_aux),
                    )
            # pending (cross-host) cells are ALWAYS probed: their
            # admission is waiting on exactly these samples
            for cell_id in list(self.admission.pending):
                self._ping_cell(cell_id)
        finally:
            if self._started and self.digest_interval_s > 0:
                try:
                    loop = asyncio.get_event_loop()
                except RuntimeError:
                    return
                self._digest_handle = loop.call_later(
                    self.digest_interval_s, self._digest_tick
                )

    def stamp_trace(self, doc_name: str, t_receive: float) -> str:
        """Sample one inbound update for cross-tier tracing: returns the
        encoded trace-context aux (or "" when not sampled). The context
        carries everything the return path needs — the edge holds no
        per-trace state, in keeping with its statelessness."""
        tracer = get_tracer()
        if not tracer.enabled or not tracer.take_sample():
            return ""
        self._trace_seq += 1
        self.counters["traces_stamped"] += 1
        return relay.encode_trace_aux(
            {
                "id": f"{self.edge_id}:{self._trace_seq}",
                "e": self.edge_id,
                "d": doc_name,
                "t0": t_receive,
                "t1": time.perf_counter(),
                "h": 1,
            }
        )

    def _finish_cross_tier(
        self, returns: list, t9a: float, t9b: float
    ) -> None:
        """Close cross-tier traces from a cell's TRACE_RET contexts:
        emit the four edge-side spans and feed the fleet e2e histogram.

        The chain closes on the SAME edge that stamped it, so `t0`/`t1`
        (echoed back verbatim) and `t9a`/`t9b` share this edge's clock
        and the end-to-end latency is a single-clock difference —
        exact. Only the interior boundary needs reconciliation: the two
        relay spans partition the edge-observed gap
        `(t9a - t1) - interior`, split at the offset-corrected
        cell-receive stamp (heartbeat-RTT estimate). Any one-way skew
        folds into the relay spans — the split clamps to [0, gap], so
        no span ever goes negative and the spans still sum exactly to
        the edge-to-edge e2e."""
        tracer = get_tracer()
        view = get_fleet_view()
        for ctx in returns:
            try:
                trace_id = ctx["id"]
                t0 = float(ctx["t0"])
                t1 = float(ctx["t1"])
                t_cell_recv = float(ctx["tr"])
                t_cell_close = float(ctx["ts"])
            except (KeyError, TypeError, ValueError):
                continue
            node = str(ctx.get("n", "cell"))
            doc = ctx.get("d")
            hop = int(ctx.get("h", 2))
            estimator = view.offsets.get(node)
            offset = 0.0 if estimator is None else estimator.offset_s
            interior = max(t_cell_close - t_cell_recv, 0.0)
            gap = max((t9a - t1) - interior, 0.0)
            relay_out = min(max((t_cell_recv - offset) - t1, 0.0), gap)
            relay_return = gap - relay_out
            edge_ingress = max(t1 - t0, 0.0)
            edge_egress = max(t9b - t9a, 0.0)
            e2e = edge_ingress + gap + interior + edge_egress
            e2e_ms = round(e2e * 1000.0, 3)
            if tracer.enabled:
                tracer.add_span(
                    "update.edge_ingress", t0, t1,
                    trace_id=trace_id, doc=doc, node=self.edge_id, hop=hop,
                )
                tracer.add_span(
                    "update.relay_out", t1, t1 + relay_out,
                    trace_id=trace_id, doc=doc, node=self.edge_id,
                    clock_offset_ms=round(offset * 1000.0, 3),
                )
                tracer.add_span(
                    "update.relay_return", t9a - relay_return, t9a,
                    trace_id=trace_id, doc=doc, node=self.edge_id,
                )
                tracer.add_span(
                    "update.edge_egress", t9a, t9b,
                    trace_id=trace_id, doc=doc, node=self.edge_id,
                    e2e_ms=e2e_ms,
                )
            view.record_cross_tier("edge_ingress", edge_ingress)
            view.record_cross_tier("relay_out", relay_out)
            view.record_cross_tier("relay_return", relay_return)
            view.record_cross_tier("edge_egress", edge_egress)
            view.record_cross_tier("total", e2e)
            self.counters["traces_closed"] += 1

    def close(self) -> None:
        self._started = False
        if self._sweep_handle is not None:
            self._sweep_handle.cancel()
            self._sweep_handle = None
        if self._digest_handle is not None:
            self._digest_handle.cancel()
            self._digest_handle = None
        for session in list(self.sessions.values()):
            session.closed = True
        self.sessions.clear()
        self.pub.close()
        self.sub.close()

    # -- relay plumbing ------------------------------------------------------

    def publish_to_cell(self, cell_id: str, envelope) -> None:
        """Publish one envelope (bytes, or a zero-copy segment list from
        `relay.encode_envelope_view`)."""
        nowait = getattr(self.pub, "publish_nowait", None)
        if nowait is not None:
            nowait(relay.cell_channel(self.prefix, cell_id), envelope)
        else:
            if isinstance(envelope, (list, tuple)):
                envelope = b"".join(envelope)
            spawn_tracked(
                self._tasks,
                self.pub.publish(relay.cell_channel(self.prefix, cell_id), envelope),
            )

    def publish_control(self, envelope: bytes) -> None:
        channel = relay.control_channel(self.prefix)
        nowait = getattr(self.pub, "publish_nowait", None)
        if nowait is not None:
            nowait(channel, envelope)
        else:
            spawn_tracked(self._tasks, self.pub.publish(channel, envelope))

    # -- hot-doc replication -------------------------------------------------

    def note_channel_opened(self, doc_name: str) -> None:
        self._doc_audience[doc_name] = self._doc_audience.get(doc_name, 0) + 1

    def note_channel_closed(self, doc_name: str) -> None:
        count = self._doc_audience.get(doc_name, 0) - 1
        if count > 0:
            self._doc_audience[doc_name] = count
        else:
            self._doc_audience.pop(doc_name, None)

    def replica_route_set(self, doc_name: str) -> "list[str]":
        """Audience-aware placement: [owner] below the watermark, else
        [owner, follower...] with one follower per watermark's worth of
        local audience (capped at healthy-1). Growing the set sends the
        FOLLOW hints that stand the followers up; the set only shrinks
        through cell churn — an audience dip must not thrash follower
        bootstrap."""
        watermark = self.replica_watermark
        if watermark <= 0:
            owner = self.router.route(doc_name)
            return [] if owner is None else [owner]
        audience = self._doc_audience.get(doc_name, 0)
        wanted = audience // watermark
        entry = self._replica_routes.get(doc_name)
        if entry is not None:
            wanted = max(wanted, len(entry["followers"]))
        wanted = min(wanted, max(len(self.router.healthy_cells()) - 1, 0))
        route_set = self.router.route_set(doc_name, wanted)
        if len(route_set) > 1:
            self._ensure_hints(doc_name, route_set)
        return route_set

    def route_channel(self, doc_name: str, socket_id: str) -> "Optional[str]":
        """The serving cell for one (doc, socket) channel: the owner
        below the watermark; above it, a stable spread across owner +
        followers so the read storm lands proportionally on every
        replica while a given socket always rebinds to the same slot
        (its SyncStep1 replay heals the one-slot move on churn)."""
        route_set = self.replica_route_set(doc_name)
        if not route_set:
            return None
        if len(route_set) == 1:
            return route_set[0]
        digest = hashlib.blake2b(
            f"{doc_name}\x00{socket_id}".encode(), digest_size=4
        ).digest()
        return route_set[int.from_bytes(digest, "big") % len(route_set)]

    def _ensure_hints(self, doc_name: str, route_set: "list[str]") -> None:
        owner = route_set[0]
        entry = self._replica_routes.get(doc_name)
        if entry is None:
            entry = self._replica_routes[doc_name] = {
                "owner": owner,
                "followers": [],
                "hinted": set(),
            }
        entry["owner"] = owner
        entry["followers"] = [c for c in route_set[1:]]
        for follower in route_set[1:]:
            self._send_follow_hint(entry, follower, doc_name, owner)

    def _send_follow_hint(
        self, entry: dict, target: str, doc_name: str, owner: str
    ) -> None:
        """Idempotent per (target, owner): the target cell learns the
        doc's owner — follower cells subscribe, the owner itself (on
        promotion) flips role."""
        key = (target, owner)
        if key in entry["hinted"]:
            return
        entry["hinted"].add(key)
        self.publish_to_cell(
            target,
            relay.encode_envelope(
                relay.FOLLOW,
                self.edge_id,
                relay.encode_replica_aux(d=doc_name, o=owner),
            ),
        )
        self.counters["follow_hints"] += 1
        self.follow_hints_total.inc()
        get_flight_recorder().record(
            "__replica__",
            "follow" if target != owner else "promoted",
            doc=doc_name,
            cell=target,
            owner=owner,
            edge=self.edge_id,
        )

    def _harvest_replica_digest(self, node_id: str, digest: dict) -> None:
        """Cell digests carry per-doc tick seqs; the freshest-follower
        pick at promotion time reads them here. Harvested from every
        cell digest — including our own echo — so the signal survives
        digest dedup policy."""
        replica = digest.get("replica")
        if not isinstance(replica, dict):
            return
        for section in ("owned", "following"):
            docs = replica.get(section)
            if not isinstance(docs, dict):
                continue
            for doc_name, info in docs.items():
                seq = info.get("seq") if isinstance(info, dict) else None
                if isinstance(seq, int):
                    self._replica_seqs.setdefault(doc_name, {})[node_id] = seq

    def _promote_replicas(self, cell_id: str, reason: str) -> None:
        """The departed cell leaves every replica topology it was part
        of. Followers just drop out; a departed OWNER promotes the
        freshest surviving follower (highest digest-carried tick seq,
        HRW-order tie-break), clears the doc's stale router entries
        (`CellRouter.promote`), and re-hints every survivor so the
        promoted cell flips role and the rest re-subscribe to it."""
        for doc_name, entry in list(self._replica_routes.items()):
            if entry["owner"] != cell_id:
                if cell_id in entry["followers"]:
                    entry["followers"] = [
                        f for f in entry["followers"] if f != cell_id
                    ]
                continue
            survivors = [
                f
                for f in entry["followers"]
                if self.router.state_of(f) == "healthy"
            ]
            if not survivors:
                # no replica to promote: drop the entry — the ordinary
                # re-route + Auth/Step1 resync takes over
                self._replica_routes.pop(doc_name, None)
                continue
            seqs = self._replica_seqs.get(doc_name, {})
            new_owner = max(
                survivors,
                key=lambda c: (seqs.get(c, -1), -survivors.index(c)),
            )
            self.router.promote(doc_name, new_owner)
            entry["owner"] = new_owner
            entry["followers"] = [f for f in survivors if f != new_owner]
            self.counters["promotions"] += 1
            self.edge_promotions_total.inc(reason=reason)
            get_flight_recorder().record(
                "__replica__",
                "promoted",
                doc=doc_name,
                old_owner=cell_id,
                new_owner=new_owner,
                reason=reason,
                edge=self.edge_id,
            )
            self._send_follow_hint(entry, new_owner, doc_name, new_owner)
            for follower in entry["followers"]:
                self._send_follow_hint(entry, follower, doc_name, new_owner)

    def open_session(self, owner: EdgeClientSession, cell_id: str) -> RelaySession:
        self._session_seq += 1
        session_id = f"{self.edge_id}:{owner.socket_id[:8]}:{self._session_seq}"
        session = RelaySession(self, session_id, cell_id, owner)
        self.sessions[session_id] = session
        self.publish_to_cell(
            cell_id,
            relay.encode_envelope(
                relay.OPEN,
                session_id,
                relay.encode_open_aux(self.edge_id, tenant=owner.tenant),
            ),
        )
        return session

    def close_session(self, session: RelaySession) -> None:
        if not session.closed:
            session.closed = True
            self.publish_to_cell(
                session.cell_id,
                relay.encode_envelope(relay.CLOSE, session.session_id),
            )
        self.sessions.pop(session.session_id, None)
        session.docs.clear()

    # -- inbound dispatch ----------------------------------------------------

    def _consider_cell(self, cell_id: str) -> None:
        """CELL_UP admission (fleet/roster.py): local cells join the
        router immediately; a FOREIGN cell holds in the pending table —
        announced, clock-probed, but not routable — until its per-peer
        ClockOffsetEstimator resolves. Every membership change still
        rides `router.add_cell`'s epoch bump, so in-flight routes heal
        through the usual stale-route/Step1-resync machinery."""
        admit, reason = self.admission.evaluate(
            cell_id, get_fleet_view().offsets.get(cell_id)
        )
        if not admit:
            if self.admission.hold(cell_id, reason):
                self.counters["admissions_pending"] += 1
                get_flight_recorder().record(
                    "__autoscale__",
                    "cell_pending",
                    cell=cell_id,
                    edge=self.edge_id,
                    reason=reason,
                )
            # probe the pending peer's clock NOW: admission is what
            # needs the offset resolved, never gated on the tracer
            self._ping_cell(cell_id)
            return
        if self.admission.admit(cell_id):
            self.counters["admissions_foreign"] += 1
            get_flight_recorder().record(
                "__autoscale__",
                "cell_admitted",
                cell=cell_id,
                edge=self.edge_id,
                reason=reason,
            )
        if self.router.add_cell(cell_id):
            if reason == "local":
                self.admission.note_local(True)
            get_flight_recorder().record(
                "__edge__", "cell_up", cell=cell_id, edge=self.edge_id
            )
            self._rebind_parked()

    def _ping_cell(self, cell_id: str) -> None:
        self.publish_to_cell(
            cell_id,
            relay.encode_envelope(
                relay.PING,
                self.edge_id,
                json.dumps({"t": time.perf_counter()}, separators=(",", ":")),
            ),
        )

    def _on_message(self, channel: bytes, data: bytes) -> None:
        try:
            t0 = time.perf_counter_ns()
            kind, session_id, aux, payload = relay.decode_envelope(data)
        except Exception:
            return
        ledger = get_cost_ledger()
        if ledger.enabled:
            ledger.record(
                "envelope_decode", "Relay", time.perf_counter_ns() - t0, len(data)
            )
        if kind == relay.CELL_UP:
            self._consider_cell(session_id)
            return
        if kind == relay.CELL_DRAINING:
            if self.router.mark_draining(session_id):
                get_flight_recorder().record(
                    "__edge__", "cell_draining", cell=session_id, edge=self.edge_id
                )
                self._handoff_cell(session_id, "drain")
            return
        if kind == relay.CELL_DOWN:
            get_fleet_view().mark_down(session_id)
            self.admission.pending.pop(session_id, None)
            if self.router.mark_dead(session_id):
                get_flight_recorder().record(
                    "__edge__", "cell_down", cell=session_id, edge=self.edge_id
                )
                self._handoff_cell(session_id, "down")
            return
        if kind == relay.DIGEST:
            # a peer's telemetry digest off the control channel (other
            # edges and every cell publish). Our own publish echoes back
            # here too — skip it: _digest_tick already ingested locally,
            # and double-ingest would halve the self-peer's ring window
            # and inflate the digest counters
            try:
                digest = json.loads(payload)
            except Exception:
                return
            if isinstance(digest, dict):
                # replica tick seqs ride cell digests: harvest before
                # the self-echo skip so freshness survives dedup
                self._harvest_replica_digest(session_id, digest)
                view = get_fleet_view()
                if view.enabled and session_id != self.edge_id:
                    try:
                        view.ingest(digest)
                    except Exception:
                        pass
            return
        if kind == relay.PONG:
            # clock-offset probe reply: session field = the cell's id,
            # aux echoes our PING stamp plus the cell's own clock
            try:
                reply = json.loads(aux)
                get_fleet_view().offset_for(session_id).observe(
                    float(reply["t"]), float(reply["tc"]), time.perf_counter()
                )
            except Exception:
                pass
            if session_id in self.admission.pending:
                # a pending cell's probe landed: re-evaluate admission
                # now instead of waiting out its next CELL_UP heartbeat
                self._consider_cell(session_id)
            return
        if kind == relay.TRACE_RET:
            # cross-tier trace returns (session field = the cell's id):
            # processed at the gateway, independent of any relay session
            # — a handoff racing the close can't lose the trace
            t9a = time.perf_counter()
            trace_ctx = relay.decode_trace_aux(aux)
            returns = None if trace_ctx is None else trace_ctx.get("r")
            if returns:
                self._finish_cross_tier(returns, t9a, time.perf_counter())
            return
        session = self.sessions.get(session_id)
        if session is None:
            return
        if kind == relay.FRAME:
            session.owner.deliver_from_cell(session, payload)
        elif kind == relay.CLOSED:
            # the cell closed this session (drain 1012, overflow,
            # shutdown): remap its docs. A drain-coded close also
            # downgrades the cell so new routes avoid it even when the
            # control announcement was lost.
            self.sessions.pop(session_id, None)
            session.closed = True
            if aux.startswith("1012") and self.router.mark_draining(session.cell_id):
                self._handoff_cell(session.cell_id, "drain")
            session.owner.rebind_docs(session, "closed")

    def _handoff_cell(self, cell_id: str, reason: str) -> None:
        """Remap every doc bound to `cell_id` — transparent handoff: the
        clients keep their sockets; each channel replays Auth+Step1 on
        its new cell."""
        self.counters["remaps"] += 1
        # promotions FIRST: the rebinds below must route through the
        # promoted owner's fresh placement, not the dead cell's
        self._promote_replicas(cell_id, reason)
        affected = [
            session
            for session in self.sessions.values()
            if session.cell_id == cell_id
        ]
        for session in affected:
            self.sessions.pop(session.session_id, None)
            session.closed = True
            session.owner.rebind_docs(session, reason)

    def _rebind_parked(self) -> None:
        for client in list(self.client_sessions):
            client.rebind_parked()

    # -- observability -------------------------------------------------------

    def status(self) -> dict:
        """The `/debug/edge` payload: routing table + live sessions +
        per-doc bindings + counters."""
        bindings = {}
        for client in self.client_sessions:
            for name, channel in client.channels.items():
                bindings[name] = {
                    "cell": channel.session.cell_id
                    if channel.session is not None and not channel.session.closed
                    else None,
                    "established": channel.established,
                    "buffered": len(channel.buffer),
                }
        view = get_fleet_view()
        return {
            "edge_id": self.edge_id,
            "host_id": self.host_id,
            "admission": self.admission.status(),
            "router": self.router.table(),
            "sessions": {
                session_id: {"cell": session.cell_id, "docs": sorted(session.docs)}
                for session_id, session in sorted(self.sessions.items())
            },
            "channels": dict(sorted(bindings.items())),
            "client_sockets": len(self.client_sessions),
            "counters": dict(self.counters),
            "replica": {
                "watermark": self.replica_watermark,
                "docs": {
                    doc: {
                        "owner": entry["owner"],
                        "followers": list(entry["followers"]),
                        "audience": self._doc_audience.get(doc, 0),
                        "seqs": dict(
                            sorted(self._replica_seqs.get(doc, {}).items())
                        ),
                    }
                    for doc, entry in sorted(self._replica_routes.items())
                },
            },
            "clock_offsets": {
                peer: {
                    "offset_ms": round(est.offset_s * 1000.0, 3),
                    "rtt_ms": None
                    if est.rtt_s is None
                    else round(est.rtt_s * 1000.0, 3),
                    "samples": est.samples,
                }
                for peer, est in sorted(view.offsets.items())
            },
        }

    def health_brief(self) -> dict:
        healthy = len(self.router.healthy_cells())
        return {
            "state": "routing" if healthy else "no_cells",
            "degraded": self._started and healthy == 0,
            "cells_healthy": healthy,
            "relay_sessions": len(self.sessions),
            "parked_channels": self._count_parked(),
        }
