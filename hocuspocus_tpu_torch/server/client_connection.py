"""Per-socket session manager (reference `ClientConnection.ts` equivalent).

One websocket can multiplex many documents. Messages for a document are
queued until its Auth message arrives and the onConnect/onAuthenticate
hook chain passes; then a `Connection` is created and the queue replayed.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, Callable, Optional

from ..observability.wire import get_wire_telemetry
from ..protocol.close_events import (
    CloseEvent,
    FORBIDDEN,
    RESET_CONNECTION,
    UNAUTHORIZED,
)
from ..protocol.frames import parse_frame_header
from ..protocol.message import IncomingMessage, MessageType, OutgoingMessage
from . import logger
from .connection import Connection
from .document import Document
from .overload import get_overload_controller, resolve_tenant
from .types import ConnectionConfiguration, Payload


class ClientConnection:
    def __init__(
        self,
        transport,
        request,
        document_provider,
        hooks: Callable,
        timeout: int,
        default_context: Optional[dict] = None,
    ) -> None:
        self.transport = transport
        self.request = request
        self.document_provider = document_provider
        self.hooks = hooks
        self.timeout = timeout
        self.default_context = default_context or {}
        self.socket_id = str(uuid.uuid4())
        self.document_connections: dict[str, Connection] = {}
        self.incoming_message_queue: dict[str, list[bytes]] = {}
        self.document_connections_established: set[str] = set()
        self.hook_payloads: dict[str, Payload] = {}
        self.callbacks: dict[str, list] = {"on_close": []}
        self._closed = False
        wire = get_wire_telemetry()
        if wire.enabled:
            wire.record_socket_opened()

    def on_close(self, callback: Callable) -> "ClientConnection":
        self.callbacks["on_close"].append(callback)
        return self

    def close(self, event: Optional[CloseEvent] = None) -> None:
        for connection in list(self.document_connections.values()):
            connection.close(event)

    async def handle_transport_close(self, code: int, reason: str) -> None:
        if self._closed:
            return
        self._closed = True
        wire = get_wire_telemetry()
        if wire.enabled:
            # socket-level churn by close code: 1000/1001 are normal
            # departures, everything else is the abnormal-close signal
            # the SLO error-rate objective watches
            wire.record_socket_closed(code)
            wire.untrack_transport(self.transport)
        self.close(CloseEvent(code, reason))
        # a socket that died mid-handshake leaves queued frame BYTES for
        # channels that never established; drop them eagerly instead of
        # pinning them until this session is GC'd. hook_payloads stays:
        # an in-flight auth handshake re-reads its payload after the
        # hook await resumes, and the dicts themselves are tiny.
        self.incoming_message_queue.clear()

    # -- connection establishment -----------------------------------------

    def _create_connection(self, document: Document) -> Connection:
        hook_payload = self.hook_payloads[document.name]
        instance = Connection(
            self.transport,
            hook_payload.request,
            document,
            hook_payload.socket_id,
            hook_payload.context,
            hook_payload.connection_config.read_only,
        )

        def handle_close(document: Document, event: Optional[CloseEvent]) -> None:
            disconnect_payload = Payload(
                instance=self.document_provider,
                clients_count=document.get_connections_count(),
                context=hook_payload.context,
                document=document,
                socket_id=hook_payload.socket_id,
                document_name=document.name,
                request_headers=hook_payload.request_headers,
                request_parameters=hook_payload.request_parameters,
            )

            async def run() -> None:
                try:
                    await self.hooks("on_disconnect", disconnect_payload)
                finally:
                    for callback in self.callbacks["on_close"]:
                        result = callback(document, disconnect_payload)
                        if asyncio.iscoroutine(result):
                            await result

            asyncio.ensure_future(run())

        instance.on_close(handle_close)

        async def stateless_callback(payload: Payload) -> None:
            try:
                return await self.hooks("on_stateless", payload)
            except Exception as error:
                if str(error):
                    raise

        instance.on_stateless_callback(stateless_callback)

        async def before_handle_message(connection: Connection, update: bytes) -> None:
            await self.hooks(
                "before_handle_message",
                Payload(
                    instance=self.document_provider,
                    clients_count=document.get_connections_count(),
                    context=hook_payload.context,
                    document=document,
                    socket_id=hook_payload.socket_id,
                    connection=connection,
                    document_name=document.name,
                    request_headers=hook_payload.request_headers,
                    request_parameters=hook_payload.request_parameters,
                    update=update,
                ),
            )

        instance.before_handle_message(before_handle_message)

        async def before_sync(connection: Connection, payload: Payload) -> None:
            await self.hooks(
                "before_sync",
                Payload(
                    clients_count=document.get_connections_count(),
                    context=hook_payload.context,
                    document=document,
                    document_name=document.name,
                    connection=connection,
                    type=payload.type,
                    payload=payload.payload,
                ),
            )

        instance.before_sync(before_sync)
        return instance

    async def _set_up_new_connection(self, document_name: str) -> None:
        hook_payload = self.hook_payloads[document_name]
        document = await self.document_provider.create_document(
            document_name,
            hook_payload.request,
            hook_payload.socket_id,
            hook_payload.connection_config,
            hook_payload.context,
        )
        connection = self._create_connection(document)

        def cleanup(document: Document, event: Optional[CloseEvent]) -> None:
            self.hook_payloads.pop(document_name, None)
            self.document_connections.pop(document_name, None)
            self.incoming_message_queue.pop(document_name, None)
            self.document_connections_established.discard(document_name)

        connection.on_close(cleanup)
        self.document_connections[document_name] = connection

        if self.transport.is_closed:
            self.close()
            return

        # Replay queued messages now that the connection is established.
        queued = self.incoming_message_queue.get(document_name, [])
        for data in list(queued):
            await connection.handle_message(data)

        await self.hooks(
            "connected",
            Payload(
                **{
                    **hook_payload.__dict__,
                    "document_name": document_name,
                    "connection": connection,
                }
            ),
        )

    async def _handle_queueing_message(self, data: bytes) -> None:
        try:
            document_name, message_type, offset = parse_frame_header(data)

            if not (
                message_type == MessageType.Auth
                and document_name not in self.document_connections_established
            ):
                self.incoming_message_queue[document_name].append(data)
                return

            # The Auth message we have been waiting for.
            self.document_connections_established.add(document_name)
            tmp = IncomingMessage(data)
            tmp.decoder.pos = offset
            tmp.read_var_uint()  # auth submessage type (always Token)
            token = tmp.read_var_string()

            hook_payload = self.hook_payloads[document_name]
            wire = get_wire_telemetry()
            auth_started = time.perf_counter() if wire.enabled else None
            try:
                def merge_context(context_additions: Any) -> None:
                    if isinstance(context_additions, dict):
                        hook_payload.context = {**hook_payload.context, **context_additions}

                await self.hooks(
                    "on_connect",
                    Payload(**{**hook_payload.__dict__, "document_name": document_name}),
                    merge_context,
                )
                await self.hooks(
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
                # connect/auth admission (docs/guides/overload.md):
                # AFTER the hook chain, so a tenant stamped into the
                # context by an auth hook is honored and an invalid
                # token never drains a victim's bucket. RED refuses
                # every new document channel; the tenant's connect
                # bucket is CHARGED here — one token per channel
                # actually established (the upgrade path only peeked).
                # Refusal answers permission-denied (the same protocol
                # behavior in-process embedders and websocket clients
                # see) and un-establishes the channel so a retry can
                # re-attempt once pressure eases. Edge-relayed sessions
                # (context stamped by the cell ingress, edge/cell.py)
                # were admitted AT THE DOOR — charging again would
                # double-bill every tenant once per tier.
                context = hook_payload.context
                relayed_from_edge = isinstance(context, dict) and context.get(
                    "edge"
                )
                overload = get_overload_controller()
                if overload.enabled and not relayed_from_edge:
                    tenant = resolve_tenant(
                        request=self.request, context=hook_payload.context
                    )
                    refusal = overload.admit_connect(tenant)
                    if refusal is not None:
                        self.document_connections_established.discard(
                            document_name
                        )
                        message = OutgoingMessage(
                            document_name
                        ).write_permission_denied(
                            f"overloaded: {refusal}; "
                            f"retry-after={overload.retry_after_s:g}s"
                        )
                        self.transport.send(message.to_bytes())
                        return
                hook_payload.connection_config.is_authenticated = True
                message = OutgoingMessage(document_name).write_authenticated(
                    hook_payload.connection_config.read_only
                )
                self.transport.send(message.to_bytes())
                await self._set_up_new_connection(document_name)
            except Exception as error:
                if auth_started is not None:
                    wire.record_auth(time.perf_counter() - auth_started, ok=False)
                reason = getattr(error, "reason", None) or (
                    getattr(getattr(error, "event", None), "reason", None)
                )
                message = OutgoingMessage(document_name).write_permission_denied(
                    reason or "permission-denied"
                )
                self.transport.send(message.to_bytes())
        except Exception as error:
            logger.log_error(f"error while establishing connection: {error!r}")
            self.transport.close(RESET_CONNECTION.code, RESET_CONNECTION.reason)

    async def handle_message(self, data: bytes) -> None:
        try:
            # native single-call header parse for routing (the per-
            # message hot path; falls back to the Python codec)
            document_name, _msg_type, _offset = parse_frame_header(data)
        except Exception as error:
            logger.log_error(f"invalid message payload: {error!r}")
            self.transport.close(UNAUTHORIZED.code, UNAUTHORIZED.reason)
            return

        connection = self.document_connections.get(document_name)
        if connection is not None:
            await connection.handle_message(data)
            return

        if document_name not in self.incoming_message_queue:
            self.incoming_message_queue[document_name] = []
            self.hook_payloads[document_name] = Payload(
                instance=self.document_provider,
                request=self.request,
                connection_config=ConnectionConfiguration(
                    read_only=False, is_authenticated=False
                ),
                request_headers=self.request.headers,
                request_parameters=self.request.parameters,
                socket_id=self.socket_id,
                context={**self.default_context},
            )
        await self._handle_queueing_message(data)
