"""HocuspocusProvider — binds a CRDT Doc + Awareness to a server document.

Capability parity with reference `packages/provider/src/HocuspocusProvider.ts`:
attach/detach on a shared multiplexing socket, token auth, sync
handshake, unsynced-change accounting with SyncStatus acks, awareness
propagation, stateless messages, force-sync interval.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional, Union

from ..crdt import Doc
from ..crdt.doc import Observable
from ..protocol.awareness import (
    Awareness,
    awareness_states_to_array,
    encode_awareness_update,
    remove_awareness_states,
)
from ..protocol.message import IncomingMessage, MessageType, OutgoingMessage
from ..protocol.sync import write_sync_step1, write_update
from .message_receiver import MessageReceiver


class AwarenessError(Exception):
    code = 1001


_NO_AWARENESS = object()


class HocuspocusProvider(Observable):
    def __init__(
        self,
        name: str,
        url: Optional[str] = None,
        websocket_provider: Optional["HocuspocusProviderWebsocket"] = None,
        document: Optional[Doc] = None,
        awareness: Any = _NO_AWARENESS,
        token: Union[str, Callable, None] = None,
        force_sync_interval: Optional[float] = None,
        min_reconnect_delay_ms: Optional[float] = None,
        max_reconnect_delay_ms: Optional[float] = None,
        **callbacks: Any,
    ) -> None:
        super().__init__()
        self.name = name
        self.document = document if document is not None else Doc()
        if awareness is _NO_AWARENESS:
            self.awareness: Optional[Awareness] = Awareness(self.document)
        else:
            self.awareness = awareness
        self.token = token
        self.is_synced = False
        self.unsynced_changes = 0
        self.is_authenticated = False
        self.authorized_scope: Optional[str] = None
        self.manage_socket = websocket_provider is None
        self._is_attached = False
        self._force_sync_task: Optional[asyncio.Task] = None

        if websocket_provider is None:
            if url is None:
                raise ValueError("provide either url or websocket_provider")
            # reconnect pacing is part of the provider configuration:
            # capped exponential backoff + jitter between these bounds
            # (provider/websocket.py `_backoff_delay`)
            from .websocket import HocuspocusProviderWebsocket

            websocket_provider = HocuspocusProviderWebsocket(
                url,
                min_reconnect_delay_ms=min_reconnect_delay_ms,
                max_reconnect_delay_ms=max_reconnect_delay_ms,
            )
        self.websocket_provider = websocket_provider

        for event_name, fn in callbacks.items():
            if event_name.startswith("on_") and callable(fn):
                self.on(event_name[3:], fn)

        if self.awareness is not None:
            self.awareness.on("update", self._awareness_update_handler)
            self.awareness.on(
                "update",
                lambda changes, origin: self.emit(
                    "awareness_update",
                    {"states": awareness_states_to_array(self.awareness.get_states())},
                ),
            )
            self.awareness.on(
                "change",
                lambda changes, origin: self.emit(
                    "awareness_change",
                    {"states": awareness_states_to_array(self.awareness.get_states())},
                ),
            )
        self.document.on("update", self._document_update_handler)

        if force_sync_interval:
            self._force_sync_task = asyncio.ensure_future(
                self._force_sync_loop(force_sync_interval / 1000)
            )

        if self.manage_socket:
            self.attach()

    # -- events from the shared socket -------------------------------------

    def _forward(self, event: str) -> Callable:
        return lambda *args: self.emit(event, *args)

    def attach(self) -> None:
        if self._is_attached:
            return
        ws = self.websocket_provider
        self._socket_handlers = {
            "connect": self._forward("connect"),
            "status": self._forward("status"),
            "close": lambda *args: (self.on_socket_close(), self.emit("close", *args)),
            "disconnect": self._forward("disconnect"),
            "destroy": self._forward("destroy"),
        }
        for event_name, handler in self._socket_handlers.items():
            ws.on(event_name, handler)
        self._is_attached = True
        ws.attach(self)

    def detach(self) -> None:
        if not self._is_attached:
            return
        ws = self.websocket_provider
        for event_name, handler in getattr(self, "_socket_handlers", {}).items():
            ws.off(event_name, handler)
        ws.detach(self)
        self._is_attached = False

    @property
    def is_attached(self) -> bool:
        return self._is_attached

    # -- connection lifecycle ----------------------------------------------

    async def on_open(self) -> None:
        self.is_authenticated = False
        self.emit("open", {})
        try:
            token = await self.get_token()
        except Exception as error:
            self.permission_denied_handler(f"failed to get token: {error}")
            return
        message = OutgoingMessage(self.name).write_authentication(token or "")
        self.send(message)
        self.start_sync()

    async def get_token(self) -> Optional[str]:
        token = self.token
        if callable(token):
            token = token()
        if asyncio.iscoroutine(token):
            token = await token
        return token

    def start_sync(self) -> None:
        self.reset_unsynced_changes()
        message = OutgoingMessage(self.name).create_sync_message()
        from ..crdt import encode_state_vector

        message.encoder.write_var_uint(0)  # SyncStep1
        message.encoder.write_var_uint8_array(encode_state_vector(self.document))
        self.send(message)
        if self.awareness is not None and self.awareness.get_local_state() is not None:
            awareness_message = OutgoingMessage(self.name)
            awareness_message.encoder.write_var_uint(MessageType.Awareness)
            awareness_message.encoder.write_var_uint8_array(
                encode_awareness_update(self.awareness, [self.document.client_id])
            )
            self.send(awareness_message)

    def force_sync(self) -> None:
        self.reset_unsynced_changes()
        message = OutgoingMessage(self.name).create_sync_message()
        from ..crdt import encode_state_vector

        message.encoder.write_var_uint(0)
        message.encoder.write_var_uint8_array(encode_state_vector(self.document))
        self.send(message)

    async def _force_sync_loop(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            self.force_sync()

    # -- outbound ----------------------------------------------------------

    def send(self, message: OutgoingMessage) -> None:
        if not self._is_attached:
            return
        self.emit("outgoing_message", {"message": message})
        self.websocket_provider.send(message.to_bytes())

    def send_raw(self, data: bytes) -> None:
        if self._is_attached:
            self.websocket_provider.send(data)

    def send_stateless(self, payload: str) -> None:
        self.send(OutgoingMessage(self.name).write_stateless(payload))

    def _document_update_handler(self, update: bytes, origin: Any, *rest: Any) -> None:
        if origin is self:
            return
        self.increment_unsynced_changes()
        message = OutgoingMessage(self.name).create_sync_message()
        write_update(message.encoder, update)
        self.send(message)

    def _awareness_update_handler(self, changes: dict, origin: Any) -> None:
        changed_clients = changes["added"] + changes["updated"] + changes["removed"]
        if self.awareness is None:
            return
        message = OutgoingMessage(self.name)
        message.encoder.write_var_uint(MessageType.Awareness)
        message.encoder.write_var_uint8_array(
            encode_awareness_update(self.awareness, changed_clients)
        )
        self.send(message)

    # -- sync accounting ---------------------------------------------------

    @property
    def synced(self) -> bool:
        return self.is_synced

    @synced.setter
    def synced(self, state: bool) -> None:
        if self.is_synced == state:
            return
        self.is_synced = state
        if state:
            self.emit("synced", {"state": state})

    @property
    def has_unsynced_changes(self) -> bool:
        return self.unsynced_changes > 0

    def reset_unsynced_changes(self) -> None:
        self.unsynced_changes = 1
        self.emit("unsynced_changes", {"number": self.unsynced_changes})

    def increment_unsynced_changes(self) -> None:
        self.unsynced_changes += 1
        self.emit("unsynced_changes", {"number": self.unsynced_changes})

    def decrement_unsynced_changes(self) -> None:
        if self.unsynced_changes > 0:
            self.unsynced_changes -= 1
        if self.unsynced_changes == 0:
            self.synced = True
        self.emit("unsynced_changes", {"number": self.unsynced_changes})

    # -- inbound -----------------------------------------------------------

    def on_message(self, data: bytes) -> None:
        message = IncomingMessage(data)
        document_name = message.read_var_string()
        message.write_var_string(document_name)
        self.emit("message", {"data": data})
        MessageReceiver(message).apply(self, emit_synced=True)

    def receive_stateless(self, payload: str) -> None:
        self.emit("stateless", {"payload": payload})

    def handle_server_close(self, reason: str) -> None:
        event = {"code": 1000, "reason": reason}
        self.on_socket_close()
        self.emit("close", {"event": event})

    def on_socket_close(self, *args: Any) -> None:
        self.is_authenticated = False
        self.synced = False
        if self.awareness is not None:
            remove_awareness_states(
                self.awareness,
                [c for c in self.awareness.get_states() if c != self.document.client_id],
                self,
            )

    # -- auth --------------------------------------------------------------

    def permission_denied_handler(self, reason: str) -> None:
        self.emit("authentication_failed", {"reason": reason})
        self.is_authenticated = False

    def authenticated_handler(self, scope: str) -> None:
        self.is_authenticated = True
        self.authorized_scope = scope
        self.emit("authenticated", {"scope": scope})

    # -- misc --------------------------------------------------------------

    def set_awareness_field(self, key: str, value: Any) -> None:
        if self.awareness is None:
            raise AwarenessError(
                f"cannot set awareness field {key!r}: awareness is disabled "
                "for this provider (awareness=None)"
            )
        self.awareness.set_local_state_field(key, value)

    def set_awareness_cursor(
        self,
        ytype: Any,
        anchor: int,
        head: "Optional[int]" = None,
        field: str = "cursor",
    ) -> None:
        """Publish a caret/selection as RELATIVE positions — anchors
        that keep pointing at the same characters through concurrent
        edits (the collaboration-cursor convention; peers resolve with
        `resolve_awareness_cursor`)."""
        from ..crdt import (
            create_relative_position_from_type_index,
            encode_relative_position,
        )

        head = anchor if head is None else head
        self.set_awareness_field(
            field,
            {
                "anchor": encode_relative_position(
                    create_relative_position_from_type_index(ytype, anchor)
                ).hex(),
                "head": encode_relative_position(
                    create_relative_position_from_type_index(ytype, head)
                ).hex(),
            },
        )

    @staticmethod
    def resolve_awareness_cursor(state_field: Any, doc: Any) -> "Optional[dict]":
        """Resolve a peer's cursor field (as published by
        `set_awareness_cursor`) against MY copy of the doc; None when
        the field is malformed or the anchors are unknown here."""
        from ..crdt import (
            create_absolute_position_from_relative_position,
            decode_relative_position,
        )

        if not isinstance(state_field, dict):
            return None
        out = {}
        for key in ("anchor", "head"):
            raw = state_field.get(key)
            if not isinstance(raw, str):
                return None
            try:
                rpos = decode_relative_position(bytes.fromhex(raw))
            except Exception:
                return None
            pos = create_absolute_position_from_relative_position(rpos, doc)
            if pos is None:
                return None
            out[key] = pos.index
        return out

    def connect(self):
        if self.manage_socket:
            self.websocket_provider.connect()

    def disconnect(self) -> None:
        if self.manage_socket:
            self.websocket_provider.disconnect()

    def destroy(self) -> None:
        self.emit("destroy")
        if self._force_sync_task is not None:
            self._force_sync_task.cancel()
        if self.awareness is not None:
            remove_awareness_states(self.awareness, [self.document.client_id], "provider destroy")
            self.awareness.off("update", self._awareness_update_handler)
            self.awareness.destroy()
        self.document.off("update", self._document_update_handler)
        self.detach()
        if self.manage_socket:
            self.websocket_provider.destroy()
        self._observers = {}
