"""Hocuspocus wire messages: [varString documentName][varUint type][payload].

Python equivalents of the reference's IncomingMessage/OutgoingMessage
wrappers (`packages/server/src/IncomingMessage.ts` / `OutgoingMessage.ts`).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Any, Iterable, Optional

from ..crdt import Doc
from ..crdt.encoding import Decoder, Encoder
from .auth import write_authenticated, write_authentication, write_permission_denied
from .awareness import Awareness, encode_awareness_update
from .sync import write_sync_step1, write_sync_step2, write_update


class MessageType(IntEnum):
    Unknown = -1
    Sync = 0
    Awareness = 1
    Auth = 2
    QueryAwareness = 3
    SyncReply = 4  # same as Sync, but won't trigger another SyncStep1
    Stateless = 5
    BroadcastStateless = 6
    CLOSE = 7
    SyncStatus = 8


class IncomingMessage:
    """Decoder over a received frame, with a lazy reply encoder."""

    def __init__(self, data: bytes) -> None:
        self.decoder = Decoder(data)
        self._encoder: Optional[Encoder] = None

    @property
    def encoder(self) -> Encoder:
        if self._encoder is None:
            self._encoder = Encoder()
        return self._encoder

    def read_var_uint(self) -> int:
        return self.decoder.read_var_uint()

    def read_var_string(self) -> str:
        return self.decoder.read_var_string()

    def read_var_uint8_array(self) -> bytes:
        return self.decoder.read_var_uint8_array()

    def peek_var_uint8_array(self) -> bytes:
        pos = self.decoder.pos
        result = self.decoder.read_var_uint8_array()
        self.decoder.pos = pos
        return result

    def peek_var_string(self) -> str:
        return self.decoder.peek_var_string()

    def write_var_uint(self, value: int) -> None:
        self.encoder.write_var_uint(value)

    def write_var_string(self, value: str) -> None:
        self.encoder.write_var_string(value)

    def to_bytes(self) -> bytes:
        return self.encoder.to_bytes()

    @property
    def length(self) -> int:
        return len(self.encoder)


class OutgoingMessage:
    """Builder for an outbound frame, prefixed with the document name."""

    def __init__(self, document_name: str) -> None:
        self.encoder = Encoder()
        self.type: Optional[int] = None
        self.category: Optional[str] = None
        self.document_name = document_name
        self.encoder.write_var_string(document_name)

    def create_sync_message(self) -> "OutgoingMessage":
        self.type = MessageType.Sync
        self.encoder.write_var_uint(MessageType.Sync)
        return self

    def create_sync_reply_message(self) -> "OutgoingMessage":
        self.type = MessageType.SyncReply
        self.encoder.write_var_uint(MessageType.SyncReply)
        return self

    def create_awareness_update_message(
        self, awareness: Awareness, changed_clients: Optional[Iterable[int]] = None
    ) -> "OutgoingMessage":
        self.type = MessageType.Awareness
        self.category = "Update"
        clients = list(changed_clients) if changed_clients is not None else list(awareness.get_states().keys())
        message = encode_awareness_update(awareness, clients)
        self.encoder.write_var_uint(MessageType.Awareness)
        self.encoder.write_var_uint8_array(message)
        return self

    def write_query_awareness(self) -> "OutgoingMessage":
        self.type = MessageType.QueryAwareness
        self.category = "Update"
        self.encoder.write_var_uint(MessageType.QueryAwareness)
        return self

    def write_authentication(self, token: str) -> "OutgoingMessage":
        # client -> server (used by the provider)
        self.type = MessageType.Auth
        self.category = "Token"
        self.encoder.write_var_uint(MessageType.Auth)
        write_authentication(self.encoder, token)
        return self

    def write_authenticated(self, readonly: bool) -> "OutgoingMessage":
        self.type = MessageType.Auth
        self.category = "Authenticated"
        self.encoder.write_var_uint(MessageType.Auth)
        write_authenticated(self.encoder, "readonly" if readonly else "read-write")
        return self

    def write_permission_denied(self, reason: str) -> "OutgoingMessage":
        self.type = MessageType.Auth
        self.category = "PermissionDenied"
        self.encoder.write_var_uint(MessageType.Auth)
        write_permission_denied(self.encoder, reason)
        return self

    def write_first_sync_step_for(self, document: Doc) -> "OutgoingMessage":
        self.category = "SyncStep1"
        write_sync_step1(self.encoder, document)
        return self

    def write_second_sync_step_for(
        self, document: Doc, encoded_state_vector: Optional[bytes] = None
    ) -> "OutgoingMessage":
        self.category = "SyncStep2"
        write_sync_step2(self.encoder, document, encoded_state_vector)
        return self

    def write_update(self, update: bytes) -> "OutgoingMessage":
        self.category = "Update"
        write_update(self.encoder, update)
        return self

    def write_stateless(self, payload: str) -> "OutgoingMessage":
        self.category = "Stateless"
        self.encoder.write_var_uint(MessageType.Stateless)
        self.encoder.write_var_string(payload)
        return self

    def write_broadcast_stateless(self, payload: str) -> "OutgoingMessage":
        self.category = "Stateless"
        self.encoder.write_var_uint(MessageType.BroadcastStateless)
        self.encoder.write_var_string(payload)
        return self

    def write_sync_status(self, update_saved: bool) -> "OutgoingMessage":
        self.category = "SyncStatus"
        self.encoder.write_var_uint(MessageType.SyncStatus)
        self.encoder.write_var_uint(1 if update_saved else 0)
        return self

    def write_close_message(self, reason: str) -> "OutgoingMessage":
        self.type = MessageType.CLOSE
        self.encoder.write_var_uint(MessageType.CLOSE)
        self.encoder.write_var_string(reason)
        return self

    def to_bytes(self) -> bytes:
        return self.encoder.to_bytes()
