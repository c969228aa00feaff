from .awareness import Awareness, awareness_states_to_array, encode_awareness_update
from .close_events import (
    CloseEvent,
    CONNECTION_TIMEOUT,
    FORBIDDEN,
    MESSAGE_TOO_BIG,
    RESET_CONNECTION,
    UNAUTHORIZED,
)
from .message import IncomingMessage, MessageType, OutgoingMessage
from .sync import (
    MESSAGE_YJS_SYNC_STEP1,
    MESSAGE_YJS_SYNC_STEP2,
    MESSAGE_YJS_UPDATE,
    read_sync_message,
    read_sync_step1,
    read_sync_step2,
    read_update,
    write_sync_step1,
    write_sync_step2,
    write_update,
)
from .auth import (
    AuthMessageType,
    read_auth_message,
    write_authenticated,
    write_authentication,
    write_permission_denied,
)

__all__ = [
    "Awareness",
    "awareness_states_to_array",
    "encode_awareness_update",
    "CloseEvent",
    "CONNECTION_TIMEOUT",
    "FORBIDDEN",
    "MESSAGE_TOO_BIG",
    "RESET_CONNECTION",
    "UNAUTHORIZED",
    "IncomingMessage",
    "MessageType",
    "OutgoingMessage",
    "MESSAGE_YJS_SYNC_STEP1",
    "MESSAGE_YJS_SYNC_STEP2",
    "MESSAGE_YJS_UPDATE",
    "read_sync_message",
    "read_sync_step1",
    "read_sync_step2",
    "read_update",
    "write_sync_step1",
    "write_sync_step2",
    "write_update",
    "AuthMessageType",
    "read_auth_message",
    "write_authenticated",
    "write_authentication",
    "write_permission_denied",
]
