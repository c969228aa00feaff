"""Auth submessage codec (reference `packages/common/src/auth.ts`)."""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, Optional

from ..crdt.encoding import Decoder, Encoder


class AuthMessageType(IntEnum):
    Token = 0
    PermissionDenied = 1
    Authenticated = 2


def write_authentication(encoder: Encoder, auth: str) -> None:
    encoder.write_var_uint(AuthMessageType.Token)
    encoder.write_var_string(auth)


def write_permission_denied(encoder: Encoder, reason: str) -> None:
    encoder.write_var_uint(AuthMessageType.PermissionDenied)
    encoder.write_var_string(reason)


def write_authenticated(encoder: Encoder, scope: str) -> None:
    """scope is 'readonly' or 'read-write'."""
    encoder.write_var_uint(AuthMessageType.Authenticated)
    encoder.write_var_string(scope)


def read_auth_message(
    decoder: Decoder,
    permission_denied_handler: Callable[[str], None],
    authenticated_handler: Callable[[str], None],
) -> None:
    msg_type = decoder.read_var_uint()
    if msg_type == AuthMessageType.PermissionDenied:
        permission_denied_handler(decoder.read_var_string())
    elif msg_type == AuthMessageType.Authenticated:
        authenticated_handler(decoder.read_var_string())
