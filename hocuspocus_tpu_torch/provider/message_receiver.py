"""Client-side inbound dispatch (reference provider `MessageReceiver.ts`)."""

from __future__ import annotations

from ..protocol.auth import read_auth_message
from ..protocol.awareness import apply_awareness_update, encode_awareness_update
from ..protocol.message import IncomingMessage, MessageType
from ..protocol.sync import MESSAGE_YJS_SYNC_STEP2, read_sync_message


class MessageReceiver:
    def __init__(self, message: IncomingMessage) -> None:
        self.message = message

    def apply(self, provider, emit_synced: bool = True) -> None:
        message = self.message
        message_type = message.read_var_uint()
        empty_message_length = message.length

        if message_type == MessageType.Sync:
            message.write_var_uint(MessageType.Sync)
            sync_message_type = read_sync_message(
                message.decoder, message.encoder, provider.document, provider
            )
            if emit_synced and sync_message_type == MESSAGE_YJS_SYNC_STEP2:
                provider.synced = True
        elif message_type == MessageType.Awareness:
            if provider.awareness is not None:
                apply_awareness_update(
                    provider.awareness, message.read_var_uint8_array(), provider
                )
        elif message_type == MessageType.Auth:
            read_auth_message(
                message.decoder,
                provider.permission_denied_handler,
                provider.authenticated_handler,
            )
        elif message_type == MessageType.QueryAwareness:
            if provider.awareness is not None:
                message.write_var_uint(MessageType.Awareness)
                message.encoder.write_var_uint8_array(
                    encode_awareness_update(
                        provider.awareness, list(provider.awareness.get_states().keys())
                    )
                )
        elif message_type == MessageType.Stateless:
            provider.receive_stateless(message.read_var_string())
        elif message_type == MessageType.SyncStatus:
            if message.read_var_uint() == 1:
                provider.decrement_unsynced_changes()
        elif message_type == MessageType.CLOSE:
            reason = message.read_var_string()
            provider.handle_server_close(reason)
        else:
            raise ValueError(f"can't apply message of unknown type {message_type}")

        # Reply if the handler produced one (encoder grew beyond the name).
        if message.length > empty_message_length + 1:
            provider.send_raw(message.to_bytes())
