"""y-protocols/sync equivalent: state-vector handshake + update relay."""

from __future__ import annotations

from typing import Any, Optional

from ..crdt import Doc, apply_update, encode_state_as_update, encode_state_vector
from ..crdt.encoding import Decoder, Encoder

MESSAGE_YJS_SYNC_STEP1 = 0
MESSAGE_YJS_SYNC_STEP2 = 1
MESSAGE_YJS_UPDATE = 2


def write_sync_step1(encoder: Encoder, doc: Doc) -> None:
    encoder.write_var_uint(MESSAGE_YJS_SYNC_STEP1)
    encoder.write_var_uint8_array(encode_state_vector(doc))


def write_sync_step2(encoder: Encoder, doc: Doc, encoded_state_vector: Optional[bytes] = None) -> None:
    encoder.write_var_uint(MESSAGE_YJS_SYNC_STEP2)
    encoder.write_var_uint8_array(encode_state_as_update(doc, encoded_state_vector))


def read_sync_step1(decoder: Decoder, encoder: Encoder, doc: Doc) -> None:
    write_sync_step2(encoder, doc, decoder.read_var_uint8_array())


def read_sync_step2(decoder: Decoder, doc: Doc, transaction_origin: Any = None) -> None:
    apply_update(doc, decoder.read_var_uint8_array(), transaction_origin)


def write_update(encoder: Encoder, update: bytes) -> None:
    encoder.write_var_uint(MESSAGE_YJS_UPDATE)
    encoder.write_var_uint8_array(update)


def coalesce_updates(updates: "list[bytes]") -> Optional[bytes]:
    """Merge one broadcast tick's captured updates into ONE equivalent
    update payload (the fan-out engine's per-tick frame — see
    server/fanout.py). Returns None when the merge fails; the caller
    must then fall back to per-update fan-out so no update is lost.

    Native-first: the C++ codec merges at the byte level (spans copied
    verbatim, GIL released) and returns None whenever it cannot prove
    byte identity with the Python merge — rich content refs, overlapping
    runs needing an offset split, non-canonical varints — in which case
    we fall through to :func:`crdt.update.merge_updates` unchanged.
    """
    if len(updates) == 1:
        return updates[0]
    from ..native import get_codec

    merged = get_codec().coalesce_updates(updates)
    if merged is not None:
        return merged
    from ..crdt.update import merge_updates

    try:
        return merge_updates(updates)
    except Exception:
        return None


read_update = read_sync_step2


def read_sync_message(decoder: Decoder, encoder: Encoder, doc: Doc, transaction_origin: Any = None) -> int:
    message_type = decoder.read_var_uint()
    if message_type == MESSAGE_YJS_SYNC_STEP1:
        read_sync_step1(decoder, encoder, doc)
    elif message_type == MESSAGE_YJS_SYNC_STEP2:
        read_sync_step2(decoder, doc, transaction_origin)
    elif message_type == MESSAGE_YJS_UPDATE:
        read_update(decoder, doc, transaction_origin)
    else:
        raise ValueError(f"unknown sync message type {message_type}")
    return message_type
