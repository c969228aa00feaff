"""Hot-path wire-frame helpers, on the pure-Python codec.

These cover the three per-message operations the server performs most:
routing (header parse), the update broadcast frame, and the per-update
durability ack (reference `packages/server/src/OutgoingMessage.ts`
frame layout; `Document.ts:228-240` fan-out; `MessageReceiver.ts:206-212`
ack). The port has no native codec yet, so every frame takes the Python
path, which the JAX package's native functions match byte for byte.
"""

from __future__ import annotations

import time

from ..crdt.encoding import Decoder, Encoder
from ..observability.costs import get_cost_ledger
from .sync import MESSAGE_YJS_UPDATE


def _type_name(message_type: int) -> str:
    from ..observability.wire import message_type_name

    return message_type_name(message_type)


def parse_frame_header(data: bytes) -> tuple[str, int, int]:
    """[varString name][varUint type] -> (name, type, payload offset)."""
    ledger = get_cost_ledger()
    t0 = time.perf_counter_ns() if ledger.enabled else 0
    decoder = Decoder(data)
    name = decoder.read_var_string()
    msg_type = decoder.read_var_uint()
    parsed = (name, msg_type, decoder.pos)
    if ledger.enabled:
        # varint_header: attribution detail inside frame_decode (the
        # header's share of the per-frame budget); bytes = header bytes
        ledger.record(
            "varint_header",
            _type_name(parsed[1]),
            time.perf_counter_ns() - t0,
            parsed[2],
        )
    return parsed


def build_update_frame(name: str, update: bytes, reply: bool = False) -> bytes:
    """[name][Sync|SyncReply][yjsUpdate][update] — the broadcast frame."""
    ledger = get_cost_ledger()
    t0 = time.perf_counter_ns() if ledger.enabled else 0
    from .message import MessageType

    encoder = Encoder()
    encoder.write_var_string(name)
    encoder.write_var_uint(MessageType.SyncReply if reply else MessageType.Sync)
    encoder.write_var_uint(MESSAGE_YJS_UPDATE)
    encoder.write_var_uint8_array(update)
    frame = encoder.to_bytes()
    if ledger.enabled:
        ledger.record(
            "frame_encode",
            "SyncReply" if reply else "Sync",
            time.perf_counter_ns() - t0,
            len(frame),
        )
    return frame


def parse_frame_headers_batch(
    frames: "list[bytes]", skip_malformed: bool = False
) -> "list[tuple[str, int, int] | None]":
    """Parse N frame headers.

    Strict mode (default) raises ValueError on the first malformed
    header, matching :func:`parse_frame_header`. ``skip_malformed=True``
    yields ``None`` slots instead — the replication-inbox contract where
    a bad frame is dropped, not fatal. Ledger cost is amortized: one
    ``varint_header`` record advancing the frame counter by N.
    """
    if not frames:
        return []
    ledger = get_cost_ledger()
    t0 = time.perf_counter_ns() if ledger.enabled else 0
    parsed = []
    for i, data in enumerate(frames):
        try:
            decoder = Decoder(data)
            name = decoder.read_var_string()
            msg_type = decoder.read_var_uint()
            parsed.append((name, msg_type, decoder.pos))
        except (ValueError, EOFError, IndexError) as exc:
            # batch parity with the JAX package's native path: ValueError
            # (the scalar path's EOFError/IndexError zoo stays as-is)
            if not skip_malformed:
                raise ValueError(
                    f"malformed frame header at index {i}"
                ) from exc
            parsed.append(None)
        except TypeError:
            # non-buffer input: strict mode propagates, skip mode drops
            if not skip_malformed:
                raise
            parsed.append(None)
    if ledger.enabled:
        ok = [p for p in parsed if p is not None]
        if ok:
            ledger.record_batch(
                "varint_header",
                _type_name(ok[0][1]),
                time.perf_counter_ns() - t0,
                len(ok),
                sum(p[2] for p in ok),
            )
    return parsed


def build_update_frames_batch(
    items: "list[tuple[str, bytes] | tuple[str, bytes, bool]]",
) -> "list[bytes]":
    """Build N broadcast frames. Ledger cost is amortized across the
    batch like the scalar path's per-frame ``frame_encode`` records."""
    if not items:
        return []
    ledger = get_cost_ledger()
    t0 = time.perf_counter_ns() if ledger.enabled else 0
    from .message import MessageType

    built = []
    for it in items:
        name, update = it[0], it[1]
        reply = bool(it[2]) if len(it) > 2 else False
        encoder = Encoder()
        encoder.write_var_string(name)
        encoder.write_var_uint(
            MessageType.SyncReply if reply else MessageType.Sync
        )
        encoder.write_var_uint(MESSAGE_YJS_UPDATE)
        encoder.write_var_uint8_array(update)
        built.append(encoder.to_bytes())
    if ledger.enabled:
        ledger.record_batch(
            "frame_encode",
            "Sync",
            time.perf_counter_ns() - t0,
            len(built),
            sum(len(f) for f in built),
        )
    return built


def build_sync_status_frame(name: str, ok: bool) -> bytes:
    """[name][SyncStatus][0|1] — the per-update durability ack."""
    from .message import MessageType

    encoder = Encoder()
    encoder.write_var_string(name)
    encoder.write_var_uint(MessageType.SyncStatus)
    encoder.write_var_uint(1 if ok else 0)
    return encoder.to_bytes()
