"""Hot-path wire-frame helpers on the port's native C++ codec.

These cover the three per-message operations the server performs most:
routing (header parse), the update broadcast frame, and the per-update
durability ack (reference `packages/server/src/OutgoingMessage.ts`
frame layout; `Document.ts:228-240` fan-out; `MessageReceiver.ts:206-212`
ack). Each helper makes one call into `hocuspocus_tpu_torch.native`;
the pure-Python codec (`crdt.encoding`) stays the correctness reference,
and the native functions match it byte for byte
(tests/test_torch_native.py).
"""

from __future__ import annotations

import time

from ..native import get_codec


def _type_name(message_type: int) -> str:
    from ..observability.wire import message_type_name

    return message_type_name(message_type)


def parse_frame_header(data: bytes) -> tuple[str, int, int]:
    """[varString name][varUint type] -> (name, type, payload offset)."""
    ledger = get_cost_ledger()
    t0 = time.perf_counter_ns() if ledger.enabled else 0
    parsed = get_codec().parse_frame_header(data)
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
    frame = get_codec().build_update_frame(name, update, reply)
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
    """Parse N frame headers in ONE native call (GIL released during the
    byte scan; consecutive frames for the same document share one str).

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
    parsed = get_codec().parse_frame_headers_batch(frames, skip_malformed)
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
    """Build N broadcast frames in ONE native call (frames laid out in a
    single arena with the GIL released, then cut into per-frame bytes).
    Ledger cost is amortized across the batch like the scalar path's
    per-frame ``frame_encode`` records."""
    if not items:
        return []
    ledger = get_cost_ledger()
    t0 = time.perf_counter_ns() if ledger.enabled else 0
    built = get_codec().build_update_frames_batch(
        [it if isinstance(it, tuple) else tuple(it) for it in items]
    )
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
    return get_codec().build_sync_status_frame(name, ok)


# Imported last: the observability package imports the server, whose
# connection module imports `parse_frame_header` from here. With the
# helpers above already defined, importing this module first (before the
# server) completes instead of meeting a partly initialized module.
from ..observability.costs import get_cost_ledger  # noqa: E402
