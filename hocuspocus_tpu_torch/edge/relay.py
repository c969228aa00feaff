"""Frame-relay protocol between the edge tier and merge cells.

The edge↔cell hop reuses the pipelined RESP transport machinery wholesale: every
relay message is ONE pub/sub publish on the pipelined RESP lane
(`net/resp.py PipelinedRedisClient.publish_nowait` — per-tick coalesced
into a single write+drain, flushed-or-resent on transport failure), and
the in-process `MiniRedis` serves as the bus for tests and single-host
topologies exactly as it does for cross-instance replication.

Channel layout (all under one `prefix`, default ``hocuspocus-edge``):

==========================  =================================================
``{prefix}:cell:{cell}``    edge → cell: session OPEN/FRAME/DETACH/CLOSE
``{prefix}:edge:{edge}``    cell → edge: session FRAME/CLOSED replies
``{prefix}:cells``          control plane: CELL_UP (also the heartbeat),
                            CELL_DRAINING (graceful drain announces departure),
                            CELL_DOWN — the router registry rides this
==========================  =================================================

Envelope: ``[varUint kind][varString session][varString aux]
[varUint8Array payload]``. ``session`` identifies one (client socket,
cell) relay session; ``aux`` carries side data (OPEN: a JSON context
blob; CLOSED: ``code:reason``; control frames: the cell id rides the
session field). ``payload`` is a verbatim hocuspocus wire frame — the
relay never re-encodes protocol traffic, which is what keeps the edge
stateless: CRDT sync is order-insensitive and state-based (Shapiro et
al.), so at-most-once relay delivery heals through the same SyncStep1
resync exchange the replication lane uses.

Ordering: one publisher connection per process and one bounded
subscriber queue per consumer (mini_redis/_pump, real redis TCP) keep
each channel FIFO, so a session's OPEN → auth → frames arrive in send
order with no handshake round trip.
"""

from __future__ import annotations

import base64
import json
from typing import Optional

from ..crdt.encoding import Encoder

# session-plane kinds (edge -> cell, cell -> edge)
OPEN = 0  # edge opens a relay session on a cell (aux: JSON context)
FRAME = 1  # verbatim wire frame, either direction
DETACH = 2  # edge detaches ONE doc channel from a session (aux: doc name)
CLOSE = 3  # edge closes the whole session (client socket went away)
CLOSED = 4  # cell closed the session (aux: "code:reason")

# control-plane kinds (cell -> every edge, on the control channel; the
# cell id rides the session field)
CELL_UP = 10  # liveness announce — doubles as the heartbeat
CELL_DRAINING = 11  # graceful drain started: remap my docs NOW
CELL_DOWN = 12  # orderly departure (destroy)
# telemetry federation (docs/guides/observability.md "fleet view"):
# every role publishes a compact periodic digest on the control channel
# (payload: JSON digest bytes; the node id rides the session field) —
# the FleetView aggregator on any subscribed peer ingests them
DIGEST = 13
# clock-offset probes (cross-tier tracing): an edge PINGs a cell's
# channel (aux: JSON {"t": sender perf_counter}); the cell answers PONG
# on the edge's channel echoing the sender stamp plus its own clock —
# the edge folds the RTT-midpoint offset estimate into the relay spans
PING = 20
PONG = 21
# cross-tier trace returns: the cell closes a traced update's lifecycle
# at the device barrier — AFTER the encode-once broadcast frame already
# left (fan-out is host-decoupled) — so the return context rides its own
# envelope back to the stamping edge (aux: {"v":1,"r":[...]}; same
# pipelined lane, per-tick coalesced). Unknown to old edges: ignored.
TRACE_RET = 22

# hot-doc replication kinds (docs/guides/hot-doc-replication.md). Two
# FOLLOW shapes share one kind, told apart by the aux keys:
#   edge → cell   aux {"d": doc, "o": owner_id} — a routing hint: "this
#                 doc's owner is `o`; follow it". When `o` names the
#                 receiving cell itself, the cell BECOMES the owner
#                 (promotion path).
#   cell → cell   aux {"d": doc, "f": follower_id, "sv": b64 state
#                 vector} — the follower subscribing at (or resyncing
#                 with) the owner; the owner answers with a REPLICA_TICK
#                 carrying the SV-diff plus its own state vector.
# REPLICA_TICK (owner → follower) aux {"d": doc, "s": seq} carries the
# owner's per-tick coalesced update; a bootstrap/resync reply adds
# {"r": 1, "sv": owner SV b64} and resets the follower's seq counter.
# A seq gap means a lost tick: the follower re-FOLLOWs with its local
# state vector — the same state-based SyncStep1 resync exchange that
# heals the relay everywhere else, never a silent divergence.
# REPLICA_PUSH (follower → owner) aux {"d": doc} forwards coalesced
# follower-local writes up to the owner, which applies them under a
# replicable origin so the next tick re-streams them to every follower.
FOLLOW = 30
UNFOLLOW = 31
REPLICA_TICK = 32
REPLICA_PUSH = 33

KIND_NAMES = {
    OPEN: "open",
    FRAME: "frame",
    DETACH: "detach",
    CLOSE: "close",
    CLOSED: "closed",
    CELL_UP: "cell_up",
    CELL_DRAINING: "cell_draining",
    CELL_DOWN: "cell_down",
    DIGEST: "digest",
    PING: "ping",
    PONG: "pong",
    TRACE_RET: "trace_return",
    FOLLOW: "follow",
    UNFOLLOW: "unfollow",
    REPLICA_TICK: "replica_tick",
    REPLICA_PUSH: "replica_push",
}

DEFAULT_PREFIX = "hocuspocus-edge"


def cell_channel(prefix: str, cell_id: str) -> str:
    return f"{prefix}:cell:{cell_id}"


def edge_channel(prefix: str, edge_id: str) -> str:
    return f"{prefix}:edge:{edge_id}"


def control_channel(prefix: str) -> str:
    return f"{prefix}:cells"


def encode_envelope(
    kind: int, session: str, aux: str = "", payload: bytes = b""
) -> bytes:
    encoder = Encoder()
    encoder.write_var_uint(kind)
    encoder.write_var_string(session)
    encoder.write_var_string(aux)
    encoder.write_var_uint8_array(payload)
    return encoder.to_bytes()


def encode_envelope_view(
    kind: int, session: str, aux: str = "", payload: bytes = b""
) -> "list[bytes | memoryview]":
    """Zero-copy envelope: the header is encoded fresh (it is tiny) but
    the payload — the encode-once broadcast frame shared by the whole
    audience — is wrapped as a memoryview, never copied. The result is a
    segment list for the pipelined publish lane (`net/resp.py
    publish_nowait` accepts segment lists and `b"".join`s them straight
    into the socket write, so the frame bytes are copied exactly once,
    INTO the kernel).

    Lifetime rule (docs/guides/native-codec.md): the segments alias the
    caller's buffer — they must be handed to the transport synchronously
    and never mutated before the flush; holders that outlive the call
    must `bytes()` them first.
    """
    encoder = Encoder()
    encoder.write_var_uint(kind)
    encoder.write_var_string(session)
    encoder.write_var_string(aux)
    encoder.write_var_uint(len(payload))
    return [encoder.to_bytes(), memoryview(payload)]


def decode_envelope(data: bytes) -> "tuple[int, str, str, bytes]":
    """One envelope, parsed by the port's native codec (built on first
    use; a failed build raises: there is no Python parser to fall back
    to)."""
    from ..native import get_codec

    return get_codec().parse_envelope(data)


def decode_envelopes_batch(
    raws: "list[bytes]", skip_malformed: bool = False
) -> "list[tuple[int, str, str, bytes] | None]":
    """Decode a drained batch of envelopes in ONE native call
    (consecutive envelopes of the same session share one str object).
    ``skip_malformed=True`` yields None slots for undecodable entries —
    the relay's drop-and-resync contract — instead of raising."""
    if not raws:
        return []
    from ..native import get_codec

    return get_codec().parse_envelopes_batch(raws, skip_malformed)


def encode_open_aux(edge_id: str, tenant: Optional[str] = None) -> str:
    aux = {"edge": edge_id}
    if tenant:
        aux["tenant"] = tenant
    return json.dumps(aux, sort_keys=True, separators=(",", ":"))


def decode_open_aux(aux: str) -> dict:
    try:
        data = json.loads(aux) if aux else {}
    except Exception:
        data = {}
    return data if isinstance(data, dict) else {}


# -- trace-context aux (versioned, optional envelope extension) -----------
#
# FRAME envelopes may carry a trace context in the (previously unused)
# aux field — docs/guides/edge-routing.md. Edge→cell, a sampled inbound
# update stamps `{"v": 1, "id": <fleet trace id>, "e": <edge id>,
# "d": <doc>, "t0": <edge ingress stamp>, "t1": <edge publish stamp>,
# "h": 1}` (stamps are the edge's own perf_counter — opaque to the
# cell, echoed back verbatim so the edge stays stateless). Cell→edge,
# a TRACE_RET envelope closing traced updates echoes
# `{"v": 1, "r": [{...}, ...]}`: each original context plus the cell's
# receive/close stamps `tr`/`ts` (the cell's OWN clock — the edge
# reconciles via its heartbeat-RTT offset estimate), node id `n`, and
# the incremented hop counter `h`. Both directions are OPTIONAL and
# versioned: an empty/foreign/unversioned aux decodes to None and the
# frame relays exactly as before, so pre-trace envelopes keep parsing.

TRACE_AUX_VERSION = 1


def encode_trace_aux(context: dict) -> str:
    return json.dumps(
        {"v": TRACE_AUX_VERSION, **context}, sort_keys=True, separators=(",", ":")
    )


def decode_trace_aux(aux: str) -> Optional[dict]:
    """The trace context carried by a FRAME aux, or None when absent,
    malformed, or from an incompatible version (forward-compat: unknown
    versions are ignored, never an error)."""
    if not aux:
        return None
    try:
        data = json.loads(aux)
    except Exception:
        return None
    if not isinstance(data, dict) or data.get("v") != TRACE_AUX_VERSION:
        return None
    return data


# -- replica aux (FOLLOW / UNFOLLOW / REPLICA_TICK / REPLICA_PUSH) ---------
#
# Replica envelopes carry structured JSON in the aux field; state vectors
# (raw lib0 bytes) ride base64 under "sv". Malformed aux decodes to {} —
# the dispatcher drops the envelope and the follower's gap detector plus
# the FOLLOW resync exchange recover, same contract as the rest of the
# relay (at-most-once delivery healed by state-based resync).


def encode_replica_aux(**fields) -> str:
    aux = {}
    for key, value in fields.items():
        if value is None:
            continue
        if isinstance(value, (bytes, bytearray)):
            value = base64.b64encode(bytes(value)).decode("ascii")
        aux[key] = value
    return json.dumps(aux, sort_keys=True, separators=(",", ":"))


def decode_replica_aux(aux: str) -> dict:
    """The replica envelope's aux dict with any "sv" field decoded back
    to raw state-vector bytes; {} when absent or malformed."""
    try:
        data = json.loads(aux) if aux else {}
    except Exception:
        return {}
    if not isinstance(data, dict):
        return {}
    sv = data.get("sv")
    if isinstance(sv, str):
        try:
            data["sv"] = base64.b64decode(sv.encode("ascii"))
        except Exception:
            return {}
    return data
