"""lib0-compatible binary encoding primitives.

The reference stack encodes every wire frame and every Y update with the
`lib0` JavaScript library (see reference `packages/server/src/IncomingMessage.ts`,
`OutgoingMessage.ts`). This module is a byte-compatible reimplementation:
variable-length unsigned/signed integers (7 bits per byte, continuation bit
0x80), length-prefixed UTF-8 strings and byte arrays, and the tagged "Any"
codec used by ContentAny.

Byte-level compatibility with lib0 is required so that documents produced
by this framework interoperate with the Y.js ecosystem.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Any

BITS31 = 0x7FFFFFFF


def _bulk_codec():
    """The port's native codec, whose bulk varint helpers replace the
    per-value Python loops (import deferred: `native` builds the
    extension on first use, and raises if it cannot)."""
    from ..native import get_codec

    return get_codec()


class Encoder:
    """Append-only binary encoder, byte-compatible with lib0's Encoder."""

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def __len__(self) -> int:
        return len(self.buf)

    def to_bytes(self) -> bytes:
        return bytes(self.buf)

    def write_uint8(self, num: int) -> None:
        self.buf.append(num & 0xFF)

    def write_bytes(self, data: bytes | bytearray | memoryview) -> None:
        self.buf += data

    def write_var_uint(self, num: int) -> None:
        if num < 0:
            raise ValueError(f"var_uint must be non-negative, got {num}")
        buf = self.buf
        while num > 0x7F:
            buf.append(0x80 | (num & 0x7F))
            num >>= 7
        buf.append(num)

    def write_var_int(self, num: int, treat_zero_as_negative: bool = False) -> None:
        is_negative = treat_zero_as_negative if num == 0 else num < 0
        if is_negative:
            num = -num
        buf = self.buf
        # First byte: continuation bit 0x80, sign bit 0x40, 6 payload bits.
        buf.append((0x80 if num > 0x3F else 0) | (0x40 if is_negative else 0) | (num & 0x3F))
        num >>= 6
        while num > 0:
            buf.append((0x80 if num > 0x7F else 0) | (num & 0x7F))
            num >>= 7

    def write_var_string(self, s: str) -> None:
        try:
            data = s.encode("utf-8")
        except UnicodeEncodeError:
            # lib0 writeString goes through JS TextEncoder, which merges
            # adjacent surrogate halves into the astral char and replaces
            # LONE halves with U+FFFD — it never throws. Python strs can
            # carry lone surrogates (a client inserting "\ud83d"); mirror
            # TextEncoder exactly instead of crashing the encode: the
            # UTF-16 round trip merges valid pairs and replaces strays.
            data = (
                s.encode("utf-16-le", "surrogatepass")
                .decode("utf-16-le", "replace")
                .encode("utf-8")
            )
        self.write_var_uint(len(data))
        self.buf += data

    def write_var_uint8_array(self, data: bytes | bytearray | memoryview) -> None:
        self.write_var_uint(len(data))
        self.buf += data

    def write_var_uints(self, values) -> None:
        """Bulk varint write: one native call for a whole struct-run /
        state-vector / delete-range sequence."""
        self.buf += _bulk_codec().encode_var_uints(values)

    def write_float32(self, num: float) -> None:
        self.buf += struct.pack(">f", num)

    def write_float64(self, num: float) -> None:
        self.buf += struct.pack(">d", num)

    def write_big_int64(self, num: int) -> None:
        self.buf += struct.pack(">q", num)

    def write_any(self, data: Any) -> None:
        """Tagged Any codec (lib0 encoding.writeAny type tags 116-127)."""
        if data is None:
            self.write_uint8(126)
        elif data is True:
            self.write_uint8(120)
        elif data is False:
            self.write_uint8(121)
        elif isinstance(data, int):
            if abs(data) <= BITS31:
                self.write_uint8(125)
                self.write_var_int(data)
            elif -(2**63) <= data < 2**63:
                self.write_uint8(122)
                self.write_big_int64(data)
            else:
                self.write_uint8(123)
                self.write_float64(float(data))
        elif isinstance(data, float):
            # float32-fitness probe: cap magnitude first — pack(">f")
            # raises OverflowError beyond float32 range, where lib0's
            # isFloat32 just answers false (a 1e300 payload must encode
            # as float64, not crash the encoder)
            if (
                math.isfinite(data)
                and abs(data) <= 3.4028234663852886e38
                and struct.unpack(">f", struct.pack(">f", data))[0] == data
            ):
                self.write_uint8(124)
                self.write_float32(data)
            else:
                self.write_uint8(123)
                self.write_float64(data)
        elif isinstance(data, str):
            self.write_uint8(119)
            self.write_var_string(data)
        elif isinstance(data, (bytes, bytearray, memoryview)):
            self.write_uint8(116)
            self.write_var_uint8_array(data)
        elif isinstance(data, (list, tuple)):
            self.write_uint8(117)
            self.write_var_uint(len(data))
            for item in data:
                self.write_any(item)
        elif isinstance(data, dict):
            self.write_uint8(118)
            self.write_var_uint(len(data))
            for key, value in data.items():
                self.write_var_string(str(key))
                self.write_any(value)
        else:
            # lib0 maps unknown objects to undefined (tag 127).
            self.write_uint8(127)


UNDEFINED = object()
"""Sentinel distinguishing Any tag 127 (undefined) from tag 126 (null)."""


class Decoder:
    """Sequential binary decoder, byte-compatible with lib0's Decoder."""

    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes | bytearray | memoryview) -> None:
        self.buf = bytes(data)
        self.pos = 0

    def has_content(self) -> bool:
        return self.pos < len(self.buf)

    def read_uint8(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def peek_uint8(self) -> int:
        return self.buf[self.pos]

    def read_bytes(self, length: int) -> bytes:
        data = self.buf[self.pos : self.pos + length]
        if len(data) < length:
            raise EOFError("unexpected end of buffer")
        self.pos += length
        return data

    def read_var_uint(self) -> int:
        num = 0
        shift = 0
        buf = self.buf
        while True:
            b = buf[self.pos]
            self.pos += 1
            num |= (b & 0x7F) << shift
            if b < 0x80:
                return num
            shift += 7

    def read_var_int(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        num = b & 0x3F
        sign = -1 if b & 0x40 else 1
        if b < 0x80:
            return sign * num
        shift = 6
        buf = self.buf
        while True:
            b = buf[self.pos]
            self.pos += 1
            num |= (b & 0x7F) << shift
            if b < 0x80:
                return sign * num
            shift += 7

    def read_var_uints(self, count: int) -> tuple:
        """Bulk varint read — the mirror of Encoder.write_var_uints.
        One native call; truncation raises ValueError, unlike scalar
        read_var_uint's IndexError."""
        values, self.pos = _bulk_codec().read_var_uints(self.buf, self.pos, count)
        return values

    def read_var_string(self) -> str:
        length = self.read_var_uint()
        return self.read_bytes(length).decode("utf-8")

    def peek_var_string(self) -> str:
        pos = self.pos
        s = self.read_var_string()
        self.pos = pos
        return s

    def read_var_uint8_array(self) -> bytes:
        length = self.read_var_uint()
        return self.read_bytes(length)

    def read_float32(self) -> float:
        return struct.unpack(">f", self.read_bytes(4))[0]

    def read_float64(self) -> float:
        return struct.unpack(">d", self.read_bytes(8))[0]

    def read_big_int64(self) -> int:
        return struct.unpack(">q", self.read_bytes(8))[0]

    def read_any(self) -> Any:
        tag = self.read_uint8()
        if tag == 127:
            return UNDEFINED
        if tag == 126:
            return None
        if tag == 125:
            return self.read_var_int()
        if tag == 124:
            return self.read_float32()
        if tag == 123:
            return self.read_float64()
        if tag == 122:
            return self.read_big_int64()
        if tag == 121:
            return False
        if tag == 120:
            return True
        if tag == 119:
            return self.read_var_string()
        if tag == 118:
            length = self.read_var_uint()
            return {self.read_var_string(): self.read_any() for _ in range(length)}
        if tag == 117:
            length = self.read_var_uint()
            return [self.read_any() for _ in range(length)]
        if tag == 116:
            return self.read_var_uint8_array()
        raise ValueError(f"unknown Any type tag {tag}")


def json_stringify(value: Any) -> str:
    """JSON.stringify-compatible serialization (used by ContentJSON/Embed/Format)."""
    if value is UNDEFINED:
        return "undefined"
    return json.dumps(value, separators=(",", ":"), ensure_ascii=False)


def json_parse(text: str) -> Any:
    if text == "undefined":
        return UNDEFINED
    return json.loads(text)
