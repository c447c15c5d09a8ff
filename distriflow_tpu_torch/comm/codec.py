"""Port of ``distriflow_tpu/comm/codec.py`` (copied with its imports rewritten).

Binary message codec: tag-length-value encoding for protocol messages.

The role socket.io's packet encoding plays in the reference (binary
ArrayBuffer mode + JSON event payloads, ``src/common/utils.ts:86-101``):
protocol messages are plain dicts of JSON-able values *plus raw bytes*
(packed tensor buffers), and this codec round-trips them without base64
inflation or external dependencies.

Supported value types: None, bool, int, float, str, bytes, list, dict
(str keys). Ints are 64-bit signed; floats are IEEE double.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any


def checksum(payload: bytes) -> int:
    """CRC32 of a frame payload (unsigned 32-bit), the integrity check the
    transport stamps into every frame header: a flipped wire byte surfaces
    as :class:`distriflow_tpu_torch.comm.transport.FrameCorruptionError` instead
    of decoding garbage into a protocol message."""
    return zlib.crc32(payload) & 0xFFFFFFFF

# type tags
_NONE = b"N"
_TRUE = b"T"
_FALSE = b"F"
_INT = b"i"
_FLOAT = b"f"
_STR = b"s"
_BYTES = b"b"
_LIST = b"l"
_DICT = b"d"


class CodecError(ValueError):
    pass


def _encode_into(value: Any, out: list) -> None:
    if value is None:
        out.append(_NONE)
    elif value is True:
        out.append(_TRUE)
    elif value is False:
        out.append(_FALSE)
    elif isinstance(value, int):
        out.append(_INT + struct.pack("<q", value))
    elif isinstance(value, float):
        out.append(_FLOAT + struct.pack("<d", value))
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out.append(_STR + struct.pack("<I", len(raw)) + raw)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        out.append(_BYTES + struct.pack("<Q", len(raw)) + raw)
    elif isinstance(value, (list, tuple)):
        out.append(_LIST + struct.pack("<I", len(value)))
        for item in value:
            _encode_into(item, out)
    elif isinstance(value, dict):
        out.append(_DICT + struct.pack("<I", len(value)))
        for k, v in value.items():
            if not isinstance(k, str):
                raise CodecError(f"dict keys must be str, got {type(k)}")
            raw = k.encode("utf-8")
            out.append(struct.pack("<I", len(raw)) + raw)
            _encode_into(v, out)
    else:
        raise CodecError(f"cannot encode value of type {type(value)}")


def encode(value: Any) -> bytes:
    out: list = []
    _encode_into(value, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise CodecError("truncated message")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out


def _decode_from(r: _Reader) -> Any:
    tag = r.take(1)
    if tag == _NONE:
        return None
    if tag == _TRUE:
        return True
    if tag == _FALSE:
        return False
    if tag == _INT:
        return struct.unpack("<q", r.take(8))[0]
    if tag == _FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _STR:
        (n,) = struct.unpack("<I", r.take(4))
        return r.take(n).decode("utf-8")
    if tag == _BYTES:
        (n,) = struct.unpack("<Q", r.take(8))
        return r.take(n)
    if tag == _LIST:
        (n,) = struct.unpack("<I", r.take(4))
        return [_decode_from(r) for _ in range(n)]
    if tag == _DICT:
        (n,) = struct.unpack("<I", r.take(4))
        out = {}
        for _ in range(n):
            (klen,) = struct.unpack("<I", r.take(4))
            key = r.take(klen).decode("utf-8")
            out[key] = _decode_from(r)
        return out
    raise CodecError(f"unknown type tag {tag!r}")


def decode(buf: bytes) -> Any:
    r = _Reader(buf)
    value = _decode_from(r)
    if r.pos != len(buf):
        raise CodecError(f"trailing garbage: {len(buf) - r.pos} bytes")
    return value
