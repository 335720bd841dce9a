"""Versioned wire codec: message dict <-> frame body (the port's copy).

Port of the codec contract of `ray_tpu/_private/wire.py` with another
encoding. The JAX wire encodes a protobuf `Envelope` with a pickled
escape hatch; the port's frames carry plain values only (None, bool,
int, float, str, lists of them and dicts with str keys), so a body is
the sender's wire version as a little-endian u16 followed by the
message as UTF-8 JSON, built from the standard library. A value that
JSON would not round-trip exactly (a tuple, a non-str key, any other
object) is refused at encode time, and nothing a socket sends is ever
unpickled.

Versioning: version = MAJOR*100 + MINOR, as in the JAX wire. A frame
whose MAJOR differs from ours raises WireVersionError before its body
is parsed, so a peer speaking another major is refused at its first
frame. MINOR skew is compatible.
"""
from __future__ import annotations

import json
import struct

WIRE_MAJOR = 1
WIRE_MINOR = 0
WIRE_VERSION = WIRE_MAJOR * 100 + WIRE_MINOR

_HEADER = struct.Struct("<H")
_MAX_DEPTH = 16


class WireVersionError(Exception):
    """Peer speaks an incompatible wire major version."""


def _check_plain(value, depth: int = 0) -> None:
    t = type(value)
    if value is None or t in (bool, int, float, str):
        return
    if depth >= _MAX_DEPTH:
        raise TypeError(f"wire frame nests deeper than {_MAX_DEPTH}")
    if t is list:
        for item in value:
            _check_plain(item, depth + 1)
        return
    if t is dict:
        for key, item in value.items():
            if type(key) is not str:
                raise TypeError(f"wire frame dict key {key!r} is not a str")
            _check_plain(item, depth + 1)
        return
    raise TypeError(f"wire frames carry plain values only, got "
                    f"{t.__name__}")


def dumps(msg: dict) -> bytes:
    """Encode one message (a dict of plain values) as a frame body."""
    if type(msg) is not dict:
        raise TypeError(f"a wire message is a dict, got {type(msg).__name__}")
    _check_plain(msg)
    return _HEADER.pack(WIRE_VERSION) + json.dumps(
        msg, separators=(",", ":"), allow_nan=False).encode()


def loads_ex(data: bytes) -> tuple[dict, int]:
    """Decode a frame body -> (msg, sender wire version); refuses a
    foreign major version before parsing the body, and raises
    ValueError on a body that is not a JSON object."""
    if len(data) < _HEADER.size:
        raise ValueError(f"wire frame of {len(data)} bytes has no header")
    (version,) = _HEADER.unpack_from(data)
    if version // 100 != WIRE_MAJOR:
        raise WireVersionError(
            f"peer wire version {version} is incompatible with ours "
            f"({WIRE_VERSION}): major {version // 100} != {WIRE_MAJOR}")
    msg = json.loads(data[_HEADER.size:])
    if type(msg) is not dict:
        raise ValueError(f"wire frame body is a {type(msg).__name__}, "
                         f"not an object")
    return msg, version
