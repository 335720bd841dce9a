"""Versioned wire codec: message dict <-> protobuf Envelope.

The schema is `ray_tpu_torch/protos/wire.proto` (checked-in generated module
`wire_pb2.py`) — the language-neutral contract for every control-plane
frame, replacing the previous raw-pickle wire (reference parity:
src/ray/protobuf/*.proto define the reference's wire; its TaskSpec
likewise carries pickled function descriptors in `bytes` fields).

Encoding rules (exact round-trip or escape hatch, never lossy):
  * None/bool/int(:int64)/float/str/bytes/list/dict-with-str-keys whose
    size fits the structural bounds encode as typed `Value` nodes.
  * Everything else — task/actor specs, closures, exceptions, tuples,
    subclasses (IntEnum!), oversized collections — rides the `pickled`
    leaf: PLAIN pickle on the fast path (importable object graphs),
    with a tripwire falling back to cloudpickle for anything that
    needs by-value pickling (__main__ / <locals> classes, functions,
    instances — see _FastPickler). Type checks are `type() is`, not
    isinstance, so subclass identity is never silently widened.
  * Bulk collections (> _MAX_ITEMS entries, or nesting deeper than
    _MAX_DEPTH) are pickled wholesale: the structural encoding is for
    control data; the data plane stays a single opaque leaf (state-API
    replies with 100k task events must not pay a Python-loop tax).

Versioning: Envelope.version = MAJOR*100 + MINOR. A frame whose MAJOR
differs from ours raises WireVersionError — the connection is refused
before any field (in particular any pickled leaf) is decoded. MINOR
skew is compatible (proto3 skips unknown fields).

Encoding policy: messages on the language-neutral node plane (agent <->
head registration/heartbeats/events, the object-location + pull
protocol, refcounts, ping) encode field-by-field — a non-Python agent
can speak them. Python-plane messages (task dispatch, replies, nested
submission: their payloads are cloudpickled specs/closures regardless)
put the whole field dict in the flat `py_body` bytes field, keeping
the hot path within ~30% of raw pickle while every frame still carries
the versioned envelope. Structural encode/decode costs ~5µs/leaf in
Python; spending that on a task-plane frame that is ~90% pickled spec
bytes anyway buys nothing.
"""
from __future__ import annotations

import io
import pickle
import struct
from typing import Any, Optional

import cloudpickle

from ray_tpu_torch import native as _native
from ray_tpu_torch._private import wire_pb2 as pb

WIRE_MAJOR = 1
WIRE_MINOR = 8          # 1: BatchFrame coalescing (negotiated by peers)
                        # 2: Envelope trace_id/parent_span (tracing
                        #    plane; old peers skip unknown fields)
                        # 3: delegated scheduling ops (NODE_LEASE_BATCH
                        #    / TASK_DONE_BATCH / lease revoke) + seq-
                        #    numbered heartbeat deltas
                        # 4: METRICS_DUMP cluster scrape (metrics
                        #    plane; no envelope change)
                        # 5: manifest pull protocol + Envelope `raw`
                        #    bulk-payload field (r12 zero-copy object
                        #    transfer) + partial-holder OBJECT_ADDED
                        # 6: wire-channel ops (ch_attach/data/ack/
                        #    close) for compiled-DAG channels (r13; no
                        #    envelope change — CH_DATA reuses `raw`)
                        # 7: NODE_DECREF_DELTA coalesced refcount
                        #    deltas (r16; no envelope change)
                        # 8: direct actor call plane (r18:
                        #    ACTOR_RESOLVE / ACTOR_TASK_DIRECT /
                        #    ACTOR_INFLIGHT_DELTA; no envelope change)
WIRE_VERSION = WIRE_MAJOR * 100 + WIRE_MINOR

# First MINOR that understands a type=="batch" Envelope carrying a
# BatchFrame of sub-frames. Senders check the peer's observed version
# (Connection.peer_wire_version) before emitting one.
BATCH_MIN_MINOR = 1
BATCH_TYPE = "batch"

# First MINOR whose Envelope schema has the trace_id/parent_span
# fields. Unlike BatchFrame these are SKIPPABLE by any proto3 peer
# (unknown fields), so the negotiation only avoids spending bytes on a
# peer that demonstrated an older MINOR (protocol.Connection strips
# the key before encode in that case).
TRACE_MIN_MINOR = 2

# First MINOR that understands the delegated-scheduling ops
# (NODE_LEASE_BATCH, NODE_TASK_DONE_BATCH, NODE_LEASE_REVOKE,
# NODE_FIND_TASK) and seq-numbered heartbeat deltas. Negotiated by
# observation like BatchFrame: senders fall back to the per-task
# protocol until the peer demonstrates MINOR >= 3.
DELEGATE_MIN_MINOR = 3

# First MINOR whose handlers answer a METRICS_DUMP request (r11
# metrics plane). An older peer would silently drop the unknown type
# and the collector's shared deadline would burn waiting on a reply
# that can never come, so the head only fans to proven peers.
METRICS_MIN_MINOR = 4

# First MINOR that understands the r12 manifest pull protocol: the
# Envelope `raw` bulk-payload field and partial-holder OBJECT_ADDED
# entries. The transfer itself negotiates per message (the puller asks
# for a manifest; an old holder ignores the unknown request key and
# serves the blob protocol — the reply shape IS the answer), so this
# constant only gates the one message an OLD receiver would
# misinterpret rather than ignore: an agent reports partial-holder
# registrations to the head only when the head demonstrated MINOR >= 5
# (an old head would record a full location for a half-landed copy).
MANIFEST_MIN_MINOR = 5

# First MINOR whose handlers speak the r13 wire-channel transport
# (experimental/wire_channel.py: CH_ATTACH/CH_DATA/CH_ACK/CH_CLOSE).
# The endpoints are new code on both sides by construction (a reader
# dials the writer's per-channel listener), so the constant gates the
# one thing an OLD peer could misread rather than ignore: a CH_DATA
# frame whose tensor rides the Envelope `raw` field. The writer emits
# raw-payload frames only toward a peer that demonstrated MINOR >= 6
# on its attach frame and falls back to the pickled body otherwise —
# negotiated by observation, the BatchFrame discipline.
CHANNEL_MIN_MINOR = 6

# First MINOR whose handlers understand a NODE_DECREF_DELTA frame
# (r16 batched decref deltas). An OLD head would silently drop the
# unknown type — every release in the frame would leak for the
# session — so agents coalesce deltas only toward a head that
# demonstrated MINOR >= 7 and fall back to forwarding the workers'
# DECREF_BATCH frames otherwise (negotiated by observation, the
# BatchFrame discipline).
DECREF_DELTA_MIN_MINOR = 7

# First MINOR whose handlers speak the direct actor call plane (r18):
# ACTOR_RESOLVE endpoint lookups, peer-dialed ACTOR_TASK_DIRECT
# submissions with inline replies, and coalesced ACTOR_INFLIGHT_DELTA
# mirror frames. An OLD peer would silently drop every one of them —
# a resolve or direct call toward it would hang its caller's future
# until the stall fallback — so callers go direct only toward peers
# that demonstrated MINOR >= 8 and stay on the head-routed actor path
# otherwise (negotiated by observation, the BatchFrame discipline).
DIRECT_ACTOR_MIN_MINOR = 8

# Message-dict carrier for the Envelope `raw` field. On encode the
# value is a LIST of buffer objects (bytes/memoryview — mapped shm
# spans) concatenated into the field by the scatter-gather emit with
# zero copies; on decode the receiver sees ONE zero-copy memoryview of
# the whole field (C parser; the protobuf fallback hands over bytes).
# Never pickled into py_body.
RAW_KEY = "_raw"

# Message-dict carrier for the Envelope trace fields: senders attach
# msg["_trace"] = (trace_id, parent_span); codecs move it between the
# dict and the proto fields so it never rides the pickled body. The
# constant lives with the tracing plane (which owns stamp()/recv_t0());
# re-exported here for the codec/protocol layer.
from ray_tpu_torch._private.tracing_plane import TRACE_KEY  # noqa: E402

_MAX_ITEMS = 64      # larger lists/dicts -> one pickled leaf
_MAX_DEPTH = 6
_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


class WireVersionError(Exception):
    """Peer speaks an incompatible wire major version."""


# Message types that encode field-by-field (the language-neutral set:
# everything a non-Python node agent / object-transfer peer needs).
# Kept in sync with protocol.py constants; anything else rides `__py__`.
STRUCTURAL_TYPES = frozenset({
    "register", "ping", "decref", "addref", "decref_batch",
    "node_decref_delta",
    "node_register", "node_heartbeat", "node_event",
    "node_kill_worker", "node_delete_object", "node_shutdown",
    "node_hb_resync",
    "object_lookup", "pull_object", "pull_chunk",
    "locate_object", "object_added", "object_removed", "bcast_plan",
})


class _NeedCloudpickle(Exception):
    """Raised mid-pickle when an object graph needs cloudpickle."""


class _FastPickler(pickle.Pickler):
    """Plain pickle with a tripwire: most control-plane messages are
    specs/dicts of importable types, which plain pickle serializes in
    ~1/6 the time of cloudpickle's reducer machinery. But plain pickle
    saves __main__ / <locals> objects BY REFERENCE — "successfully"
    producing bytes the receiving process cannot load. CPython calls
    reducer_override for every non-primitive object being saved
    (classes, functions, AND instances / global-name-pickled objects
    like a __main__ TypeVar), so any graph that needs cloudpickle's
    by-value pickling trips the wire and the whole message falls back
    to cloudpickle."""

    def reducer_override(self, obj):
        mod = getattr(obj, "__module__", None)
        if mod == "__main__" or "<locals>" in getattr(
                obj, "__qualname__", ""):
            raise _NeedCloudpickle
        if mod is None and (isinstance(obj, type) or callable(obj)):
            raise _NeedCloudpickle
        return NotImplemented


def _pickle(obj: Any) -> bytes:
    buf = io.BytesIO()
    try:
        _FastPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
        return buf.getvalue()
    except (_NeedCloudpickle, TypeError, AttributeError,
            pickle.PicklingError):
        buf = io.BytesIO()
        cloudpickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
        return buf.getvalue()


def _encode_value(obj: Any, v: pb.Value, depth: int) -> None:
    t = type(obj)
    if obj is None:
        v.null = True
    elif t is bool:
        v.b = obj
    elif t is int and _INT64_MIN <= obj <= _INT64_MAX:
        v.i = obj
    elif t is float:
        v.d = obj
    elif t is str:
        v.s = obj
    elif t is bytes:
        v.data = obj
    elif t is list and len(obj) <= _MAX_ITEMS and depth < _MAX_DEPTH:
        lv = v.list
        lv.SetInParent()                 # presence even when empty
        for item in obj:
            _encode_value(item, lv.items.add(), depth + 1)
    elif (t is dict and len(obj) <= _MAX_ITEMS and depth < _MAX_DEPTH
          and all(type(k) is str for k in obj)):
        sv = v.struct
        sv.SetInParent()                 # presence even when empty
        for k, item in obj.items():
            _encode_value(item, sv.fields[k], depth + 1)
    else:
        v.pickled = _pickle(obj)


def _decode_value(v: pb.Value) -> Any:
    kind = v.WhichOneof("kind")
    if kind == "null":
        return None
    if kind == "b":
        return v.b
    if kind == "i":
        return v.i
    if kind == "d":
        return v.d
    if kind == "s":
        return v.s
    if kind == "data":
        return v.data
    if kind == "list":
        return [_decode_value(item) for item in v.list.items]
    if kind == "struct":
        return {k: _decode_value(item)
                for k, item in v.struct.fields.items()}
    if kind == "pickled":
        return pickle.loads(v.pickled)
    return None                          # unset Value (future kinds)


def _fill_envelope(env: "pb.Envelope", msg: dict) -> None:
    mtype = msg.get("type", "")
    env.version = WIRE_VERSION
    env.type = mtype
    env.rid = msg.get("rid", 0)
    tr = msg.get(TRACE_KEY)
    if tr is not None:
        env.trace_id = tr[0]
        env.parent_span = tr[1]
    raw = msg.get(RAW_KEY)
    if raw is not None:
        # fallback codec: the field is joined (one copy); the scatter-
        # gather emit path (encode_frame_parts) is the zero-copy one
        env.raw = b"".join(raw)
    if mtype in STRUCTURAL_TYPES:
        fields = env.fields
        fields.SetInParent()
        for k, val in msg.items():
            if k == "type" or k == "rid" or k == TRACE_KEY:
                continue
            _encode_value(val, fields.fields[k], 0)
    else:
        rest = {k: v for k, v in msg.items()
                if k != "type" and k != "rid" and k != TRACE_KEY
                and k != RAW_KEY}
        if rest:
            env.py_body = _pickle(rest)


# ---- native codec fast path (r7) ----
# The hot Envelope shape — Python-plane header + opaque py_body, and
# BatchFrame assembly/splitting — can encode and decode through
# native/core.c: no protobuf message objects on the per-frame path.
# Whether that wins depends on the installed protobuf backend: against
# the pure-Python backend the C codec is ~3x; against upb/C++ the
# per-frame ctypes call overhead LOSES to protobuf's own C serializer,
# so 'auto' picks the C codec only on pure-Python-protobuf hosts
# (wire_native_codec forces either way). The structural plane
# (node-neutral field-by-field Values) and anything the C parser flags
# as irregular always stay on the real protobuf codec, which remains
# the arbiter of malformed input.

_pb_pure_python: Optional[bool] = None
_codec_memo: tuple = (-1, None)

# Pickled bodies at least this large always ride the scatter-gather
# emit (C header + body as separate iovecs): the join/serialize copy
# they'd otherwise pay dwarfs a ctypes call. Small bodies only do when
# the C codec is selected.
_ZEROCOPY_MIN_BODY = 16 * 1024


def _native_codec():
    """The native module when the C envelope codec should be used for
    dumps/loads, else None. Memoized per CONFIG generation (this runs
    per frame); flip modes in-process with env var + CONFIG.reload()."""
    global _codec_memo, _pb_pure_python
    if not _native.frame_engine_enabled():
        return None
    from ray_tpu_torch._private.config import CONFIG
    gen = CONFIG._gen
    memo = _codec_memo
    if memo[0] == gen:
        return memo[1]
    mode = str(CONFIG.wire_native_codec).strip().lower()
    if mode in ("auto", ""):
        if _pb_pure_python is None:
            from google.protobuf.internal import api_implementation
            _pb_pure_python = api_implementation.Type() == "python"
        on = _pb_pure_python
    else:
        on = mode in ("1", "true", "yes", "on")
    eng = _native if on else None
    _codec_memo = (gen, eng)
    return eng


_FIXED64 = struct.Struct("<Q")


def _trace_tail(tr) -> bytes:
    """Protobuf bytes for the Envelope trace fields (field 7/8,
    fixed64) — appended after the py_body field, which matches the
    canonical ascending-field-number serialization exactly, so the C
    emit paths stay byte-identical to the protobuf codec. Zero values
    are omitted like proto3 does."""
    out = b""
    if tr[0]:
        out += b"\x39" + _FIXED64.pack(tr[0])
    if tr[1]:
        out += b"\x41" + _FIXED64.pack(tr[1])
    return out


def _raw_prefix(raw) -> bytes:
    """Key + length varint for the Envelope `raw` field (field 9,
    length-delimited, tag 0x4a) — the field's payload buffers follow
    as their own iovecs on the scatter-gather emit. Canonical position:
    after py_body (5) and the trace fixed64s (7/8)."""
    return b"\x4a" + _pb_varint(sum(len(b) for b in raw))


def _encode_one(msg: dict, eng=None) -> bytes:
    """Serialize ONE message to Envelope bytes (never a batch)."""
    mtype = msg.get("type", "")
    if eng is None:
        eng = _native_codec()
    if eng is not None and mtype not in STRUCTURAL_TYPES:
        rest = {k: v for k, v in msg.items()
                if k != "type" and k != "rid" and k != TRACE_KEY
                and k != RAW_KEY}
        body = _pickle(rest) if rest else b""
        data = eng.env_encode(WIRE_VERSION, mtype.encode(),
                              msg.get("rid", 0), body)
        tr = msg.get(TRACE_KEY)
        if tr is not None:
            data += _trace_tail(tr)
        raw = msg.get(RAW_KEY)
        if raw is not None:
            data += _raw_prefix(raw) + b"".join(raw)
        return data
    env = pb.Envelope()
    _fill_envelope(env, msg)
    return env.SerializeToString()


def dumps(msg: dict) -> bytes:
    """Encode a message dict as a versioned Envelope frame body."""
    if msg.get("type") == BATCH_TYPE:
        return dumps_batch(msg["frames"])
    return _encode_one(msg)


def dumps_batch(msgs: list[dict]) -> bytes:
    """Encode N message dicts as ONE BatchFrame envelope: one frame on
    the wire, N sub-frames delivered in order at the receiver. Only
    valid toward a peer that negotiated batch support (MINOR >= 1).
    The native assembly is used only when every sub-frame is Python-
    plane: structural sub-frames would each pay a separate protobuf
    serialize, where the one-shot protobuf batch encode amortizes."""
    eng = _native_codec()
    if eng is not None and all(
            m.get("type", "") not in STRUCTURAL_TYPES for m in msgs):
        subs = [_encode_one(m, eng) for m in msgs]
        return eng.batch_encode(WIRE_VERSION, BATCH_TYPE.encode(), subs)
    env = pb.Envelope(version=WIRE_VERSION, type=BATCH_TYPE)
    batch = env.batch
    batch.SetInParent()
    for msg in msgs:
        _fill_envelope(batch.frames.add(), msg)
    return env.SerializeToString()


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def encode_frame_parts(msg: dict, eng=None) -> list[bytes]:
    """ONE frame's Envelope bytes as a buffer list for scatter-gather
    emit (protocol._emit_locked -> sendmsg): [C-encoded header, pickled
    body] when the C codec is selected or the body clears the
    zero-copy threshold — the body bytes then go from the pickler to
    the kernel without ever being copied into a joined frame. A
    RAW_KEY message additionally carries its buffer list as trailing
    iovecs (the Envelope `raw` field): mapped shm spans go
    mapping -> kernel with zero Python copies. Structural/batch/other
    frames collapse to [dumps(msg)]. The buffer-list concatenation is
    byte-identical to dumps(msg)."""
    if eng is None:
        eng = _native_codec()
    mtype = msg.get("type", "")
    if mtype in STRUCTURAL_TYPES or mtype == BATCH_TYPE:
        return [dumps(msg)]
    tr = msg.get(TRACE_KEY)
    tail = _trace_tail(tr) if tr is not None else b""
    raw = msg.get(RAW_KEY)
    raw_len = sum(len(b) for b in raw) if raw is not None else 0
    rest = {k: v for k, v in msg.items()
            if k != "type" and k != "rid" and k != TRACE_KEY
            and k != RAW_KEY}
    if not rest and raw is None:
        return [dumps(msg)] if eng is None else [
            eng.env_encode_header(WIRE_VERSION, mtype.encode(),
                                  msg.get("rid", 0), 0, 0) + tail]
    body = _pickle(rest) if rest else b""
    zero_copy = (eng is not None
                 or ((len(body) >= _ZEROCOPY_MIN_BODY
                      or raw_len >= _ZEROCOPY_MIN_BODY)
                     and _native.frame_engine_enabled()))
    if not zero_copy:
        env = pb.Envelope()                   # protobuf codec, body
        env.version = WIRE_VERSION            # already pickled above
        env.type = mtype
        env.rid = msg.get("rid", 0)
        if body:
            env.py_body = body
        if tr is not None:
            env.trace_id = tr[0]
            env.parent_span = tr[1]
        if raw is not None:
            env.raw = b"".join(raw)
        return [env.SerializeToString()]
    hdr = _native.env_encode_header(WIRE_VERSION, mtype.encode(),
                                    msg.get("rid", 0),
                                    0x2A if body else 0, len(body))
    parts = [hdr, body] if body else [hdr]
    if tail:
        parts.append(tail)
    if raw is not None:
        parts.append(_raw_prefix(raw))
        parts.extend(raw)
    return parts


def encode_batch_parts(msgs: list[dict], eng=None) -> list[bytes]:
    """One BatchFrame envelope as a buffer list for scatter-gather
    emit: outer header + per-sub (frame-key prefix, sub buffers...).
    Byte-stream-identical to dumps_batch(msgs). Only used with the C
    codec selected — per-sub protobuf serializes would lose to the
    one-shot protobuf batch encode."""
    if eng is None:
        eng = _native_codec()
    if eng is None:
        return [dumps_batch(msgs)]
    parts: list[bytes] = []
    inner = 0
    for m in msgs:
        sub = encode_frame_parts(m, eng)
        sub_len = sum(len(p) for p in sub)
        pre = b"\x0a" + _pb_varint(sub_len)     # BatchFrame.frames key
        parts.append(pre)
        parts.extend(sub)
        inner += len(pre) + sub_len
    hdr = eng.env_encode_header(WIRE_VERSION, BATCH_TYPE.encode(), 0,
                                0x32, inner)
    return [hdr, *parts]


def _decode_envelope(env: "pb.Envelope") -> dict:
    if env.py_body:
        msg = pickle.loads(env.py_body)
    else:
        msg = {k: _decode_value(v)
               for k, v in env.fields.fields.items()}
    msg["type"] = env.type
    if env.rid:
        msg["rid"] = env.rid
    if env.trace_id or env.parent_span:
        msg[TRACE_KEY] = (env.trace_id, env.parent_span)
    if env.raw:
        msg[RAW_KEY] = env.raw
    return msg


def _native_decode_one(eng, data: bytes) -> Optional[dict]:
    """Decode ONE (non-batch-dispatching) envelope via the C parser.
    Returns None when the frame needs the full protobuf codec: a
    structural-plane frame (non-empty `fields`), invalid UTF-8 in
    `type`, or anything the fast parser flags as irregular."""
    view = eng.env_decode(data)
    if view is None:
        return None
    (_, rid, tbytes, body, fields_len, _, _, trace_id, parent_span,
     raw) = view
    if body:
        msg = pickle.loads(body)
    elif fields_len > 0:
        return None                  # structural plane: protobuf path
    else:
        msg = {}
    try:
        msg["type"] = tbytes.decode()
    except UnicodeDecodeError:
        return None
    if rid:
        msg["rid"] = rid
    if trace_id or parent_span:
        msg[TRACE_KEY] = (trace_id, parent_span)
    if raw is not None:
        msg[RAW_KEY] = raw
    return msg


def _native_loads_ex(eng, data: bytes) -> Optional[tuple[dict, int]]:
    """Native-codec mirror of loads_ex; None defers to protobuf."""
    view = eng.env_decode(data)
    if view is None:
        return None
    (version, rid, tbytes, body, fields_len, batch_off, batch_len,
     trace_id, parent_span, raw) = view
    if version // 100 != WIRE_MAJOR:
        raise WireVersionError(
            f"peer wire version {version} is incompatible with "
            f"ours ({WIRE_VERSION}): major "
            f"{version // 100} != {WIRE_MAJOR}")
    try:
        mtype = tbytes.decode()
    except UnicodeDecodeError:
        return None
    if mtype == BATCH_TYPE:
        frames: list[dict] = []
        if batch_off >= 0:
            spans = eng.batch_split(data, batch_off, batch_len)
            if spans is None:
                return None
            for off, length in spans:
                sub = _native_decode_one(eng, data[off:off + length])
                if sub is None:
                    # mixed batch (structural sub-frame): decode that
                    # sub with the real protobuf parser
                    sub = _decode_envelope(pb.Envelope.FromString(
                        data[off:off + length]))
                frames.append(sub)
        return {"type": BATCH_TYPE, "frames": frames}, version
    if body:
        msg = pickle.loads(body)
    elif fields_len > 0:
        return None                  # structural plane: protobuf path
    else:
        msg = {}
    msg["type"] = mtype
    if rid:
        msg["rid"] = rid
    if trace_id or parent_span:
        msg[TRACE_KEY] = (trace_id, parent_span)
    if raw is not None:
        msg[RAW_KEY] = raw
    return msg, version


def loads_ex(data: bytes) -> tuple[dict, int]:
    """Decode an Envelope frame body -> (msg, sender wire version);
    refuses foreign major versions before touching any pickled leaf.
    A type=="batch" envelope decodes to
    {"type": "batch", "frames": [msg, ...]} preserving sub-frame
    order."""
    eng = _native_codec()
    if (eng is None and len(data) >= _ZEROCOPY_MIN_BODY
            and _native.frame_engine_enabled()):
        # Large frames always take the C parser + zero-copy body view,
        # codec mode notwithstanding — the decode mirror of the
        # >=_ZEROCOPY_MIN_BODY emit rule: protobuf's FromString copies
        # a multi-MB py_body (pull chunks!) just to hand it to pickle.
        eng = _native
    if eng is not None:
        out = _native_loads_ex(eng, data)
        if out is not None:
            return out
    env = pb.Envelope.FromString(data)
    if env.version // 100 != WIRE_MAJOR:
        raise WireVersionError(
            f"peer wire version {env.version} is incompatible with "
            f"ours ({WIRE_VERSION}): major "
            f"{env.version // 100} != {WIRE_MAJOR}")
    if env.type == BATCH_TYPE:
        return ({"type": BATCH_TYPE,
                 "frames": [_decode_envelope(sub)
                            for sub in env.batch.frames]},
                env.version)
    return _decode_envelope(env), env.version


def loads(data: bytes) -> dict:
    return loads_ex(data)[0]
