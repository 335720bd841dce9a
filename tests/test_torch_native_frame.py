"""The twin of `tests/test_native_frame.py`, test for test, run on the
port's copy of the frame engine (`ray_tpu_torch/native/core.c`,
`ray_tpu_torch/_private/{protocol,wire}.py`). The wire channels of
`ray_tpu_torch/experimental/` ride these frames' `raw` field.

Frame-engine tests: the r7 wire hot path in native/core.c — the
GIL-released read pump, scatter-gather writev flush, and the Envelope
codec fast path — and behavioral parity with the pure-Python fallback
(RAY_TPU_WIRE_NATIVE=0).

Connection-level tests are parametrized over both engines: torn frames
(1-byte dribble), EINTR during a blocked read, oversized-length
rejection, and BatchFrame envelopes split across reads must behave
identically. C-unit tests (bottom) pin the codec's protobuf wire
format against the real protobuf library.
"""
import os
import signal
import socket
import struct
import threading
import time

import pytest

from ray_tpu_torch import native
from ray_tpu_torch._private import protocol, wire
from ray_tpu_torch._private import wire_pb2 as pb
from ray_tpu_torch._private.config import CONFIG

_LEN = struct.Struct("<Q")


@pytest.fixture(params=["native", "python"])
def wire_engine_mode(request):
    """The conftest fixture of the same name on the port: run a test
    under both of the port's wire engines, re-reading the port's CONFIG."""
    if request.param == "native" and not native.available():
        pytest.skip("no C compiler: native frame engine unavailable")
    prev = {k: os.environ.get(k) for k in
            ("RAY_TPU_WIRE_NATIVE", "RAY_TPU_WIRE_NATIVE_CODEC")}
    if request.param == "native":
        os.environ["RAY_TPU_WIRE_NATIVE"] = "1"
        os.environ["RAY_TPU_WIRE_NATIVE_CODEC"] = "1"
    else:
        os.environ["RAY_TPU_WIRE_NATIVE"] = "0"
    CONFIG.reload()
    try:
        yield request.param
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        CONFIG.reload()


# Connection-level tests take the `wire_engine_mode` fixture above
# (native / python params) as an argument.

def _pair(handler):
    """(client Connection, server Connection, listener) over loopback."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    box = {}

    def accept():
        s, _ = lsock.accept()
        c = protocol.Connection(s, handler, server=True)
        box["server"] = c
        c.start()

    t = threading.Thread(target=accept, daemon=True)
    t.start()
    conn = protocol.connect(
        ("127.0.0.1", lsock.getsockname()[1]), lambda c, m: None)
    t.join(5)
    return conn, box["server"], lsock


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    assert cond()


# --------------------------------------------- reassembly behavior
def test_torn_frames_one_byte_dribble(wire_engine_mode):
    got = []
    conn, server, lsock = _pair(lambda c, m: got.append(m))
    try:
        data = wire.dumps({"type": "ping", "x": 42})
        raw = _LEN.pack(len(data)) + data
        for b in raw:
            conn._sock.sendall(bytes([b]))
            time.sleep(0.001)
        _wait(lambda: len(got) == 1)
        assert got[0]["x"] == 42
    finally:
        conn.close()
        lsock.close()


def test_many_frames_in_one_write(wire_engine_mode):
    got = []
    conn, server, lsock = _pair(lambda c, m: got.append(m))
    try:
        raw = b""
        for i in range(50):
            data = wire.dumps({"type": "ping", "i": i})
            raw += _LEN.pack(len(data)) + data
        conn._sock.sendall(raw)
        _wait(lambda: len(got) == 50)
        assert [m["i"] for m in got] == list(range(50))
    finally:
        conn.close()
        lsock.close()


def test_batch_frame_split_across_reads(wire_engine_mode):
    """A BatchFrame envelope dribbled in 7-byte chunks reassembles and
    delivers its sub-frames in order."""
    got = []
    conn, server, lsock = _pair(lambda c, m: got.append(m))
    try:
        msgs = ([{"type": "decref", "object_id": f"o{i:017d}"}
                 for i in range(8)]
                + [{"type": "task_done", "task_id": "t1", "ok": True}])
        data = wire.dumps_batch(msgs)
        raw = _LEN.pack(len(data)) + data
        for i in range(0, len(raw), 7):
            conn._sock.sendall(raw[i:i + 7])
            time.sleep(0.001)
        _wait(lambda: len(got) == len(msgs))
        assert got == msgs                     # order + content intact
    finally:
        conn.close()
        lsock.close()


def test_oversized_length_rejected(wire_engine_mode):
    """A corrupt length prefix (here: 1 TiB) kills the connection
    before any allocation attempt; nothing reaches the handler."""
    got = []
    conn, server, lsock = _pair(lambda c, m: got.append(m))
    try:
        conn._sock.sendall(_LEN.pack(1 << 40))
        _wait(lambda: server.closed)
        assert got == []
    finally:
        conn.close()
        lsock.close()


def test_oversized_bound_is_configurable(wire_engine_mode):
    """wire_max_frame_bytes is enforced, not a hardcoded constant: a
    frame over a small custom bound dies, one under it passes."""
    os.environ["RAY_TPU_WIRE_MAX_FRAME_BYTES"] = "4096"
    CONFIG.reload()
    got = []
    try:
        conn, server, lsock = _pair(lambda c, m: got.append(m))
        try:
            conn.send({"type": "ping", "pad": b"x" * 512})   # under
            _wait(lambda: len(got) == 1)
            data = wire.dumps({"type": "ping", "pad": b"x" * 8192})
            conn._sock.sendall(_LEN.pack(len(data)) + data)  # over
            _wait(lambda: server.closed)
            assert len(got) == 1
        finally:
            conn.close()
            lsock.close()
    finally:
        os.environ.pop("RAY_TPU_WIRE_MAX_FRAME_BYTES", None)
        CONFIG.reload()


def test_reader_survives_eintr(wire_engine_mode):
    """Signals delivered to the reader thread while it is blocked in
    read(2)/recv interrupt the syscall with EINTR; the pump must retry,
    not die, and later frames must arrive intact."""
    got = []
    conn, server, lsock = _pair(lambda c, m: got.append(m))
    prev = signal.signal(signal.SIGUSR1, lambda *_: None)
    try:
        time.sleep(0.2)              # let the server reader block
        assert server._reader.ident is not None
        for _ in range(25):
            signal.pthread_kill(server._reader.ident, signal.SIGUSR1)
            time.sleep(0.004)
        conn.send({"type": "ping", "x": 7})
        _wait(lambda: len(got) == 1)
        assert got[0]["x"] == 7
        assert not server.closed
    finally:
        signal.signal(signal.SIGUSR1, prev)
        conn.close()
        lsock.close()


# ------------------------------------------------- write-side paths
def test_large_frame_roundtrip(wire_engine_mode):
    """8 MB body: exercises partial writev progress on the sender and
    reassembly-buffer growth on the reader."""
    conn, server, lsock = _pair(
        lambda c, m: c.reply(m, echo=len(m["blob"])))
    try:
        rep = conn.request({"type": "ping", "blob": b"z" * (8 << 20)},
                           timeout=30)
        assert rep["echo"] == 8 << 20
    finally:
        conn.close()
        lsock.close()


@pytest.mark.skipif(not native.available(), reason="no C compiler")
def test_writev_all_raw_fd():
    """The raw-fd C writev primitive (partial writes, EINTR, IOV_MAX
    chunking handled in C): every byte of 1500 buffers lands, in
    order. protocol uses sock.sendmsg for fd-lifetime safety; this
    covers the exported raw-fd path (pipes, tools)."""
    a, b = socket.socketpair()
    bufs = [bytes([i & 0xFF]) * ((i % 37) + 1) for i in range(1500)]
    want = b"".join(bufs)
    got = bytearray()

    def drain():
        while len(got) < len(want):
            chunk = b.recv(65536)
            if not chunk:
                return
            got.extend(chunk)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    try:
        native.writev_all(a.fileno(), bufs)
        t.join(10)
        assert bytes(got) == want
    finally:
        a.close()
        b.close()


def test_flush_of_many_frames_exceeding_iov_max(wire_engine_mode):
    """One emit of 700 frames = 1400 iovecs, past the 1024 IOV_MAX
    chunk: the flush loop must write every byte across chunks."""
    got = []
    conn, server, lsock = _pair(lambda c, m: got.append(m))
    try:
        frames = [{"type": "ping", "i": i} for i in range(700)]
        with conn._send_lock:
            conn._emit_locked(frames)      # peer version unseen: no batch
        _wait(lambda: len(got) == 700, timeout=10)
        assert [m["i"] for m in got] == list(range(700))
    finally:
        conn.close()
        lsock.close()


# --------------------------------------- C codec vs protobuf parity
pytestmark_native = pytest.mark.skipif(
    not native.available(),
    reason="no C compiler on this host (pure-Python fallbacks active)")


@pytestmark_native
def test_env_encode_matches_protobuf_bytes():
    body = b"\x80\x02}q\x00."
    for rid in (0, 1, 127, 128, 300, (1 << 63) + 11, (1 << 64) - 1):
        mine = native.env_encode(wire.WIRE_VERSION, b"task_done",
                                 rid, body)
        env = pb.Envelope(version=wire.WIRE_VERSION, type="task_done",
                          rid=rid, py_body=body)
        assert mine == env.SerializeToString(), rid


@pytestmark_native
def test_env_decode_views():
    env = pb.Envelope(version=101, type="task", rid=9,
                      py_body=b"PAYLOAD")
    view = native.env_decode(env.SerializeToString())
    (version, rid, mtype, body, fields_len, batch_off, batch_len,
     trace_id, parent_span, raw) = view
    assert (version, rid, mtype, body) == (101, 9, b"task", b"PAYLOAD")
    assert fields_len == -1 and batch_off == -1
    assert trace_id == 0 and parent_span == 0
    assert raw is None


@pytestmark_native
def test_env_decode_raw_field():
    """r12 zero-copy object plane: the C parser hands the Envelope
    `raw` bulk payload back as a zero-copy view, byte-compatibly with
    protobuf's encoding, alongside py_body and the trace fields."""
    import pickle
    body = pickle.dumps({"ok": 1})
    env = pb.Envelope(version=105, type="reply", rid=4,
                      py_body=body, trace_id=7, raw=b"RAWPAYLOAD")
    data = env.SerializeToString()
    view = native.env_decode(data)
    assert view is not None
    raw = view[9]
    assert isinstance(raw, memoryview) and bytes(raw) == b"RAWPAYLOAD"
    assert bytes(view[3]) == body and view[7] == 7
    # the wire codec surfaces it under RAW_KEY on every decode path
    msg, ver = wire.loads_ex(data)
    assert bytes(msg[wire.RAW_KEY]) == b"RAWPAYLOAD"
    # and the scatter-gather emit is byte-identical to protobuf
    parts = wire.encode_frame_parts(
        {"type": "reply", "rid": 4, "_trace": (7, 0),
         wire.RAW_KEY: [b"RAW", memoryview(b"PAYLOAD")]})
    env2 = pb.Envelope(version=wire.WIRE_VERSION, type="reply", rid=4,
                       trace_id=7, raw=b"RAWPAYLOAD")
    assert b"".join(parts) == env2.SerializeToString()


@pytestmark_native
def test_env_decode_trace_fields():
    """r9 tracing plane: the C parser captures the Envelope's fixed64
    trace fields, byte-compatibly with protobuf's encoding."""
    env = pb.Envelope(version=102, type="task", rid=4,
                      py_body=b"B", trace_id=(1 << 62) + 5,
                      parent_span=77)
    view = native.env_decode(env.SerializeToString())
    assert view is not None
    assert view[7] == (1 << 62) + 5 and view[8] == 77


@pytestmark_native
def test_env_decode_skips_unknown_fields():
    """MINOR-skew compatibility: fields this codec has never heard of
    (varint + length-delimited) are skipped, like proto3 requires."""
    base = native.env_encode(wire.WIRE_VERSION, b"ping", 3, b"")
    extended = base + b"\x38\x05" + b"\x7a\x03abc"   # field 7, field 15
    view = native.env_decode(extended)
    assert view is not None and view[2] == b"ping" and view[1] == 3
    # the real parser agrees
    assert pb.Envelope.FromString(extended).type == "ping"
    msg, ver = wire.loads_ex(extended)
    assert msg == {"type": "ping", "rid": 3} and ver == wire.WIRE_VERSION


@pytestmark_native
def test_env_decode_version_varint_truncates_like_protobuf():
    blob = bytearray()
    v = (1 << 40) + wire.WIRE_VERSION        # overlong uint32 varint
    blob += b"\x08"
    while v >= 0x80:
        blob.append((v & 0x7F) | 0x80)
        v >>= 7
    blob.append(v)
    blob += b"\x12\x04ping"
    assert (native.env_decode(bytes(blob))[0]
            == pb.Envelope.FromString(bytes(blob)).version)


@pytestmark_native
def test_duplicate_submessage_fields_defer_to_protobuf():
    """Duplicate py_body fields have last-wins protobuf semantics; the
    fast parser refuses them and wire falls back to the real codec, so
    both engines decode identically."""
    import pickle
    one = pickle.dumps({"x": 1})
    two = pickle.dumps({"x": 2})
    blob = (native.env_encode(wire.WIRE_VERSION, b"ping", 0, one)
            + b"\x2a" + bytes([len(two)]) + two)
    assert native.env_decode(blob) is None
    assert pb.Envelope.FromString(blob).py_body == two   # last wins
    assert wire.loads(blob)["x"] == 2


@pytestmark_native
def test_batch_split_grows_past_initial_capacity():
    """A 300-sub-frame batch exceeds the splitter's first-pass array
    (128): the re-call path must return every sub-frame."""
    msgs = [{"type": "ping", "i": i} for i in range(300)]
    blob = wire.dumps_batch(msgs)
    out, _ = wire.loads_ex(blob)
    assert out["frames"] == msgs


def test_malformed_bytes_raise_decode_error(wire_engine_mode):
    """Garbage input raises the protobuf DecodeError in BOTH modes:
    the C parser never invents its own failure type — it defers to the
    real codec, which stays the arbiter of malformed input."""
    from google.protobuf.message import DecodeError
    with pytest.raises(DecodeError):
        wire.loads(b"\xff\xff\xff\xff garbage")


@pytestmark_native
def test_frame_reader_direct():
    """FrameReader unit: multiple frames per pump, partial-frame carry,
    EOF -> PumpClosed, oversized -> PumpOversized."""
    a, b = socket.socketpair()
    rd = native.FrameReader(a.fileno(), 1 << 20)
    try:
        f1, f2, f3 = b"alpha", b"bee", b"c" * 1000
        raw = b"".join(_LEN.pack(len(f)) + f for f in (f1, f2, f3))
        b.sendall(raw[:-3])                  # hold back f3's tail
        frames = rd.pump()
        assert frames == [f1, f2]
        b.sendall(raw[-3:])
        assert rd.pump() == [f3]
        b.sendall(_LEN.pack(1 << 30))        # over this reader's max
        with pytest.raises(native.PumpOversized):
            rd.pump()
    finally:
        rd.close()
        a.close()
        b.close()
    a2, b2 = socket.socketpair()
    rd2 = native.FrameReader(a2.fileno(), 1 << 20)
    try:
        b2.close()
        with pytest.raises(native.PumpClosed):
            rd2.pump()
    finally:
        rd2.close()
        a2.close()
