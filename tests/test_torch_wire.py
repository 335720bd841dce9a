"""Wire-contract tests on the port: the twin of `tests/test_wire.py`,
test for test, run on `ray_tpu_torch`'s copy of the codec and protocol
(`ray_tpu_torch/_private/{wire,wire_pb2,protocol}.py`).

Parity: the reference pins its wire in src/ray/protobuf/*.proto; here
the contract is ray_tpu_torch/protos/wire.proto (byte-identical to the
JAX package's, so both packages share one registered `wire.proto`) +
the codec policy in _private/wire.py (structural node plane, pickled
Python plane).
"""
import os
import socket
import struct
import threading
import time

import pytest

from ray_tpu_torch._private import protocol, wire
from ray_tpu_torch._private import wire_pb2 as pb


@pytest.fixture(params=["native", "python"])
def wire_engine_mode(request):
    """The port's twin of the conftest fixture of the same name: run a
    test under BOTH wire engines of the port, its native frame engine
    (C read pump / writev / envelope codec, codec force-enabled) and the
    pure-Python paths (RAY_TPU_WIRE_NATIVE=0), re-reading the port's
    CONFIG."""
    from ray_tpu_torch import native
    from ray_tpu_torch._private.config import CONFIG

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


@pytest.fixture(autouse=True)
def _wire_mode_autouse(wire_engine_mode):
    """Every wire-contract test runs under BOTH engines (the shared
    conftest `wire_engine_mode` fixture): the r7 native frame engine
    and the pure-Python protobuf paths. The contract — bytes on the
    wire AND decoded messages — must be indistinguishable; the two
    modes interoperate on one connection in production."""
    yield


# ------------------------------------------------------------- codec
def test_roundtrip_exact_types():
    msg = {
        "type": "node_register", "rid": 3,
        "none": None, "t": True, "f": False,
        "i": -42, "big": 1 << 80, "neg64": -(1 << 63),
        "d": 2.5, "s": "héllo", "b": b"\x00\xff",
        "lst": [1, "x", None], "empty_l": [], "empty_d": {},
        "nested": {"a": {"b": [1.0]}},
        "tup": ("h", 1),          # tuple identity must survive
    }
    out = wire.loads(wire.dumps(msg))
    assert out == msg
    assert type(out["tup"]) is tuple
    assert type(out["lst"]) is list


def test_roundtrip_python_only_leaves():
    import enum

    class E(enum.IntEnum):
        A = 1

    msg = {"type": "node_event", "e": E.A, "fn": lambda v: v + 1,
           "exc": ValueError("boom")}
    out = wire.loads(wire.dumps(msg))
    assert out["e"] is E.A            # subclass NOT widened to int
    assert out["fn"](1) == 2
    assert isinstance(out["exc"], ValueError)


def test_bulk_collections_take_one_leaf():
    rows = [{"i": i} for i in range(1000)]
    msg = {"type": "node_event", "rows": rows}
    env = pb.Envelope.FromString(wire.dumps(msg))
    v = env.fields.fields["rows"]
    assert v.WhichOneof("kind") == "pickled"   # not 1000 Value nodes
    assert wire.loads(wire.dumps(msg))["rows"] == rows


def test_node_plane_frames_are_pickle_free():
    """The language-neutral property: a heartbeat/lookup/pull frame
    must decode with zero pickled leaves — parseable by any protobuf
    implementation."""
    def has_pickled(v):
        kind = v.WhichOneof("kind")
        if kind == "pickled":
            return True
        if kind == "list":
            return any(has_pickled(i) for i in v.list.items)
        if kind == "struct":
            return any(has_pickled(i) for i in v.struct.fields.values())
        return False

    frames = [
        {"type": "node_heartbeat", "node_id": "n1",
         "avail": {"CPU": 3.0}, "total": {"CPU": 4.0},
         "pending_demand": {}, "pending_shapes": [{"CPU": 1.0}],
         "is_idle": False,
         "host_stats": {"load_1m": 0.5, "mem_total_mb": 1024}},
        {"type": "object_lookup", "rid": 9, "object_id": "o" * 18,
         "timeout": 5.0},
        {"type": "pull_chunk", "rid": 2, "pull_id": "p1", "index": 3},
        {"type": "decref", "object_id": "o" * 18},
        {"type": "register", "worker_id": "w1", "pid": 1234},
    ]
    for msg in frames:
        env = pb.Envelope.FromString(wire.dumps(msg))
        assert not env.py_body, msg["type"]
        assert not any(has_pickled(v)
                       for v in env.fields.fields.values()), msg["type"]
        assert wire.loads(env.SerializeToString()) == msg


def test_python_plane_uses_py_body():
    msg = {"type": "task_done", "rid": 1, "task_id": "t1", "ok": True}
    env = pb.Envelope.FromString(wire.dumps(msg))
    assert env.py_body and not env.fields.fields
    assert wire.loads(wire.dumps(msg)) == msg


def test_version_skew():
    # minor skew: compatible
    env = pb.Envelope.FromString(wire.dumps({"type": "ping"}))
    env.version = wire.WIRE_MAJOR * 100 + wire.WIRE_MINOR + 7
    assert wire.loads(env.SerializeToString())["type"] == "ping"
    # major skew: refused before any pickle decode
    env.version = (wire.WIRE_MAJOR + 1) * 100
    with pytest.raises(wire.WireVersionError):
        wire.loads(env.SerializeToString())


# ------------------------------------------------- live connection
def test_listener_refuses_foreign_major_version():
    """A peer speaking a different wire MAJOR is disconnected at its
    first frame and its messages never reach the handler."""
    handled = []
    server_conns = []

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def accept():
        s, _ = lsock.accept()
        c = protocol.Connection(
            s, lambda conn, msg: handled.append(msg), server=True)
        server_conns.append(c)
        c.start()

    t = threading.Thread(target=accept, daemon=True)
    t.start()

    peer = socket.create_connection(("127.0.0.1", port))
    env = pb.Envelope(version=(wire.WIRE_MAJOR + 1) * 100, type="ping")
    body = env.SerializeToString()
    peer.sendall(struct.pack("<Q", len(body)) + body)
    t.join(5)
    deadline = time.time() + 5
    while time.time() < deadline and not server_conns[0].closed:
        time.sleep(0.05)
    assert server_conns[0].closed
    assert handled == []
    # and the socket is actually dead from the peer's side
    peer.settimeout(5)
    assert peer.recv(1) == b""
    peer.close()
    lsock.close()


def test_same_version_connection_works():
    replies = []
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def accept():
        s, _ = lsock.accept()
        c = protocol.Connection(
            s, lambda conn, msg: conn.reply(msg, ok=True, echo=msg["x"]),
            server=True)
        c.start()

    threading.Thread(target=accept, daemon=True).start()
    conn = protocol.connect(("127.0.0.1", port), lambda c, m: None)
    rep = conn.request({"type": "ping", "x": 41}, timeout=10)
    replies.append(rep)
    assert rep["ok"] and rep["echo"] == 41
    conn.close()
    lsock.close()


def test_python_plane_fast_pickle_and_fallback():
    """Plain-pickle fast path for importable object graphs; __main__ /
    <locals> classes and lambdas trip the tripwire and fall back to
    cloudpickle — never by-reference bytes the peer cannot load."""
    from ray_tpu_torch._private.specs import TaskSpec

    spec = TaskSpec(task_id="t1", func_id="f" * 16,
                    args=(1, 2.5, "x", b"b"), kwargs={"k": [1, 2]},
                    return_ids=["t1r0"], resources={"CPU": 1.0})
    out = wire.loads(wire.dumps({"type": "task", "rid": 3,
                                 "spec": spec}))
    assert out["spec"].args == (1, 2.5, "x", b"b")

    class Mainish:
        def __init__(self, v):
            self.v = v
    Mainish.__module__ = "__main__"     # simulate a driver-script class

    def maker():
        class Local:
            pass
        return Local

    msg = {"type": "reply", "rid": 9,
           "value": [lambda x: x + 1, Mainish(7), maker()()]}
    out = wire.loads(wire.dumps(msg))
    assert out["value"][0](1) == 2
    assert out["value"][1].v == 7
    assert type(out["value"][2]).__name__ == "Local"


# ------------------------------------------------- batch frames (r6)
def test_batch_frame_roundtrip_preserves_order():
    msgs = [{"type": "decref", "object_id": f"oid{i:015d}"}
            for i in range(10)]
    msgs.append({"type": "task_done", "task_id": "t1", "ok": True})
    msgs.append({"type": "decref_batch",
                 "object_ids": [f"b{i}" for i in range(5)]})
    blob = wire.dumps_batch(msgs)
    env = pb.Envelope.FromString(blob)
    assert env.type == wire.BATCH_TYPE
    assert len(env.batch.frames) == len(msgs)
    out, ver = wire.loads_ex(blob)
    assert ver == wire.WIRE_VERSION
    assert out["type"] == wire.BATCH_TYPE
    assert out["frames"] == msgs          # order + content intact


def test_decref_batch_is_language_neutral():
    """DECREF_BATCH rides the structural node plane: zero pickled
    leaves, like its single-frame sibling."""
    msg = {"type": "decref_batch",
           "object_ids": ["o" * 20, "p" * 20]}
    env = pb.Envelope.FromString(wire.dumps(msg))
    assert not env.py_body
    kinds = {v.WhichOneof("kind") for v in env.fields.fields.values()}
    assert "pickled" not in kinds
    assert wire.loads(env.SerializeToString()) == msg


def test_batch_emission_is_negotiated():
    """A sender must not emit BatchFrame until it has OBSERVED the peer
    speaking MINOR >= 1; before that, coalesced flushes go out as
    plain concatenated frames any same-major peer can parse."""
    got = []
    server_box = {}
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def accept():
        s, _ = lsock.accept()
        c = protocol.Connection(
            s, lambda conn, msg: got.append(msg), server=True)
        server_box["c"] = c
        c.start()

    threading.Thread(target=accept, daemon=True).start()
    conn = protocol.connect(("127.0.0.1", port), lambda c, m: None)
    conn.enable_coalescing()
    try:
        # phase 1: nothing observed from the peer -> no BatchFrame
        assert conn.peer_wire_version == 0
        s0 = dict(protocol.WIRE_STATS)
        for i in range(8):
            conn.send_lazy({"type": "decref", "object_id": f"a{i}"})
        conn.flush()
        deadline = time.time() + 5
        while len(got) < 8 and time.time() < deadline:
            time.sleep(0.01)
        assert len(got) == 8
        assert (protocol.WIRE_STATS["tx_frames"] - s0["tx_frames"]) == 8

        # phase 2: peer speaks -> version learned -> BatchFrame emitted
        server_box["c"].send({"type": "ping"})
        deadline = time.time() + 5
        while conn.peer_wire_version == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert conn.peer_wire_version == wire.WIRE_VERSION
        s1 = dict(protocol.WIRE_STATS)
        for i in range(8):
            conn.send_lazy({"type": "decref", "object_id": f"b{i}"})
        conn.flush()
        deadline = time.time() + 5
        while len(got) < 17 and time.time() < deadline:
            time.sleep(0.01)
        assert (protocol.WIRE_STATS["tx_frames"] - s1["tx_frames"]) == 1
        order = [m["object_id"] for m in got if m["type"] == "decref"
                 and m["object_id"].startswith("b")]
        assert order == [f"b{i}" for i in range(8)]
    finally:
        conn.close()
        lsock.close()


def test_eager_send_flushes_lazy_queue_in_order():
    """A reply-bearing request bypasses the coalescing queue but must
    drain it FIRST: per-connection FIFO between lazy and eager frames
    is what the refcount pin-release protocol relies on."""
    got = []
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def accept():
        s, _ = lsock.accept()
        c = protocol.Connection(
            s, lambda conn, msg: got.append(msg), server=True)
        c.start()

    threading.Thread(target=accept, daemon=True).start()
    conn = protocol.connect(("127.0.0.1", port), lambda c, m: None)
    conn.enable_coalescing()
    try:
        conn.send_lazy({"type": "addref", "object_id": "pinned"})
        conn.send({"type": "task_done", "task_id": "t9"})  # eager
        deadline = time.time() + 5
        while len(got) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert [m["type"] for m in got] == ["addref", "task_done"]
    finally:
        conn.close()
        lsock.close()


def test_wire_batch_disable_flag():
    """RAY_TPU_WIRE_BATCH=0 restores one-frame-per-send behavior even
    on a coalescing-enabled connection."""
    import os
    from ray_tpu_torch._private.config import CONFIG
    prev = os.environ.get("RAY_TPU_WIRE_BATCH")
    os.environ["RAY_TPU_WIRE_BATCH"] = "0"
    CONFIG.reload()
    got = []
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def accept():
        s, _ = lsock.accept()
        c = protocol.Connection(
            s, lambda conn, msg: got.append(msg), server=True)
        c.start()

    threading.Thread(target=accept, daemon=True).start()
    conn = protocol.connect(("127.0.0.1", port), lambda c, m: None)
    conn.enable_coalescing()
    try:
        s0 = dict(protocol.WIRE_STATS)
        for i in range(6):
            conn.send_lazy({"type": "decref", "object_id": f"d{i}"})
        deadline = time.time() + 5
        while len(got) < 6 and time.time() < deadline:
            time.sleep(0.01)
        assert len(got) == 6
        # every send_lazy degraded to an immediate single frame
        assert (protocol.WIRE_STATS["tx_frames"] - s0["tx_frames"]) == 6
    finally:
        conn.close()
        lsock.close()
        if prev is None:
            os.environ.pop("RAY_TPU_WIRE_BATCH", None)
        else:
            os.environ["RAY_TPU_WIRE_BATCH"] = prev
        CONFIG.reload()


def test_tripwire_catches_by_reference_main_objects():
    """The dangerous case: objects plain pickle would serialize
    'successfully' BY REFERENCE into this process's __main__ — a class
    genuinely reachable as __main__.<name>, and a global-name-pickled
    non-callable (TypeVar). The tripwire must force by-value
    cloudpickle bytes, proven by decoding in a SUBPROCESS whose
    __main__ has no such names."""
    import subprocess
    import sys
    import typing

    main = sys.modules["__main__"]

    class TopLevelWireTest:
        def __init__(self, v):
            self.v = v

    TopLevelWireTest.__module__ = "__main__"
    TopLevelWireTest.__qualname__ = "TopLevelWireTest"
    setattr(main, "TopLevelWireTest", TopLevelWireTest)
    tv = typing.TypeVar("WireTestTV")
    tv.__module__ = "__main__"
    setattr(main, "WireTestTV", tv)
    try:
        # sanity: plain pickle CAN save these by reference here, so
        # only the tripwire routes them to cloudpickle
        import pickle as _p
        _p.dumps(getattr(main, "TopLevelWireTest"))
        blob = wire.dumps({"type": "reply", "rid": 1,
                           "value": [TopLevelWireTest(9), tv]})
        script = (
            "import sys; sys.path.insert(0, %r)\n"
            "from ray_tpu_torch._private import wire\n"
            "msg = wire.loads(sys.stdin.buffer.read())\n"
            "inst, t = msg['value']\n"
            "assert inst.v == 9, inst\n"
            "assert t.__name__ == 'WireTestTV', t\n"
            "print('DECODED-OK')\n" % (str(__import__('os').getcwd()),))
        out = subprocess.run([sys.executable, "-c", script],
                             input=blob, capture_output=True,
                             timeout=120)
        assert b"DECODED-OK" in out.stdout, out.stderr.decode()[-1500:]
    finally:
        delattr(main, "TopLevelWireTest")
        delattr(main, "WireTestTV")
