"""The port's framed wire (`ray_tpu_torch/_private/{wire,protocol}.py`).

The JAX wire encodes a protobuf Envelope with a pickled escape hatch;
the port's encodes plain values as versioned JSON. These tests hold the
port's codec and `Connection` to the JAX protocol's contract: exact
round trips, request/reply across threads, the max-frame guard, refusal
of another wire major version at the first frame, and ConnectionClosed
once a connection is gone. Connections are joined over loopback TCP.
"""
import socket
import struct
import sys
import threading

import pytest

from ray_tpu_torch._private import protocol, wire
from ray_tpu_torch._private.direct_actor import dial_cached

WAIT_S = 5.0


def _tcp_socketpair():
    """Two connected loopback TCP sockets (a Connection sets
    TCP_NODELAY, which a unix socketpair refuses)."""
    lsock = socket.socket()
    try:
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        a = socket.create_connection(lsock.getsockname())
        b, _ = lsock.accept()
    finally:
        lsock.close()
    return a, b


def _pair(server_handler, client_handler=lambda c, m: None):
    """(client, server) Connections over loopback TCP, both started;
    each side's on_close sets an Event in `closed`."""
    a, b = _tcp_socketpair()
    closed = {"client": threading.Event(), "server": threading.Event()}
    client = protocol.Connection(a, client_handler, name="client",
                                 on_close=lambda c: closed["client"].set())
    server = protocol.Connection(b, server_handler, name="server",
                                 on_close=lambda c: closed["server"].set())
    client.start()
    server.start()
    return client, server, closed


@pytest.mark.parametrize("msg", [
    {"type": "llm_tok", "req": "r1", "inc": "ab12cd34", "attempt": 0,
     "base": 3, "toks": [17, 254, 9], "done": False, "reason": None,
     "err": None},
    {"type": "llm_sub", "req": "é-ü", "cursor": 0, "unknown": True},
    {"type": "x", "f": -1.5, "nested": {"a": [[], [1, [2, {"b": None}]]]},
     "big": (1 << 62)},
    {},
])
def test_codec_round_trips_plain_values(msg):
    data = wire.dumps(msg)
    assert struct.unpack_from("<H", data)[0] == wire.WIRE_VERSION
    got, version = wire.loads_ex(data)
    assert got == msg and version == wire.WIRE_VERSION


@pytest.mark.parametrize("bad", [
    {"toks": (1, 2)},                     # a tuple would come back a list
    {1: "int key"},                       # an int key would come back a str
    {"obj": object()},
    {"nan": float("nan")},
    {"deep": [[[[[[[[[[[[[[[[[1]]]]]]]]]]]]]]]]]},
])
def test_codec_refuses_what_json_would_not_round_trip(bad):
    with pytest.raises((TypeError, ValueError)):
        wire.dumps(bad)


def test_codec_refuses_another_major_version_and_malformed_bodies():
    body = wire.dumps({"type": "ping"})[2:]
    for version in (0, 99, 200, 7301):
        with pytest.raises(wire.WireVersionError):
            wire.loads_ex(struct.pack("<H", version) + body)
    # MINOR skew is compatible
    msg, version = wire.loads_ex(struct.pack("<H", 199) + body)
    assert msg == {"type": "ping"} and version == 199
    for data in (b"", b"\x64", struct.pack("<H", 100) + b"[1, 2]",
                 struct.pack("<H", 100) + b"{not json"):
        with pytest.raises(ValueError):
            wire.loads_ex(data)


def test_request_reply_across_threads():
    """Both ends may issue requests at once, from 32 threads (more than
    the cores); replies route by rid to the waiting caller, whichever
    thread it is on, and none is lost or crossed."""
    def echo(conn, msg):
        if msg["type"] == protocol.PING:
            conn.reply(msg, ok=True)
        elif msg["type"] == "add":
            conn.reply(msg, sum=msg["a"] + msg["b"])

    client, server, _ = _pair(echo, client_handler=echo)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # interleave the callers finely
    try:
        results, errors = {}, []

        def call(conn, i):
            try:
                r = conn.request({"type": "add", "a": i, "b": 1000},
                                 timeout=WAIT_S)
                results[(conn.name, i)] = r["sum"]
            except Exception as e:      # noqa: BLE001 - reported below
                errors.append(e)
        threads = [threading.Thread(target=call, args=(c, i))
                   for i in range(16) for c in (client, server)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        assert not errors
        assert results == {(n, i): i + 1000 for i in range(16)
                           for n in ("client", "server")}
        assert client.request({"type": protocol.PING},
                              timeout=WAIT_S)["ok"] is True
        assert client.peer_wire_version == wire.WIRE_VERSION
    finally:
        sys.setswitchinterval(interval)
        client.close()
        server.close()


def test_frame_too_large_kills_the_connection():
    seen = []
    a, b = _tcp_socketpair()
    closed = threading.Event()
    server = protocol.Connection(b, lambda c, m: seen.append(m),
                                 on_close=lambda c: closed.set(),
                                 name="server")
    server.start()
    small = wire.dumps({"type": "ok"})
    a.sendall(struct.pack("<Q", len(small)) + small)
    a.sendall(struct.pack("<Q", 1 << 40))     # claims a 1 TB frame
    assert closed.wait(WAIT_S) and server.closed
    assert seen == [{"type": "ok"}]
    a.close()
    assert issubclass(protocol.FrameTooLarge, protocol.ConnectionClosed)


def test_peer_with_another_major_is_refused_at_its_first_frame():
    seen = []
    a, b = _tcp_socketpair()
    closed = threading.Event()
    server = protocol.Connection(b, lambda c, m: seen.append(m),
                                 on_close=lambda c: closed.set(),
                                 name="server")
    server.start()
    body = struct.pack("<H", 200) + b'{"type":"ping","rid":1}'
    a.sendall(struct.pack("<Q", len(body)) + body)
    assert closed.wait(WAIT_S) and server.closed
    assert seen == [] and server.peer_wire_version == 0
    a.settimeout(WAIT_S)
    assert a.recv(16) == b""                # the server hung up
    a.close()


def test_close_raises_connection_closed_and_fails_pending_requests():
    # the server never replies, so the client's request stays pending
    client, server, closed = _pair(lambda c, m: None)
    fut = client.request_async({"type": "hang"})
    server.close()
    assert closed["client"].wait(WAIT_S)
    with pytest.raises(protocol.ConnectionClosed):
        fut.result(WAIT_S)
    with pytest.raises(protocol.ConnectionClosed):
        client.send({"type": "late"})
    with pytest.raises(protocol.ConnectionClosed):
        client.request({"type": protocol.PING}, timeout=WAIT_S)
    assert client.closed and server.closed


def test_dial_cached_reuses_a_live_connection_and_redials_a_dead_one():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    addr = lsock.getsockname()
    accepted = []

    def accept():
        for _ in range(2):
            sock, _ = lsock.accept()
            conn = protocol.Connection(
                sock, lambda c, m: c.reply(m, ok=True), name="srv")
            conn.start()
            accepted.append(conn)
    t = threading.Thread(target=accept, daemon=True)
    t.start()
    cache, lock = {}, threading.Lock()
    try:
        c1 = dial_cached(cache, lock, addr)
        assert dial_cached(cache, lock, addr) is c1
        assert c1.request({"type": protocol.PING}, timeout=WAIT_S)["ok"]
        c1.close()
        c2 = dial_cached(cache, lock, addr)
        assert c2 is not c1 and not c2.closed
        assert c2.request({"type": protocol.PING}, timeout=WAIT_S)["ok"]
        t.join(WAIT_S)
        assert not t.is_alive()
        c2.close()
    finally:
        lsock.close()
        for c in accepted:
            c.close()
    free = socket.socket()
    free.bind(("127.0.0.1", 0))
    refused = free.getsockname()        # bound, not listening: refuses
    try:
        assert dial_cached({}, threading.Lock(), refused) is None
    finally:
        free.close()
