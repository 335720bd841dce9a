"""The port's framed connection (`ray_tpu_torch/_private/protocol.py`).

These tests hold the port's `Connection` and `dial_cached` to the JAX
protocol's contract: request/reply across threads, the max-frame guard,
refusal of another wire major version at the first frame, and
ConnectionClosed once a connection is gone. Connections are joined over
loopback TCP. The codec itself (the JAX wire's protobuf Envelope) is
held to the JAX package by `tests/test_torch_wire.py`.
"""
import socket
import struct
import sys
import threading

import pytest

from ray_tpu_torch._private import protocol, wire
from ray_tpu_torch._private import wire_pb2 as pb
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
    body = pb.Envelope(version=(wire.WIRE_MAJOR + 1) * 100, type="ping",
                       rid=1).SerializeToString()
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
