"""Shared-poller event loop (r10): one thread reads every registered
connection — native epoll engine (rtpu_poller_* in core.c) and the
select()-based Python fallback must behave identically.

Contract under test: torn frames reassemble, a peer closing mid-frame
kills only its own connection (on_close fires, nothing half-dispatched),
a corrupt length prefix is contained to one connection, and many
concurrent connections are all served by the single loop thread —
no per-connection reader threads appear.

The port's twin of `tests/test_epoll_loop.py`, case for case.
"""
import os
import socket
import struct
import threading
import time

import pytest

from ray_tpu_torch._private import protocol, wire


@pytest.fixture(params=["native", "python"])
def wire_engine_mode(request):
    """The conftest fixture of the same name, on the port: run a test
    under both of the port's wire engines, re-reading the port's CONFIG."""
    import os

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


_LEN = struct.Struct("<Q")


@pytest.fixture(autouse=True)
def _engines(wire_engine_mode):
    """Both engines, like test_wire.py: 'native' exercises the epoll
    loop + C nb-pump, 'python' the select fallback + bytearray pump."""
    yield


class _Server:
    """Listener whose accepted connections are read by ONE Poller."""

    def __init__(self, handler, on_close=None):
        self.poller = protocol.Poller()
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(128)
        self.addr = self.listener.getsockname()
        self.conns = []
        self._handler = handler
        self._on_close = on_close
        self._accept = threading.Thread(target=self._loop, daemon=True)
        self._accept.start()

    def _loop(self):
        while True:
            try:
                sock, _ = self.listener.accept()
            except OSError:
                return
            conn = protocol.Connection(sock, self._handler,
                                       self._on_close, name="t-server",
                                       server=True, poller=self.poller)
            self.conns.append(conn)
            conn.start()

    def close(self):
        try:
            self.listener.close()
        except OSError:
            pass
        self.poller.close()


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_engine_matches_mode(wire_engine_mode):
    srv = _Server(lambda c, m: None)
    try:
        want = "epoll" if wire_engine_mode == "native" else "select"
        assert srv.poller.engine == want
    finally:
        srv.close()


def test_torn_frames_reassemble():
    """Frames dribbled one byte at a time across readiness events must
    reassemble and dispatch in order."""
    got = []
    srv = _Server(lambda c, m: got.append(m["i"]))
    try:
        sock = socket.create_connection(srv.addr)
        payloads = [wire.dumps({"type": "t", "i": i}) for i in range(5)]
        blob = b"".join(_LEN.pack(len(p)) + p for p in payloads)
        for off in range(len(blob)):
            sock.sendall(blob[off:off + 1])
            if off % 16 == 0:
                time.sleep(0.001)      # force many partial reads
        assert _wait(lambda: len(got) == 5), got
        assert got == [0, 1, 2, 3, 4]
        sock.close()
    finally:
        srv.close()


def test_peer_close_mid_frame():
    """EOF inside a frame body: nothing is dispatched for the torn
    frame, complete frames before it are, and on_close fires."""
    got, closed = [], []
    srv = _Server(lambda c, m: got.append(m["i"]),
                  on_close=lambda c: closed.append(c))
    try:
        sock = socket.create_connection(srv.addr)
        whole = wire.dumps({"type": "t", "i": 1})
        torn = wire.dumps({"type": "t", "i": 2})
        sock.sendall(_LEN.pack(len(whole)) + whole
                     + _LEN.pack(len(torn)) + torn[:4])
        time.sleep(0.1)
        sock.close()
        assert _wait(lambda: closed), "on_close did not fire"
        assert got == [1]
    finally:
        srv.close()


def test_oversized_frame_kills_only_that_connection(monkeypatch):
    """A corrupt length prefix (> wire_max_frame_bytes) kills its
    connection; a healthy neighbor on the same loop keeps working."""
    from ray_tpu_torch._private.config import CONFIG
    monkeypatch.setenv("RAY_TPU_WIRE_MAX_FRAME_BYTES", str(1 << 16))
    CONFIG.reload()
    got, closed = [], []
    srv = _Server(lambda c, m: got.append(m["i"]),
                  on_close=lambda c: closed.append(c))
    try:
        bad = socket.create_connection(srv.addr)
        good = socket.create_connection(srv.addr)
        bad.sendall(_LEN.pack(1 << 40))         # hostile prefix
        assert _wait(lambda: closed), "corrupt stream not killed"
        msg = wire.dumps({"type": "t", "i": 7})
        good.sendall(_LEN.pack(len(msg)) + msg)
        assert _wait(lambda: got == [7]), got
        # the bad socket is dead server-side: EOF (or RST) comes back
        bad.settimeout(5.0)
        try:
            assert bad.recv(64) == b""
        except OSError:
            pass
        bad.close()
        good.close()
    finally:
        srv.close()
        CONFIG.reload()


def test_many_connections_one_thread():
    """40 concurrent request/reply clients served by the shared loop:
    every reply arrives and no per-connection reader threads exist."""
    def handler(conn, msg):
        conn.reply(msg, echo=msg["i"] * 10)

    srv = _Server(handler)
    try:
        clients = [protocol.connect(srv.addr, lambda c, m: None,
                                    name=f"cli{i}") for i in range(40)]
        assert _wait(lambda: srv.poller.num_connections >= 40)
        reader_threads = [t.name for t in threading.enumerate()
                          if t.name.startswith("ray-tpu-conn-t-server")]
        assert reader_threads == [], reader_threads
        futs = [c.request_async({"type": "q", "i": i})
                for i, c in enumerate(clients)]
        for i, fut in enumerate(futs):
            assert fut.result(20)["echo"] == i * 10
        for c in clients:
            c.close()
        assert _wait(lambda: srv.poller.num_connections == 0), \
            srv.poller.num_connections
    finally:
        srv.close()


def test_large_frame_through_loop():
    """A multi-MB body crosses many readiness events (the nb pump
    grows toward the announced frame length) and round-trips intact."""
    got = []
    srv = _Server(lambda c, m: got.append(m["blob"]))
    try:
        sock = socket.create_connection(srv.addr)
        blob = os.urandom(4 * 1024 * 1024)
        msg = wire.dumps({"type": "t", "blob": blob})
        sock.sendall(_LEN.pack(len(msg)) + msg)
        assert _wait(lambda: got, timeout=30)
        assert got[0] == blob
        sock.close()
    finally:
        srv.close()


def test_epoll_disabled_restores_reader_threads(monkeypatch):
    """RAY_TPU_EPOLL=0: make_poller returns None and connections fall
    back to a reader thread each (prior behavior)."""
    from ray_tpu_torch._private.config import CONFIG
    monkeypatch.setenv("RAY_TPU_EPOLL", "0")
    CONFIG.reload()
    try:
        assert protocol.make_poller() is None
        got = []
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.bind(("127.0.0.1", 0))
        lst.listen(8)

        def accept_one():
            sock, _ = lst.accept()
            conn = protocol.Connection(sock, lambda c, m:
                                       got.append(m["i"]),
                                       name="thr-server", server=True,
                                       poller=None)
            conn.start()

        threading.Thread(target=accept_one, daemon=True).start()
        cli = protocol.connect(lst.getsockname(), lambda c, m: None)
        cli.send({"type": "t", "i": 3})
        assert _wait(lambda: got == [3]), got
        assert any(t.name.startswith("ray-tpu-conn-thr-server")
                   for t in threading.enumerate())
        cli.close()
        lst.close()
    finally:
        CONFIG.reload()
