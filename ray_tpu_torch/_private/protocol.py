"""Framed full-duplex connection (the port's copy of the wire protocol).

Port of `Connection` of `ray_tpu/_private/protocol.py`: one
length-prefixed-frame protocol over TCP. Either endpoint may send
*requests* (carry a fresh ``rid``) and *replies* (echo the ``rid``). A
``Connection`` owns a reader thread that routes replies to waiting
futures and hands every other frame to a handler callback, so both
sides can send at any time. Frame bodies are the versioned codec of
`_private/wire.py`; a peer with another wire MAJOR is refused at its
first frame.

Not in this copy (they wait for the runtime slice): the chaos network,
coalescing and batched frames, the shared poller, the native frame
engine and the listener secret. The reader is the JAX module's
pure-Python read loop.
"""
from __future__ import annotations

import itertools
import socket
import struct
import sys
import threading
from typing import Any, Callable, Optional

from ray_tpu_torch._private.wire import WireVersionError, dumps, loads_ex

_LEN = struct.Struct("<Q")
# Sanity bound on a frame's length prefix: a larger claim is a corrupt or
# hostile stream, and the connection dies before a multi-GB allocation.
_MAX_FRAME = 1 << 30

PING = "ping"                    # either
REPLY = "reply"                  # either (generic reply)


class ConnectionClosed(Exception):
    pass


class FrameTooLarge(ConnectionClosed):
    """A frame's length prefix exceeds `_MAX_FRAME`: corrupt (or hostile)
    stream. The connection dies before the reader attempts a multi-GB
    allocation."""


class Connection:
    """Full-duplex framed-message channel with request/reply correlation."""

    def __init__(self, sock: socket.socket,
                 handler: Callable[["Connection", dict], None],
                 on_close: Optional[Callable[["Connection"], None]] = None,
                 name: str = ""):
        self._sock = sock
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Bound sends only (recv stays blocking: connections idle for
        # minutes legitimately): a wedged peer (full TCP buffer) surfaces
        # as ConnectionClosed after this budget instead of hanging the
        # sender forever.
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                                  struct.pack("ll", 30, 0))
        except OSError:
            pass
        self._handler = handler
        self._on_close = on_close
        self.name = name
        self._send_lock = threading.Lock()
        self._rid_counter = itertools.count(1)
        self._pending: dict[int, _Future] = {}
        self._pending_lock = threading.Lock()
        self._closed = threading.Event()
        # Wire version observed on the peer's frames (0 = nothing seen)
        self.peer_wire_version = 0
        self._reader = threading.Thread(
            target=self._read_loop, name=f"ray-tpu-torch-conn-{name}",
            daemon=True)

    def start(self) -> None:
        self._reader.start()

    # ---- sending ----
    def send(self, msg: dict) -> None:
        frame = dumps(msg)
        with self._send_lock:
            try:
                self._sock.sendall(_LEN.pack(len(frame)) + frame)
            except OSError as e:
                # a failed write may have put a partial frame on the
                # wire: the stream is desynced, so the connection dies
                self.close()
                raise ConnectionClosed(str(e)) from e

    def request(self, msg: dict, timeout: Optional[float] = None) -> dict:
        """Send a request and block for the matching reply."""
        return self.request_async(msg).result(timeout)

    def request_async(self, msg: dict) -> "_Future":
        rid = next(self._rid_counter)
        msg["rid"] = rid
        fut = _Future()
        with self._pending_lock:
            self._pending[rid] = fut
        try:
            self.send(msg)
        except ConnectionClosed:
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise
        return fut

    def reply(self, request_msg: dict, **fields) -> None:
        self.send({"type": REPLY, "rid": request_msg["rid"], **fields})

    # ---- receiving ----
    def _dispatch(self, msg: dict) -> None:
        if msg.get("type") == REPLY:
            with self._pending_lock:
                fut = self._pending.pop(msg.get("rid"), None)
            if fut is not None:
                fut.set(msg)
        else:
            self._handler(self, msg)

    def _handle_frame(self, data: bytes) -> None:
        msg, version = loads_ex(data)
        self.peer_wire_version = version
        self._dispatch(msg)

    def _py_read_loop(self) -> None:
        """One reassembly bytearray per connection, with a max-frame
        guard checked before the body is read."""
        buf = bytearray()
        while True:
            while len(buf) < _LEN.size:
                chunk = self._sock.recv(1 << 20)
                if not chunk:
                    raise ConnectionClosed("peer closed")
                buf += chunk
            (length,) = _LEN.unpack_from(buf)
            if length > _MAX_FRAME:
                raise FrameTooLarge(f"frame length prefix {length} exceeds "
                                    f"{_MAX_FRAME}")
            total = _LEN.size + length
            while len(buf) < total:
                chunk = self._sock.recv(1 << 20)
                if not chunk:
                    raise ConnectionClosed("peer closed")
                buf += chunk
            frame = bytes(memoryview(buf)[_LEN.size:total])
            del buf[:total]
            self._handle_frame(frame)

    @staticmethod
    def _log_read_error(name: str, exc: BaseException) -> bool:
        """True when the reader's exit exception was expected (and
        reported where it matters)."""
        if isinstance(exc, FrameTooLarge):
            sys.stderr.write(
                f"ray_tpu_torch: killing connection ({name}): {exc}\n")
            return True
        if isinstance(exc, (ConnectionClosed, OSError)):
            return True
        if isinstance(exc, WireVersionError):
            sys.stderr.write(
                f"ray_tpu_torch: refusing connection ({name}): {exc}\n")
            return True
        return False

    def _read_loop(self) -> None:
        try:
            self._py_read_loop()
        except Exception as e:
            if not self._log_read_error(self.name, e):
                import traceback
                traceback.print_exc()   # handler bug; don't die silently
        finally:
            self._finish_read()

    def _finish_read(self) -> None:
        """Reader exit (once, on the reader thread): the stream is dead.
        Release the socket, fail outstanding requests, fire on_close."""
        self.close()
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut.set_error(ConnectionClosed("connection lost"))
        if self._on_close is not None:
            try:
                self._on_close(self)
            except Exception:
                import traceback
                traceback.print_exc()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _Future:
    """Minimal thread-safe future for reply correlation."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def set(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("rpc timed out")
        if self._error is not None:
            raise self._error
        return self._value


def connect(addr: tuple[str, int],
            handler: Callable[[Connection, dict], None],
            on_close: Optional[Callable[[Connection], None]] = None,
            name: str = "") -> Connection:
    sock = socket.create_connection(addr)
    conn = Connection(sock, handler, on_close, name=name)
    conn.start()
    return conn
