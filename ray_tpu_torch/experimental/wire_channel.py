"""Cross-host wire transport for compiled-DAG channels (r13).

Port of `ray_tpu/experimental/wire_channel.py`; a tensor lands as the
shm reader lands it (`channel._decode_payload`): on the reader's own
card when it left a card, synchronized before the ack.

Shm channels (experimental/channel.py) are same-box by construction —
the ring lives in /dev/shm. MPMD pipeline stages, however, own their
own hosts at pod scale, and their activation/grad edges must flow
process-to-process over DATA connections, never through the head
("Exploring the limits of Concurrency in ML Training on Google TPUs":
the control plane stays off the hot path). This module gives channels
that transport: the writer process hosts one listener per channel,
each reader dials it directly, and published messages are PUSHED as
Envelope frames whose tensor payload rides the r12 `raw` bulk field —
mapped straight out of the producer's contiguous buffer by the
scatter-gather emit and landed on the consumer with ONE GIL-released
memcpy (native.buf_copy) into a freshly allocated ndarray. No pickled
blobs through the object store, no store round-trips, no driver hops.

Ring semantics match the shm transport exactly: the writer keeps at
most `depth` unacked messages in flight per reader (CH_ACK frames flow
back as readers consume), so depth >= 2 double-buffers the edge — the
writer computes microbatch m+1 while m is still in flight.

Framing negotiates by observed wire MINOR (the BatchFrame discipline):
raw-payload CH_DATA frames are emitted only toward a peer that
demonstrated MINOR >= wire.CHANNEL_MIN_MINOR on its attach frame;
toward an older peer the payload falls back to the pickled body, so
old peers are unaffected — they just pay the copies this transport
exists to remove.

Endpoint API mirrors the shm classes (writer()/reader(idx), read/
write/close/release, ChannelClosed/ChannelTimeout), so the compiled-
DAG exec loops and the MPMD stage loops are transport-blind.
"""
from __future__ import annotations

import pickle
import socket
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import protocol, tracing_plane as _tp
from ray_tpu_torch._private.wire import RAW_KEY
from ray_tpu_torch.experimental.channel import (ChannelClosed,
                                                ChannelTimeout,
                                                _array_payload,
                                                _decode_payload,
                                                _host_bytes,
                                                _ring_depth)

CH_ATTACH = "ch_attach"
CH_DATA = "ch_data"
CH_ACK = "ch_ack"
CH_CLOSE = "ch_close"

# Plain counters in the WIRE_STATS/OBJECT_PLANE_STATS idiom: the code
# counts its own fast-path hits so tests (and the r11 metrics plane's
# scrape-time gauges) can assert the zero-copy path actually ran.
CH_STATS = {
    "tx_raw": 0,          # raw-field frames emitted (MINOR-negotiated)
    "tx_blob": 0,         # pickled-body frames emitted (old peer / non-array)
    "rx_raw": 0,
    "rx_blob": 0,
    "landed_bytes": 0,    # raw bytes landed via the one-memcpy path
    "writes": 0,          # logical messages published (all readers)
    "reads": 0,           # logical messages consumed + acked
    "writer_block_ns": 0,  # time writers spent inside wait_writable
    "reader_wait_ns": 0,   # time readers spent parked for a message
}

# name -> _WireChannelServer living in THIS process (the writer side).
_SERVERS: Dict[str, "_WireChannelServer"] = {}
_SERVERS_LOCK = threading.Lock()


def ring_stats() -> Dict[str, int]:
    """Occupancy across every channel server in THIS process — the
    scrape-time companion to CH_STATS (the metrics plane mirrors both
    as ray_tpu_channel gauges)."""
    with _SERVERS_LOCK:
        servers = list(_SERVERS.values())
    occ = mx = 0
    for srv in servers:
        o = srv.occupancy()
        occ += o
        mx = max(mx, o)
    return {"rings": len(servers), "occupancy": occ,
            "occupancy_max": mx}


def _my_ip() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


class _WireChannelServer:
    """Writer-side endpoint state: the per-channel listener, attached
    reader connections, and the per-reader ack clock the ring's flow
    control runs on."""

    def __init__(self, name: str, capacity: int, n_readers: int,
                 depth: int, label: str):
        self.name = name
        self.capacity = capacity
        self.n_readers = n_readers
        self.depth = depth
        self.label = label
        self._cv = threading.Condition()
        self._conns: Dict[int, protocol.Connection] = {}
        self._acked = [0] * n_readers
        self._published = 0            # highest seq fully sent
        self._dead: set = set()        # reader indices whose conn died
        self._closing = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(max(4, n_readers))
        self.port = self._listener.getsockname()[1]
        self.host = _my_ip()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"rtpu-chan-{label}",
            daemon=True)
        self._accept_thread.start()

    # -------------------------------------------------------- accepting
    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return                 # listener closed: shutdown
            conn = protocol.Connection(
                sock, self._handle, self._on_conn_closed,
                name=f"chan-{self.label}", server=True)
            conn.start()

    def _handle(self, conn: protocol.Connection, msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == CH_ATTACH:
            idx = int(msg["reader"])
            with self._cv:
                if not 0 <= idx < self.n_readers:
                    conn.reply(msg, ok=False,
                               error=f"reader index {idx} out of range")
                    return
                self._conns[idx] = conn
                self._dead.discard(idx)
                conn.meta["ch_reader"] = idx
                self._cv.notify_all()
            conn.reply(msg, ok=True, depth=self.depth,
                       capacity=self.capacity)
        elif mtype == CH_ACK:
            idx = int(msg["reader"])
            with self._cv:
                if 0 <= idx < self.n_readers:
                    self._acked[idx] = max(self._acked[idx],
                                           int(msg["seq"]))
                    self._cv.notify_all()

    def _on_conn_closed(self, conn: protocol.Connection) -> None:
        idx = conn.meta.get("ch_reader")
        with self._cv:
            if self._closing or idx is None:
                return
            if self._conns.get(idx) is conn:
                self._dead.add(idx)
                self._cv.notify_all()

    # ------------------------------------------------------ writer side
    def wait_writable(self, seq: int, timeout: Optional[float]) -> list:
        """Block until every reader is attached and has acked message
        seq - depth (ring flow control), then return the live reader
        connections in index order. Raises ChannelClosed when a reader
        connection died — the pipeline cannot proceed without it."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        t0 = time.perf_counter_ns()
        try:
            with self._cv:
                while True:
                    if self._closing:
                        raise ChannelClosed(
                            f"wire channel {self.name}: writer "
                            f"endpoint shut down")
                    if self._dead:
                        raise ChannelClosed(
                            f"wire channel {self.name}: reader(s) "
                            f"{sorted(self._dead)} disconnected")
                    if (len(self._conns) == self.n_readers
                            and all(a >= seq - self.depth
                                    for a in self._acked)):
                        return [self._conns[i]
                                for i in range(self.n_readers)]
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise ChannelTimeout(
                            f"timed out waiting for wire-channel readers "
                            f"({len(self._conns)}/{self.n_readers} attached, "
                            f"acks {self._acked})")
                    self._cv.wait(0.2 if remaining is None
                                  else min(remaining, 0.2))
        finally:
            # Writer-blocked-on-ack time IS the ring-pressure signal
            # (the staleness bound binding): surface it on /metrics.
            CH_STATS["writer_block_ns"] += time.perf_counter_ns() - t0

    def occupancy(self) -> int:
        """Published-but-unacked messages for the laggiest reader —
        how full the ring is (0..depth while flow control holds)."""
        with self._cv:
            floor = min(self._acked) if self._acked else 0
            return max(0, self._published - floor)

    def live_conns(self) -> list:
        with self._cv:
            return [c for c in self._conns.values() if not c.closed]

    def shutdown(self) -> None:
        with self._cv:
            self._closing = True
            conns = list(self._conns.values())
            self._cv.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass
        for c in conns:
            try:
                c.close()
            except Exception:
                pass


class WireChannel:
    """Channel descriptor whose transport is a direct writer->reader
    wire connection. Pickles freely (readers dial `addr`); the writer
    endpoint only exists in the process that called serve_channel()."""

    transport = "wire"

    def __init__(self, name: str, capacity: int, n_readers: int,
                 depth: int, addr: Tuple[str, int], label: str = ""):
        self.name = name
        self.capacity = capacity
        self.n_readers = n_readers
        self.depth = max(1, int(depth))
        self.addr = tuple(addr)
        self.label = label or name[-6:]

    def writer(self) -> "WireChannelWriter":
        with _SERVERS_LOCK:
            srv = _SERVERS.get(self.name)
        if srv is None:
            raise RuntimeError(
                f"wire channel {self.name} has no server in this "
                f"process; the writer endpoint must live where "
                f"serve_channel() ran")
        return WireChannelWriter(self, srv)

    def reader(self, reader_index: int) -> "WireChannelReader":
        return WireChannelReader(self, reader_index)

    def destroy(self) -> None:
        with _SERVERS_LOCK:
            srv = _SERVERS.pop(self.name, None)
        if srv is not None:
            srv.shutdown()

    def __reduce__(self):
        return (WireChannel, (self.name, self.capacity, self.n_readers,
                              self.depth, self.addr, self.label))


def serve_channel(name: Optional[str] = None, capacity: int = 1 << 20,
                  n_readers: int = 1, depth: Optional[int] = None,
                  label: str = "") -> WireChannel:
    """Create the writer-side endpoint (listener + ring state) in THIS
    process and return the shippable descriptor readers dial."""
    from ray_tpu_torch._private.specs import SESSION_TAG
    depth = _ring_depth(depth)
    if name is None:
        name = f"rtt_{SESSION_TAG}_wch_{uuid.uuid4().hex[:12]}"
    srv = _WireChannelServer(name, capacity, n_readers, depth,
                             label or name[-6:])
    with _SERVERS_LOCK:
        _SERVERS[name] = srv
    return WireChannel(name, capacity, n_readers, depth,
                       (srv.host, srv.port), label)


def _apply_serve(_instance, name: str, capacity: int, n_readers: int,
                 depth: int, label: str) -> Tuple[str, int]:
    """__rtpu_apply__ escape-hatch body: bind a channel server inside
    an actor process (the DAG compiler runs this on each wire-edge
    producer before installing exec loops) and return its address."""
    ch = serve_channel(name, capacity, n_readers, depth, label)
    return ch.addr


class WireChannelWriter:
    def __init__(self, channel: WireChannel, srv: _WireChannelServer):
        self.ch = channel
        self._srv = srv
        self._seq = 0

    def _send(self, conns: list, value: Any, error: bool,
              seq: int) -> None:
        # capacity is advisory on this transport: the reader allocates
        # exactly the payload size, and ring depth (not slot size)
        # bounds in-flight memory.
        payload = None if error else _array_payload(value)
        blob = host = None
        for conn in conns:
            if payload is not None and conn.peer_speaks_channel():
                meta, body = payload
                if host is None:
                    host = _host_bytes(body)   # one D2H for all readers
                msg = {"type": CH_DATA, "seq": seq, "meta": meta,
                       RAW_KEY: [memoryview(host).cast("B")]}
                CH_STATS["tx_raw"] += 1
            else:
                if blob is None:
                    blob = cloudpickle.dumps(
                        value, protocol=pickle.HIGHEST_PROTOCOL)
                msg = {"type": CH_DATA, "seq": seq, "blob": blob,
                       "err": bool(error)}
                CH_STATS["tx_blob"] += 1
            try:
                conn.send(_tp.stamp(msg))
            except protocol.ConnectionClosed:
                raise ChannelClosed(
                    f"wire channel {self.ch.name}: reader "
                    f"disconnected mid-write") from None

    def write(self, value: Any, *, error: bool = False,
              timeout: Optional[float] = None) -> None:
        seq = self._seq + 1
        with _tp.span("channel", f"ch.wait:{self.ch.label}",
                      extra={"seq": seq, "transport": "wire"}):
            conns = self._srv.wait_writable(seq, timeout)
        with _tp.span("channel", f"ch.write:{self.ch.label}",
                      extra={"seq": seq, "transport": "wire"}):
            self._send(conns, value, error, seq)
        self._seq = seq
        self._srv._published = seq
        CH_STATS["writes"] += 1

    def write_bytes(self, data: bytes, *, error: bool = False,
                    timeout: Optional[float] = None) -> None:
        self.write(data, error=error, timeout=timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Push the closed marker. TCP delivers in order, so readers
        drain every published message before they see it (no slot to
        stomp — strictly safer than the shm close)."""
        for conn in self._srv.live_conns():
            try:
                conn.send({"type": CH_CLOSE, "name": self.ch.name})
            except protocol.ConnectionClosed:
                pass

    def release(self) -> None:
        """Shut the writer-side server down: listener, accept thread,
        reader connections. Called when the owning exec/stage loop
        exits so surviving actors don't leak sockets."""
        with _SERVERS_LOCK:
            _SERVERS.pop(self.ch.name, None)
        self._srv.shutdown()


class WireChannelReader:
    def __init__(self, channel: WireChannel, reader_index: int,
                 attach_timeout: Optional[float] = None):
        if not 0 <= reader_index < channel.n_readers:
            raise ValueError("reader_index out of range")
        from ray_tpu_torch._private.config import CONFIG
        self.ch = channel
        self.idx = reader_index
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._closed = False           # CH_CLOSE seen
        self._dead = False             # connection dropped
        self._conn = protocol.connect(
            channel.addr, self._handle, on_close=self._on_close,
            name=f"chan-{channel.label}-r{reader_index}")
        try:
            rep = self._conn.request(
                {"type": CH_ATTACH, "name": channel.name,
                 "reader": reader_index},
                timeout=(attach_timeout if attach_timeout is not None
                         else CONFIG.channel_wire_attach_timeout_s))
            if not rep.get("ok"):
                raise ChannelClosed(
                    f"wire channel attach refused: {rep.get('error')}")
        except BaseException:
            # a failed attach must not leak the dialed connection (and
            # its reader thread) — the caller never sees this endpoint
            self._conn.close()
            raise

    # ------------------------------------------------------- receiving
    def _handle(self, conn: protocol.Connection, msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == CH_DATA:
            with self._cv:
                self._queue.append(msg)
                self._cv.notify_all()
        elif mtype == CH_CLOSE:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def _on_close(self, conn: protocol.Connection) -> None:
        with self._cv:
            self._dead = True
            self._cv.notify_all()

    def _next(self, timeout: Optional[float]) -> dict:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        t0 = time.perf_counter_ns()
        try:
            with self._cv:
                while True:
                    if self._queue:
                        return self._queue.popleft()
                    if self._closed or self._dead:
                        raise ChannelClosed(self.ch.name)
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise ChannelTimeout(
                            f"timed out waiting for message on wire "
                            f"channel {self.ch.label}")
                    self._cv.wait(0.2 if remaining is None
                                  else min(remaining, 0.2))
        finally:
            CH_STATS["reader_wait_ns"] += time.perf_counter_ns() - t0

    def _land_raw(self, msg: dict):
        """One-memcpy landing: the C envelope parser handed us a
        zero-copy view of the frame's raw field; copy it GIL-released
        into a freshly allocated buffer (the r12 land discipline), then
        decode it as the shm reader does (a tensor that left a card
        lands on this process's card)."""
        import numpy as np
        meta = pickle.loads(msg["meta"])
        raw = msg.get(RAW_KEY, b"")      # the codec drops an empty field
        buf = np.empty(memoryview(raw).nbytes, dtype=np.uint8)
        from ray_tpu_torch import native
        if buf.nbytes:
            if native.available():
                native.buf_copy(buf, 0, raw)
            else:
                np.copyto(buf, np.frombuffer(raw, dtype=np.uint8))
        CH_STATS["rx_raw"] += 1
        CH_STATS["landed_bytes"] += buf.nbytes
        return _decode_payload(meta, buf, owned=True)

    def read(self, timeout: Optional[float] = None) -> Any:
        with _tp.span("channel", f"ch.read:{self.ch.label}",
                      extra={"transport": "wire"}):
            msg = self._next(timeout)
            raw = "meta" in msg
            if raw:
                value = self._land_raw(msg)
            else:
                value = pickle.loads(msg["blob"])
                CH_STATS["rx_blob"] += 1
            try:
                self._conn.send({"type": CH_ACK, "name": self.ch.name,
                                 "reader": self.idx,
                                 "seq": int(msg["seq"])})
            except protocol.ConnectionClosed:
                pass               # writer gone: its flow control is moot
            CH_STATS["reads"] += 1
        if not raw and msg.get("err"):
            # mirror the shm reader: error frames carry a pickled repr
            shown = value
            if isinstance(shown, (bytes, bytearray)):
                try:
                    shown = pickle.loads(shown)
                except Exception:
                    pass
            raise RuntimeError(f"upstream DAG node failed: {shown}")
        return value

    def read_bytes(self, timeout: Optional[float] = None) -> bytes:
        value = self.read(timeout)
        if not isinstance(value, (bytes, bytearray)):
            raise RuntimeError(
                "read_bytes on a non-bytes wire-channel frame")
        return bytes(value)

    def release(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass
