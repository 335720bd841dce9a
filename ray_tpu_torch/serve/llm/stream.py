"""Push token transport: tokens ride peer-dialed framed connections.

Port of `ray_tpu/serve/llm/stream.py`. The engine opens its own
listener (an accept loop and one `protocol.Connection` per consumer);
consumers dial it once per engine through `dial_cached` and send one
`llm_sub` frame per request. After that every token is a server-PUSHED
`llm_tok` frame on that connection: the consumer polls nothing.

Fencing: every frame carries the engine's incarnation and the request's
attempt number. The client registered an expectation at subscribe time;
stale frames (a zombie engine still decoding, or a frame from a
superseded attempt after failover) are counted and dropped, never
delivered. Duplicate suppression uses the `base` sequence offset:
subscribe replays the backlog from the client's cursor, and overlap
trimming makes replay and live frames racing harmless. Unlike the JAX
server, a subscriber's live frames wait until its replay is sent, so a
consumer never sees a frame start past its cursor, and a subscription
whose replay is final (an unknown rid, or a request already done) is
dropped at once instead of when its connection closes.

Wire frames use "req" for the request id ("rid" is the connection's own
reply-id field):
  client -> engine  {"type": "llm_sub", "req", "cursor"}
                    {"type": "llm_unsub", "req"}
  engine -> client  {"type": "llm_tok", "req", "inc", "attempt",
                     "base", "toks", "done", "reason", "err"}
                    ("unknown": True when the rid isn't on this engine:
                    the consumer fails over)

The frames ride the runtime's `protocol.Connection` and its versioned
protobuf codec (`_private/wire.py`), as the JAX stream's do. The
listener binds the address it advertises: the source address of the
process's runtime connection inside a worker, loopback outside one.
"""
from __future__ import annotations

import socket
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import context as _context
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.direct_actor import dial_cached

STREAM_STATS = {
    "frames_out": 0,        # server: token frames pushed
    "frames_in": 0,         # client: token frames received
    "tokens_in": 0,         # client: tokens accepted
    "zombie_dropped": 0,    # client: frames fenced (stale inc/attempt)
}


class TokenStreamServer:
    """Engine-side push fan-out; `publish` is called by the engine's
    step thread with each step's events."""

    def __init__(self, incarnation: str,
                 backlog: Callable[[str, int], Optional[dict]]):
        self._inc = incarnation
        self._backlog = backlog
        self._lock = threading.Lock()
        # rid -> list of [conn, sent_cursor, held records or None once
        # the subscriber's replay is sent]
        self._subs: Dict[str, List[list]] = {}
        self._conns: List[protocol.Connection] = []
        self._host = _advertise_host()
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self._host, 0))
        lsock.listen(64)
        self._lsock = lsock
        self._port = lsock.getsockname()[1]
        self._closed = threading.Event()
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          name="llm-stream-accept",
                                          daemon=True)
        self._acceptor.start()

    @property
    def addr(self) -> Tuple[str, int]:
        return (self._host, self._port)

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _ = self._lsock.accept()
            except OSError:
                return
            conn = protocol.Connection(sock, self._handle,
                                       on_close=self._on_close,
                                       name="llm-stream", server=True)
            with self._lock:
                self._conns.append(conn)
            conn.start()

    def _on_close(self, conn) -> None:
        with self._lock:
            self._conns = [c for c in self._conns if c is not conn]
            for rid in list(self._subs):
                self._drop_locked(rid, lambda s: s[0] is conn)

    def _handle(self, conn, msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == "llm_sub":
            rid = msg["req"]
            cursor = int(msg.get("cursor", 0))
            # Register FIRST, replay second, so a step published between
            # the two is in the replay or in `held`, never in neither.
            # Until the replay is sent the subscriber is held: its live
            # records wait, so no live frame can overtake the replay and
            # reach the consumer past its cursor (the consumer drops such
            # a frame as a gap).
            sub = [conn, cursor, []]
            with self._lock:
                self._subs.setdefault(rid, []).append(sub)
            back = self._backlog(rid, cursor)
            with self._lock:
                held, sub[2] = sub[2], None
                final = back is None or back["done"]
                if final:
                    # the replay is rid's last frame: nothing is published
                    # for it again, so the entry goes now, not when the
                    # consumer's connection closes
                    self._drop_locked(rid, lambda s: s is sub)
                if back is None:
                    self._send(conn, {"type": "llm_tok", "req": rid,
                                      "inc": self._inc, "unknown": True,
                                      "attempt": -1, "base": cursor,
                                      "toks": [], "done": True,
                                      "reason": None, "err": "unknown_rid"})
                    return
                if back["toks"] or back["done"]:
                    self._send(conn, {"type": "llm_tok", "req": rid,
                                      "inc": self._inc,
                                      "attempt": back["attempt"],
                                      "base": back["base"],
                                      "toks": back["toks"],
                                      "done": back["done"],
                                      "reason": back["reason"],
                                      "err": back["err"]})
                    sub[1] = max(sub[1], back["base"] + len(back["toks"]))
                if final:
                    return
                for rec in held:
                    self._push(sub, rid, rec)
        elif mtype == "llm_unsub":
            with self._lock:
                self._drop_locked(msg["req"], lambda s: s[0] is conn)
        elif mtype == protocol.PING:
            conn.reply(msg, ok=True)

    def _drop_locked(self, rid: str, gone: Callable[[list], bool]) -> None:
        """Unregister rid's subscriptions for which `gone` holds; the
        caller holds the lock."""
        subs = [s for s in self._subs.get(rid, ()) if not gone(s)]
        if subs:
            self._subs[rid] = subs
        else:
            self._subs.pop(rid, None)

    def _send(self, conn, frame: dict) -> None:
        try:
            conn.send(frame)
            STREAM_STATS["frames_out"] += 1
        except protocol.ConnectionClosed:
            pass

    def publish(self, events: List[dict]) -> None:
        """Push one step's events, grouped per rid into one frame (a
        step emits at most one token per sequence, but a drain or a
        failure can batch terminals)."""
        per_rid: Dict[str, dict] = {}
        for ev in events:
            rec = per_rid.setdefault(
                ev["rid"], {"base": ev["seq"], "toks": [],
                            "done": False, "reason": None, "err": None,
                            "attempt": ev["attempt"]})
            if ev["token"] is not None:
                rec["toks"].append(ev["token"])
            if ev["done"]:
                rec["done"] = True
                rec["reason"] = ev["reason"]
                rec["err"] = ev.get("err")
        for rid, rec in per_rid.items():
            with self._lock:
                live = []
                for sub in self._subs.get(rid, ()):
                    if sub[2] is None:
                        live.append(sub)
                    else:
                        sub[2].append(rec)       # replay not sent yet
            for sub in live:
                self._push(sub, rid, rec)
            if rec["done"]:
                with self._lock:
                    self._subs.pop(rid, None)

    def _push(self, sub: list, rid: str, rec: dict) -> None:
        """Send `rec` to one subscriber, less what it was already sent."""
        conn, sent = sub[0], sub[1]
        base, toks = rec["base"], rec["toks"]
        if sent > base:
            # replay already covered part of this frame
            skip = min(sent - base, len(toks))
            base, toks = base + skip, toks[skip:]
            if not toks and not rec["done"]:
                return
        self._send(conn, {"type": "llm_tok", "req": rid, "inc": self._inc,
                          "attempt": rec["attempt"], "base": base,
                          "toks": toks, "done": rec["done"],
                          "reason": rec["reason"], "err": rec["err"]})
        sub[1] = base + len(toks)

    def close(self) -> None:
        """Stop accepting and close every connection. The accept thread
        holds the engine (through `backlog`), so it must end here: a
        blocked accept wakes on shutdown, not on close."""
        self._closed.set()
        try:
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._lsock.close()
        if threading.current_thread() is not self._acceptor:
            self._acceptor.join()
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            c.close()


class StreamClient:
    """Consumer-side demux: one cached connection per engine endpoint
    (shared across requests, `dial_cached`), frames routed to
    per-request sinks with incarnation/attempt fencing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conns: Dict[tuple, protocol.Connection] = {}
        # rid -> (sink, expect_inc, expect_attempt, addr)
        self._routes: Dict[str, tuple] = {}

    def subscribe(self, addr: Tuple[str, int], rid: str,
                  expect_inc: str, expect_attempt: int,
                  cursor: int, sink) -> bool:
        """Route rid's frames from `addr` into `sink` (a Queue); returns
        False when the endpoint is unreachable (the caller fails over).
        Re-subscribing the same rid (failover to a new engine or a new
        attempt) replaces the route and its fence."""
        addr = (addr[0], int(addr[1]))
        with self._lock:
            self._routes[rid] = (sink, expect_inc, int(expect_attempt),
                                 addr)
        conn = dial_cached(self._conns, self._lock, addr,
                           handler=self._on_msg, on_close=self._on_close)
        if conn is None:
            with self._lock:
                self._routes.pop(rid, None)
            return False
        try:
            conn.send({"type": "llm_sub", "req": rid,
                       "cursor": int(cursor)})
        except protocol.ConnectionClosed:
            with self._lock:
                self._routes.pop(rid, None)
            return False
        return True

    def unsubscribe(self, rid: str) -> None:
        with self._lock:
            route = self._routes.pop(rid, None)
            conn = self._conns.get(route[3]) if route else None
        if conn is not None and not conn.closed:
            try:
                conn.send({"type": "llm_unsub", "req": rid})
            except protocol.ConnectionClosed:
                pass

    def _on_msg(self, conn, msg: dict) -> None:
        if msg.get("type") != "llm_tok":
            return
        STREAM_STATS["frames_in"] += 1
        rid = msg.get("req")
        with self._lock:
            route = self._routes.get(rid)
        if route is None:
            return
        sink, inc, attempt, _addr = route
        if not msg.get("unknown") and (msg.get("inc") != inc
                                       or msg.get("attempt") != attempt):
            # zombie fence: a stale incarnation or a superseded attempt
            # never reaches the consumer
            STREAM_STATS["zombie_dropped"] += 1
            return
        STREAM_STATS["tokens_in"] += len(msg.get("toks", ()))
        sink.put(msg)

    def _on_close(self, conn) -> None:
        with self._lock:
            dead = [a for a, c in self._conns.items() if c is conn]
            for a in dead:
                self._conns.pop(a, None)
            victims = [(rid, r) for rid, r in self._routes.items()
                       if r[3] in dead]
            for rid, _r in victims:
                self._routes.pop(rid, None)
        for rid, (sink, _i, _a, _ad) in victims:
            sink.put({"type": "llm_closed", "rid": rid})


_client: Optional[StreamClient] = None
_client_lock = threading.Lock()


def stream_client() -> StreamClient:
    """Process-wide client (one connection per engine, shared by every
    in-flight request in this process)."""
    global _client
    with _client_lock:
        if _client is None:
            _client = StreamClient()
        return _client


def _advertise_host() -> str:
    """Host this process's listeners are reachable at: the source
    address of the runtime connection when the process has a context,
    else loopback."""
    ctx = _context.maybe_ctx()
    sock = getattr(getattr(ctx, "conn", None), "_sock", None)
    if sock is not None:
        return sock.getsockname()[0]
    return "127.0.0.1"
