"""Pubsub: cursor-based channels on the control plane.

Parity: reference src/ray/pubsub (long-poll publisher/subscriber used
for actor/node/error channels) — re-shaped for this topology: the
driver-resident `Publisher` keeps a bounded ring per channel; consumers
poll with a cursor (workers via the STATE_OP RPC, driver-side readers
directly), which gives the same at-least-once-in-order contract the
reference's long-poll delivers without a push socket per subscriber.

Wired publications: node lifecycle (cluster) and actor lifecycle
(controller) — the channels the reference's GCS publishes.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# Well-known channels (reference rpc::ChannelType)
NODE_CHANNEL = "node"
ACTOR_CHANNEL = "actor"
ERROR_CHANNEL = "error"


class StaleCursorError(Exception):
    """The cursor predates the retained window: messages were evicted
    and are unrecoverable (the caller must resync its view). The
    ``resync`` attribute carries the current head seq to restart from."""

    def __init__(self, msg: str, resync: int = 0):
        super().__init__(msg)
        self.resync = resync


class Publisher:
    def __init__(self, maxlen_per_channel: int = 1000):
        self._lock = threading.Condition()
        self._maxlen = maxlen_per_channel
        # channel -> (next_seq, ring of (seq, ts, message))
        self._channels: Dict[str, Tuple[int, deque]] = {}
        # Async long-poll waiters: (channel, cursor, deadline, cb).
        # publish() resolves matching waiters inline; a lazy timer
        # thread expires the rest — so a remote subscriber's long-poll
        # parks HERE instead of blocking its connection reader thread
        # (the reference's long-poll is equally push-resolved).
        self._waiters: List[tuple] = []
        self._timer_started = False
        self._stopped = False

    def publish(self, channel: str, message: Any) -> int:
        fire: List[tuple] = []
        with self._lock:
            seq, ring = self._channels.get(channel, (0, None))
            if ring is None:
                ring = deque(maxlen=self._maxlen)
            ring.append((seq, time.time(), message))
            self._channels[channel] = (seq + 1, ring)
            if self._waiters:
                keep = []
                for w in self._waiters:
                    ch, cursor, _deadline, cb = w
                    if ch == channel:
                        msgs = [m for s, _, m in ring if s >= cursor]
                        fire.append((cb, msgs, seq + 1))
                    else:
                        keep.append(w)
                self._waiters = keep
            self._lock.notify_all()
        for cb, msgs, cur in fire:       # outside the lock: cb sends
            try:
                cb(msgs, cur)
            except Exception:
                pass
        return seq

    def add_waiter(self, channel: str, cursor: int, timeout: float,
                   cb) -> None:
        """Async long-poll: cb(messages, next_cursor) fires when a
        message lands on `channel` (or immediately if one is already
        past `cursor`), or with ([], cursor) at the timeout. Raises
        StaleCursorError synchronously like poll() — the at-least-once
        contract must not silently skip evicted messages."""
        with self._lock:
            seq, ring = self._channels.get(channel, (0, None))
            if ring and cursor < ring[0][0]:
                raise StaleCursorError(
                    f"channel {channel!r}: cursor {cursor} predates "
                    f"oldest retained seq {ring[0][0]}", resync=seq)
            msgs = ([m for s, _, m in ring if s >= cursor]
                    if ring is not None else [])
            if msgs:
                now_cur = seq
            else:
                self._waiters.append(
                    (channel, cursor, time.time() + timeout, cb))
                if not self._timer_started:
                    self._timer_started = True
                    threading.Thread(target=self._expire_loop,
                                     name="rtpu-pubsub-expire",
                                     daemon=True).start()
                return
        try:
            cb(msgs, now_cur)
        except Exception:
            pass

    def close(self) -> None:
        """Fail outstanding waiters and stop the expire thread."""
        with self._lock:
            self._stopped = True
            waiters, self._waiters = self._waiters, []
        for _ch, cursor, _dl, cb in waiters:
            try:
                cb([], cursor)
            except Exception:
                pass

    def _expire_loop(self) -> None:
        idle_ticks = 0
        while True:
            time.sleep(0.5)
            now = time.time()
            expired: List[tuple] = []
            with self._lock:
                if getattr(self, "_stopped", False):
                    return
                if not self._waiters:
                    idle_ticks += 1
                    if idle_ticks >= 20:
                        # 10s with nothing to expire: park; a future
                        # add_waiter restarts the thread (under lock)
                        self._timer_started = False
                        return
                    continue
                idle_ticks = 0
                keep = []
                for w in self._waiters:
                    if w[2] <= now:
                        expired.append(w)
                    else:
                        keep.append(w)
                self._waiters = keep
            for _ch, cursor, _dl, cb in expired:
                try:
                    cb([], cursor)
                except Exception:
                    pass

    def poll(self, channel: str, cursor: int = 0,
             timeout: Optional[float] = None
             ) -> Tuple[List[Any], int]:
        """Messages with seq >= cursor and the next cursor. With a
        timeout, blocks until at least one message lands (long-poll)."""
        deadline = None if timeout is None else time.time() + timeout

        def fetch():
            seq, ring = self._channels.get(channel, (0, None))
            if ring is None:
                return [], 0
            if ring and cursor < ring[0][0]:
                # at-least-once contract: never silently skip evicted
                # messages — the subscriber fell too far behind
                raise StaleCursorError(
                    f"channel {channel!r}: cursor {cursor} predates "
                    f"oldest retained seq {ring[0][0]}", resync=seq)
            msgs = [(s, m) for s, _, m in ring if s >= cursor]
            return msgs, seq

        with self._lock:
            msgs, next_cursor = fetch()
            while not msgs and deadline is not None:
                left = deadline - time.time()
                if left <= 0:
                    break
                self._lock.wait(timeout=min(left, 0.25))
                msgs, next_cursor = fetch()
            return [m for _, m in msgs], max(next_cursor, cursor)

    def current_seq(self, channel: str) -> int:
        """Next sequence number for `channel` (resync point)."""
        with self._lock:
            return self._channels.get(channel, (0, None))[0]

    def channels(self) -> List[str]:
        with self._lock:
            return sorted(self._channels)
