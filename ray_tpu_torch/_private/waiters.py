"""Event-driven waiter registry: blocked gets/waits without threads.

Replaces the thread-per-blocked-request model (one Python thread parked
in ``store.get_stored(timeout=...)`` per outstanding worker ``get``/
``wait``) with a registry serviced on object-seal events: the store
fires ``on_seal(object_id)`` when an object lands, and the registry
resolves every waiter watching that id on the sealing thread. A single
timer thread sweeps deadlines. This is the reference's model — raylet
``WaitManager`` (reference src/ray/raylet/wait_manager.cc) and the
core-worker memory store's ``GetAsync`` callbacks are both
notification-driven, not thread-parked — and is what lets one node hold
thousands of blocked workers (BASELINE.md: 1M queued tasks) without a
thread explosion.

Two waiter kinds:
- get: one object id; resolved with the StoredObject (or a location
  miss -> timeout reply).
- wait: N ids, ``num_returns`` threshold; re-evaluated whenever any
  watched id seals; resolved with the ready list.

The registry is presence-agnostic: ``present_fn(oid)`` decides what
"ready" means (the single-host runtime uses store residency; the
multi-host runtime ORs in remote-location knowledge), and
``resolve_fn(waiter)`` builds + sends the reply, so the same registry
serves both topologies.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(eq=False)          # identity hash: waiters live in sets
class GetWaiter:
    oid: str
    reply: Callable[["GetWaiter", bool], None]   # (waiter, timed_out)
    deadline: Optional[float]
    on_done: Optional[Callable[[], None]] = None  # unblock bookkeeping
    seq: int = 0
    resolved: bool = False


@dataclass(eq=False)
class WaitWaiter:
    ids: list[str]
    num_returns: int
    reply: Callable[["WaitWaiter", list[str]], None]  # (waiter, ready)
    deadline: Optional[float]
    on_done: Optional[Callable[[], None]] = None
    seq: int = 0
    resolved: bool = False


class WaiterRegistry:
    def __init__(self, present_fn: Callable[[str], bool]):
        self._present = present_fn
        from ray_tpu_torch._private.debug_sync import make_lock
        self._lock = make_lock("waiters")
        self._by_oid: dict[str, set] = {}
        self._heap: list[tuple[float, int, object]] = []
        self._seq = itertools.count()
        self._cv = threading.Condition(self._lock)
        self._running = True
        self._timer = threading.Thread(target=self._timer_loop,
                                       name="ray-tpu-waiters", daemon=True)
        self._timer.start()

    # ------------------------------------------------------------ add
    def add_get(self, oid: str, reply, timeout: Optional[float],
                on_done=None) -> None:
        """Register a get waiter; resolves immediately if present."""
        w = GetWaiter(oid=oid, reply=reply,
                      deadline=(None if timeout is None
                                else time.monotonic() + timeout),
                      on_done=on_done, seq=next(self._seq))
        fire = None        # resolved immediately: reply OUTSIDE the lock
        with self._cv:
            if not self._running:
                fire = lambda: reply(w, True)  # noqa: E731
            else:
                # register-then-check closes the probe/seal race: a seal
                # between our presence check and registration would be
                # lost the other way around.
                self._by_oid.setdefault(oid, set()).add(w)
                if self._present(oid):
                    self._unlink_locked(w)
                    fire = lambda: reply(w, False)  # noqa: E731
                elif w.deadline is not None:
                    heapq.heappush(self._heap, (w.deadline, w.seq, w))
                    self._cv.notify()
        if fire is not None:
            self._finish(w, fire)

    def add_wait(self, ids: list[str], num_returns: int, reply,
                 timeout: Optional[float], on_done=None) -> None:
        w = WaitWaiter(ids=list(ids), num_returns=num_returns, reply=reply,
                       deadline=(None if timeout is None
                                 else time.monotonic() + timeout),
                       on_done=on_done, seq=next(self._seq))
        fire = None
        with self._cv:
            if not self._running:
                fire = lambda: reply(w, [])  # noqa: E731
            else:
                for oid in w.ids:
                    self._by_oid.setdefault(oid, set()).add(w)
                ready = [o for o in w.ids if self._present(o)]
                if len(ready) >= num_returns or num_returns <= 0:
                    self._unlink_locked(w)
                    fire = lambda: reply(w, ready)  # noqa: E731
                elif w.deadline is not None:
                    heapq.heappush(self._heap, (w.deadline, w.seq, w))
                    self._cv.notify()
        if fire is not None:
            self._finish(w, fire)

    # --------------------------------------------------------- notify
    def notify(self, oid: str) -> None:
        """An object sealed (or its remote location registered):
        resolve every waiter whose condition is now met. Runs on the
        sealing thread; replies are socket sends."""
        # Lock-free fast path: most seals have no waiters. Safe against
        # a concurrent registration because add_get/add_wait re-check
        # presence under their own lock AFTER inserting the waiter, and
        # the store already sealed the object before calling us.
        if oid not in self._by_oid:
            return
        done: list[tuple[object, Callable]] = []
        with self._lock:
            waiters = self._by_oid.get(oid)
            if not waiters:
                return
            for w in list(waiters):
                if w.resolved:
                    continue
                if isinstance(w, GetWaiter):
                    self._unlink_locked(w)
                    done.append((w, (lambda w=w: w.reply(w, False))))
                else:
                    ready = [o for o in w.ids if self._present(o)]
                    if len(ready) >= w.num_returns:
                        self._unlink_locked(w)
                        done.append(
                            (w, (lambda w=w, r=ready: w.reply(w, r))))
        for w, fn in done:
            self._finish(w, fn)

    # ---------------------------------------------------------- timer
    def _timer_loop(self) -> None:
        while True:
            expired: list[tuple[object, Callable]] = []
            with self._cv:
                if not self._running:
                    return
                now = time.monotonic()
                while self._heap and self._heap[0][0] <= now:
                    _, _, w = heapq.heappop(self._heap)
                    if w.resolved:
                        continue
                    self._unlink_locked(w)
                    if isinstance(w, GetWaiter):
                        expired.append((w, (lambda w=w: w.reply(w, True))))
                    else:
                        ready = [o for o in w.ids if self._present(o)]
                        expired.append(
                            (w, (lambda w=w, r=ready: w.reply(w, r))))
                timeout = (self._heap[0][0] - now) if self._heap else None
                if not expired:
                    self._cv.wait(timeout=timeout)
            for w, fn in expired:
                self._finish(w, fn)

    # -------------------------------------------------------- helpers
    def _unlink_locked(self, w) -> None:
        w.resolved = True
        ids = [w.oid] if isinstance(w, GetWaiter) else w.ids
        for oid in ids:
            s = self._by_oid.get(oid)
            if s is not None:
                s.discard(w)
                if not s:
                    self._by_oid.pop(oid, None)

    def _finish(self, w, fn: Callable) -> None:
        try:
            fn()
        except Exception:
            pass
        if w.on_done is not None:
            try:
                w.on_done()
            except Exception:
                pass

    def stats(self) -> dict:
        with self._lock:
            return {"watched_ids": len(self._by_oid),
                    "pending_timeouts": len(self._heap)}

    def shutdown(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
