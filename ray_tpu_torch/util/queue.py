"""Distributed FIFO queue backed by an actor.

The counterpart of `ray_tpu/util/queue.py`, on the port's runtime.

Parity: reference python/ray/util/queue.py (Queue over an asyncio
_QueueActor: put/get with block+timeout, qsize/empty/full,
put_nowait/get_nowait, shutdown). Blocking semantics live inside the
actor via a threading.Condition + max_concurrency, so producers and
consumers in different processes coordinate without driver polling.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._maxsize = maxsize
        self._q: deque = deque()
        self._cv = threading.Condition()

    def ping(self):
        return "pong"

    def qsize(self) -> int:
        with self._cv:
            return len(self._q)

    # NOTE on blocking: actor-side waits are capped at a SHORT slice
    # (clients loop until their own deadline). An unbounded wait would
    # park one of the actor's max_concurrency threads per blocked
    # producer/consumer — enough blocked producers would starve every
    # consumer RPC and deadlock the queue.
    _SLICE_S = 0.2

    def put(self, item: Any, block: bool, timeout: Optional[float]) -> bool:
        with self._cv:
            if self._maxsize > 0 and len(self._q) >= self._maxsize:
                if not block:
                    return False
                slice_s = self._SLICE_S if timeout is None else min(
                    self._SLICE_S, timeout)
                if not self._cv.wait_for(
                        lambda: len(self._q) < self._maxsize,
                        timeout=slice_s):
                    return False
            self._q.append(item)
            self._cv.notify_all()
            return True

    def get(self, block: bool, timeout: Optional[float]):
        with self._cv:
            if not self._q:
                if not block:
                    return False, None
                slice_s = self._SLICE_S if timeout is None else min(
                    self._SLICE_S, timeout)
                if not self._cv.wait_for(lambda: bool(self._q),
                                         timeout=slice_s):
                    return False, None
            item = self._q.popleft()
            self._cv.notify_all()
            return True, item

    def get_batch(self, max_items: int):
        with self._cv:
            out = []
            while self._q and len(out) < max_items:
                out.append(self._q.popleft())
            self._cv.notify_all()
            return out


class Queue:
    """Cross-process FIFO; share the Queue object with tasks/actors
    (it pickles as a handle to the same queue actor)."""

    def __init__(self, maxsize: int = 0,
                 actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 8)
        self._actor = ray_tpu_torch.remote(**opts)(_QueueActor).remote(maxsize)
        ray_tpu_torch.get(self._actor.ping.remote())
        self._maxsize = maxsize

    # picklable: workers reconstruct around the same actor handle
    def __reduce__(self):
        return (_rebuild_queue, (self._actor, self._maxsize))

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        import time
        deadline = None if timeout is None else time.time() + timeout
        while True:
            left = None if deadline is None else deadline - time.time()
            ok = ray_tpu_torch.get(self._actor.put.remote(item, block, left))
            if ok:
                return
            if not block or (deadline is not None
                             and time.time() >= deadline):
                raise Full("queue full")

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        import time
        deadline = None if timeout is None else time.time() + timeout
        while True:
            left = None if deadline is None else deadline - time.time()
            ok, item = ray_tpu_torch.get(self._actor.get.remote(block, left))
            if ok:
                return item
            if not block or (deadline is not None
                             and time.time() >= deadline):
                raise Empty("queue empty")

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, max_items: int) -> List[Any]:
        return ray_tpu_torch.get(self._actor.get_batch.remote(max_items))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self._maxsize > 0 and self.qsize() >= self._maxsize

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self._actor)
        except BaseException:
            pass


def _rebuild_queue(actor, maxsize):
    q = object.__new__(Queue)
    q._actor = actor
    q._maxsize = maxsize
    return q
