"""ActorPool: load-balanced task fan-out over a fixed set of actors.

Parity: reference python/ray/util/actor_pool.py (ActorPool — map,
map_unordered, submit, get_next, get_next_unordered, has_next,
push/pop_idle). Submission past pool width queues host-side and
dispatches as actors free up (claimed results recycle their actor).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor: dict[str, Any] = {}   # oid -> (actor, ref)
        self._index_to_future: dict[int, Any] = {}
        self._pending: deque = deque()               # (fn, value)
        self._claimed_early: dict[str, Any] = {}     # done, actor recycled
        self._next_task_index = 0
        self._next_return_index = 0

    # ------------------------------------------------------------- map
    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        """Ordered map: fn(actor, value) -> ObjectRef per value; results
        yielded in input order with pool-width parallelism."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ---------------------------------------------------------- submit
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        if self._idle:
            self._dispatch(fn, value)
        else:
            self._pending.append((fn, value))

    def _dispatch(self, fn, value) -> None:
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref.object_id] = (actor, ref)
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def _recycle(self, actor) -> None:
        self._idle.append(actor)
        while self._pending and self._idle:
            fn, value = self._pending.popleft()
            self._dispatch(fn, value)

    # ----------------------------------------------------------- fetch
    def has_next(self) -> bool:
        return bool(self._future_to_actor or self._pending
                    or self._claimed_early)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        while True:
            # slots claimed by get_next_unordered are gone: skip them
            while (self._next_return_index < self._next_task_index
                   and self._next_return_index
                   not in self._index_to_future):
                self._next_return_index += 1
            if self._next_return_index in self._index_to_future:
                break
            # next task not dispatched yet (queued behind busy actors):
            # drain one completion to free an actor
            self._drain_one(timeout)
        ref = self._index_to_future.pop(self._next_return_index)
        self._next_return_index += 1
        value = ray_tpu_torch.get(ref, timeout=timeout)
        entry = self._future_to_actor.pop(ref.object_id, None)
        if entry is not None:
            self._recycle(entry[0])
        else:
            self._claimed_early.pop(ref.object_id, None)
        return value

    def _drain_one(self, timeout: Optional[float]) -> None:
        refs = [ref for _, ref in self._future_to_actor.values()]
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        actor, ref = self._future_to_actor[ready[0].object_id]
        # don't claim the result; just free capacity for queued submits
        del self._future_to_actor[ref.object_id]
        self._claimed_early[ref.object_id] = ref
        self._recycle(actor)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        if self._claimed_early:
            oid, ref = next(iter(self._claimed_early.items()))
            del self._claimed_early[oid]
        else:
            refs = [ref for _, ref in self._future_to_actor.values()]
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
            if not ready:
                raise TimeoutError("no result within timeout")
            ref = ready[0]
            actor, _ = self._future_to_actor.pop(ref.object_id)
            self._recycle(actor)
        # drop its ordered slot and advance past claimed gaps
        for idx, f in list(self._index_to_future.items()):
            if f.object_id == ref.object_id:
                del self._index_to_future[idx]
                break
        return ray_tpu_torch.get(ref)

    # ------------------------------------------------------- idle mgmt
    def push(self, actor: Any) -> None:
        """Add an idle actor to the pool (reference push)."""
        self._recycle(actor)

    def pop_idle(self) -> Optional[Any]:
        return self._idle.pop() if self._idle else None

    @property
    def num_idle(self) -> int:
        return len(self._idle)

    @property
    def num_pending(self) -> int:
        return len(self._future_to_actor) + len(self._pending)
