"""Striped (sharded) head-side hot tables (r16).

At 100k in-flight tasks the head's bookkeeping dominates per-task
cost not because any single operation is slow but because every
submit/done/decref convoys through one reentrant controller lock over
three monolithic dicts (ref/pin table, live-task spec mirror, object
directory). This module gives each table N independent stripes keyed
by task/object id, each guarded by a plain ``threading.Lock`` whose
critical section touches only that stripe's dict — submits on the
driver thread, completions on the poller thread, and decref storms on
the flusher thread stop serializing against each other, and each
acquisition is a cheap non-reentrant lock instead of an RLock.

Resident state stays bounded: a ref entry whose refcount AND pin
count are both zero is evicted from its stripe (the old
``defaultdict`` kept a zero-pin entry for every object ever probed),
terminal tasks pop their live-task entry eagerly (as before), and the
lineage mirror — the one table with no natural terminal event while
refs stay live — takes an explicit FIFO entry cap
(``RAY_TPU_HEAD_LINEAGE_MAX``).

Head-HA composition (the r15 WAL): mutate+log pairs no longer share
one controller-lock region with the snapshot's frontier capture, so
the invariant is restated per stripe:

- every table mutation completes (and its stripe lock is released)
  BEFORE its WAL record is appended, and
- ``snapshot_state`` captures the WAL frontier BEFORE capturing any
  striped table.

A record at seq <= frontier was therefore appended before the
frontier capture, which means its mutation's stripe critical section
began before the capture and the (later) stripe capture observes it;
a record at seq > frontier replays — and every record is
set-semantics, so a mutation that is BOTH captured and replayed
converges. Order-sensitive values (the absolute refcount/pin pairs)
additionally log from INSIDE their stripe lock so two racing decrefs
of one object can never log out of mutation order.

Contention observability: each acquisition first tries a non-blocking
acquire; a failure bumps the stripe's contention counter before
falling back to the blocking path, so ``/metrics`` can show whether
the stripes actually spread load (``ray_tpu_head_shard_*``).

``RAY_TPU_HEAD_SHARDS=0`` (or 1) reverts every table to a single
stripe — the pre-r16 one-dict-one-lock topology, minus the RLock.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional


def stripe_count() -> int:
    """Configured stripe count, rounded up to a power of two (the
    stripe index is ``hash(key) & (n - 1)``). 0/1 reverts to one
    stripe."""
    from ray_tpu_torch._private.config import CONFIG
    n = int(CONFIG.head_shards)
    if n <= 1:
        return 1
    p = 1
    while p < n:
        p <<= 1
    return p


class _Striped:
    """Shared stripe machinery: lock array, dict array, contention
    counters. Subclasses hold entry-shape-specific logic."""

    __slots__ = ("n", "_mask", "_locks", "_maps", "contended")

    def __init__(self, n: Optional[int] = None):
        self.n = stripe_count() if n is None else max(1, int(n))
        self._mask = self.n - 1
        self._locks = [threading.Lock() for _ in range(self.n)]
        self._maps: list[dict] = [{} for _ in range(self.n)]
        # plain-int bumps (GIL-coherent enough for gauges)
        self.contended = [0] * self.n

    def _acquire(self, i: int) -> threading.Lock:
        lk = self._locks[i]
        if not lk.acquire(False):
            self.contended[i] += 1
            lk.acquire()
        return lk

    def _idx(self, key) -> int:
        return hash(key) & self._mask

    def __len__(self) -> int:
        return sum(len(m) for m in self._maps)

    def stats(self) -> dict:
        sizes = [len(m) for m in self._maps]
        return {"stripes": self.n, "entries": sum(sizes),
                "max_stripe": max(sizes), "contended": sum(self.contended)}


class StripedMap(_Striped):
    """Striped key -> value map (live-task spec mirror, lineage).

    ``log`` hooks run while the stripe lock is HELD only where value
    ordering demands it (none of the map users do); mutate-then-log
    call sites sequence the append after the mutation instead — see
    the module docstring for why that is sufficient.

    ``max_entries`` bounds resident state with per-stripe FIFO
    eviction (dict insertion order; evicted keys are reported to the
    optional ``on_evict`` so callers can count them). 0 = unbounded.
    """

    __slots__ = ("_cap", "on_evict", "evicted")

    def __init__(self, n: Optional[int] = None, max_entries: int = 0,
                 on_evict: Optional[Callable[[str, Any], None]] = None):
        super().__init__(n)
        self._cap = max(0, int(max_entries))
        self.on_evict = on_evict
        self.evicted = 0

    def _stripe_cap(self) -> int:
        return (self._cap + self.n - 1) // self.n if self._cap else 0

    def put(self, key, value) -> None:
        i = self._idx(key)
        evicted = []
        lk = self._acquire(i)
        try:
            m = self._maps[i]
            m[key] = value
            cap = self._stripe_cap()
            while cap and len(m) > cap:
                old = next(iter(m))
                evicted.append((old, m.pop(old)))
        finally:
            lk.release()
        if evicted:
            self.evicted += len(evicted)
            if self.on_evict is not None:
                for k, v in evicted:
                    self.on_evict(k, v)

    def get(self, key, default=None):
        i = self._idx(key)
        lk = self._acquire(i)
        try:
            return self._maps[i].get(key, default)
        finally:
            lk.release()

    def pop(self, key, default=None):
        i = self._idx(key)
        lk = self._acquire(i)
        try:
            return self._maps[i].pop(key, default)
        finally:
            lk.release()

    def __contains__(self, key) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def keys(self) -> list:
        out: list = []
        for i in range(self.n):
            lk = self._acquire(i)
            try:
                out.extend(self._maps[i].keys())
            finally:
                lk.release()
        return out

    def snapshot(self) -> dict:
        """Merged plain-dict copy (snapshot-blob continuity: the
        restore side — possibly an older head — sees the same
        one-dict shape as before striping)."""
        out: dict = {}
        for i in range(self.n):
            lk = self._acquire(i)
            try:
                out.update(self._maps[i])
            finally:
                lk.release()
        return out

    def restore(self, table: dict) -> None:
        maps: list[dict] = [{} for _ in range(self.n)]
        for k, v in table.items():
            maps[hash(k) & self._mask][k] = v
        for i in range(self.n):
            lk = self._acquire(i)
            try:
                self._maps[i] = maps[i]
            finally:
                lk.release()


_MISSING = object()


class RefTable(_Striped):
    """Striped refcount+pin table: one entry ``[refcount, pins]`` per
    object id, evicted the moment both hit zero (bounded resident
    state — the monolithic version grew a permanent zero entry for
    every object a ``decref``/``unreferenced`` ever probed).

    The WAL hook (``log``) is called INSIDE the stripe lock with the
    post-mutation absolute values: two racing mutations of one object
    log in mutation order, which the set-semantics ``refs`` replay
    record requires (see module docstring).
    """

    __slots__ = ("log",)

    def __init__(self, n: Optional[int] = None,
                 log: Optional[Callable[[str, int, int], None]] = None):
        super().__init__(n)
        # log(oid, refcount, pins) — absolute values, called with the
        # stripe lock held; must never call back into the table.
        self.log = log

    def _log(self, oid: str, e) -> None:
        if self.log is not None:
            self.log(oid, e[0], e[1])

    def addref(self, oid: str, count: int = 1) -> None:
        i = self._idx(oid)
        lk = self._acquire(i)
        try:
            m = self._maps[i]
            e = m.get(oid)
            if e is None:
                e = m[oid] = [0, 0]
            e[0] += count
            self._log(oid, e)
        finally:
            lk.release()

    def decref(self, oid: str, count: int = 1) -> bool:
        """Release `count` references; True when the object is now
        unreferenced AND unpinned (caller deletes it everywhere)."""
        i = self._idx(oid)
        lk = self._acquire(i)
        try:
            m = self._maps[i]
            e = m.get(oid)
            if e is None:
                # decref of an untracked id (already released): keep
                # the legacy contract — report deletable iff unpinned,
                # and never create a resident entry for it
                if self.log is not None:
                    self.log(oid, 0, 0)
                return True
            e[0] = max(0, e[0] - count)
            self._log(oid, e)
            if e[0] == 0 and e[1] == 0:
                del m[oid]
                return True
            return e[0] == 0 and e[1] == 0
        finally:
            lk.release()

    def apply_deltas(self, counts: dict) -> list[str]:
        """Batched decref deltas (r16 NODE_DECREF_DELTA): apply
        ``{oid: n}`` grouped per stripe — each stripe lock is taken
        ONCE for all its oids — and return the ids now deletable."""
        by_stripe: dict[int, list] = {}
        for oid, n in counts.items():
            by_stripe.setdefault(self._idx(oid), []).append((oid, n))
        dead: list[str] = []
        for i, items in by_stripe.items():
            lk = self._acquire(i)
            try:
                m = self._maps[i]
                for oid, n in items:
                    e = m.get(oid)
                    if e is None:
                        if self.log is not None:
                            self.log(oid, 0, 0)
                        dead.append(oid)
                        continue
                    e[0] = max(0, e[0] - int(n))
                    self._log(oid, e)
                    if e[0] == 0 and e[1] == 0:
                        del m[oid]
                        dead.append(oid)
            finally:
                lk.release()
        return dead

    def pin(self, oid: str) -> None:
        i = self._idx(oid)
        lk = self._acquire(i)
        try:
            m = self._maps[i]
            e = m.get(oid)
            if e is None:
                e = m[oid] = [0, 0]
            e[1] += 1
            self._log(oid, e)
        finally:
            lk.release()

    def unpin(self, oid: str) -> bool:
        """True when the object is now unreferenced and unpinned."""
        i = self._idx(oid)
        lk = self._acquire(i)
        try:
            m = self._maps[i]
            e = m.get(oid)
            if e is None:
                if self.log is not None:
                    self.log(oid, 0, 0)
                return True
            e[1] = max(0, e[1] - 1)
            self._log(oid, e)
            if e[0] == 0 and e[1] == 0:
                del m[oid]
                return True
            return False
        finally:
            lk.release()

    def refcount(self, oid: str) -> int:
        i = self._idx(oid)
        lk = self._acquire(i)
        try:
            e = self._maps[i].get(oid)
            return e[0] if e is not None else 0
        finally:
            lk.release()

    def unreferenced(self, oid: str) -> bool:
        i = self._idx(oid)
        lk = self._acquire(i)
        try:
            e = self._maps[i].get(oid)
            return e is None or (e[0] == 0 and e[1] == 0)
        finally:
            lk.release()

    def pinned_ids(self) -> list[str]:
        out: list[str] = []
        for i in range(self.n):
            lk = self._acquire(i)
            try:
                out.extend(oid for oid, e in self._maps[i].items()
                           if e[1] > 0)
            finally:
                lk.release()
        return out

    def set_absolute(self, oid: str, refcount: int, pins: int) -> None:
        """WAL-replay entry point (set semantics): install the absolute
        pair, evicting a now-zero entry."""
        i = self._idx(oid)
        lk = self._acquire(i)
        try:
            m = self._maps[i]
            if refcount <= 0 and pins <= 0:
                m.pop(oid, None)
            else:
                m[oid] = [max(0, int(refcount)), max(0, int(pins))]
        finally:
            lk.release()

    def snapshot(self) -> tuple[dict, dict]:
        """(refcounts, pins) as the two legacy one-dict tables —
        snapshot-blob continuity with pre-r16 heads."""
        refs: dict = {}
        pins: dict = {}
        for i in range(self.n):
            lk = self._acquire(i)
            try:
                for oid, e in self._maps[i].items():
                    if e[0]:
                        refs[oid] = e[0]
                    if e[1]:
                        pins[oid] = e[1]
            finally:
                lk.release()
        return refs, pins

    def restore(self, refcounts: dict, pins: dict) -> None:
        maps: list[dict] = [{} for _ in range(self.n)]
        for oid, c in refcounts.items():
            if c > 0:
                maps[hash(oid) & self._mask][oid] = [int(c), 0]
        for oid, p in pins.items():
            if p > 0:
                e = maps[hash(oid) & self._mask].setdefault(oid, [0, 0])
                e[1] = int(p)
        for i in range(self.n):
            lk = self._acquire(i)
            try:
                self._maps[i] = maps[i]
            finally:
                lk.release()
