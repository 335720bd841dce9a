"""Pull manager: deduped, bounded, multi-source object transfers.

Reference src/ray/object_manager/pull_manager.cc: every endpoint that
fetches remote objects (each node agent, and the head) runs one of
these in front of the raw chunked pull protocol. It provides:

- **Dedup**: concurrent requests for the same object join one in-flight
  transfer instead of each opening a session (two getters, one
  transfer; counted as ``pull_dedup_hits``).
- **Bounds**: at most ``pull_concurrency`` transfers run at once, and
  their admitted sizes share a ``pull_max_inflight_bytes`` budget —
  a node pulling many large objects cannot balloon its memory.
- **Multi-source**: sources come from the cluster object directory
  (every registered holder, not just the original producer), tried in
  preference order with failover; a source that no longer holds the
  object is reported back so the directory drops the stale location.
- **Retry**: chunk-level drops retry within a source (see
  ``pull_object``); source-level failures rotate to the next holder.

The manager is transport-agnostic: callers supply ``sources_fn`` which
yields ``(source_id, connection)`` pairs for an object (the agent backs
it with LOCATE_OBJECT + lazy peer dials; the head with the directory +
its agent control connections), and ``on_complete`` /
``on_source_failed`` hooks for replica registration and stale-location
teardown.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.config import CONFIG as _CFG
from ray_tpu_torch._private.object_transfer import (OBJECT_PLANE_STATS,
                                              PullBudgetExceeded,
                                              StoredObject, pull_object)


class ByteBudget:
    """Shared in-flight byte accounting. ``reserve`` blocks until the
    transfer fits (or it is the only one — a single object larger than
    the whole budget must still be admissible)."""

    def __init__(self, cap: int):
        self.cap = cap
        self.used = 0
        self.active = 0
        self._cv = threading.Condition()

    def reserve(self, n: int, timeout: Optional[float] = None) -> bool:
        if self.cap <= 0:
            return True
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            while not (self.used + n <= self.cap or self.active == 0):
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                self._cv.wait(timeout=left)
            self.used += n
            self.active += 1
            return True

    def release(self, n: int) -> None:
        if self.cap <= 0:
            return
        with self._cv:
            self.used -= n
            self.active -= 1
            self._cv.notify_all()


class _Flight:
    __slots__ = ("event", "result")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[StoredObject] = None


class PullManager:
    def __init__(self, store,
                 sources_fn: Callable[[str, Optional[dict]],
                                      Iterable[tuple]],
                 on_complete: Optional[Callable] = None,
                 on_source_failed: Optional[Callable] = None,
                 on_partial: Optional[Callable] = None,
                 on_partial_failed: Optional[Callable] = None,
                 deprioritize_fn: Optional[Callable[[Any], bool]] = None,
                 name: str = ""):
        self._store = store
        self._sources_fn = sources_fn
        # r17 suspicion: `deprioritize_fn(source_id)` -> True moves a
        # holder to the END of the rotation (tried only after every
        # healthy holder failed). The head backs it with the cluster's
        # SUSPECT flag so a gray-failing node stops being the first
        # source a transfer gambles its deadline on.
        self._deprioritize = deprioritize_fn
        self._on_complete = on_complete
        self._on_source_failed = on_source_failed
        # cut-through hooks (r12): `on_partial(object_id, nbytes)`
        # fires once per winning transfer at its FIRST landed chunk —
        # the partial-holder directory registration that unlocks the
        # node's broadcast subtree while the pull is still in flight.
        # `on_partial_failed(object_id)` retracts it when the transfer
        # dies after registering (children fall back multi-source).
        self._on_partial = on_partial
        self._on_partial_failed = on_partial_failed
        self.name = name
        self._lock = threading.Lock()
        self._inflight: dict[str, _Flight] = {}
        self._sem = threading.Semaphore(max(1, _CFG.pull_concurrency))
        self._budget = ByteBudget(_CFG.pull_max_inflight_bytes)

    # ------------------------------------------------------------ api
    def pull(self, object_id: str, prefer: Optional[dict] = None,
             timeout: Optional[float] = 60.0,
             trace_ctx: Optional[tuple] = None) -> Optional[StoredObject]:
        """Fetch `object_id` into the local store and return it (None
        on timeout/no-source). Concurrent calls for one object share a
        single transfer; `prefer` (an opaque source hint passed through
        to sources_fn, e.g. a broadcast parent) is honored by the
        winning transfer only. `trace_ctx` — an explicit
        (trace_id, parent_span), else the calling thread's current —
        puts the transfer on the tracing-plane timeline: the winner
        records one "pull" span and stamps the PULL_OBJECT message so
        the holder's serve span parents under it (joiners record
        nothing; they did no transfer work)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        stored = self._store.get_stored(object_id, timeout=0)
        if stored is not None:
            return stored
        with self._lock:
            flight = self._inflight.get(object_id)
            if flight is not None:
                joiner = True
                OBJECT_PLANE_STATS["pull_dedup_hits"] += 1
            else:
                joiner = False
                flight = self._inflight[object_id] = _Flight()
        if joiner:
            flight.event.wait(None if deadline is None
                              else max(0.0, deadline - time.monotonic()))
            if flight.result is not None:
                return flight.result
            # winner failed or we timed out: one local re-probe (the
            # object may have sealed locally through another path)
            return self._store.get_stored(object_id, timeout=0)
        try:
            with _tp.span("pull", "pull:" + object_id[:16],
                          ctx=trace_ctx):
                flight.result = self._transfer(object_id, prefer,
                                               deadline)
        finally:
            with self._lock:
                self._inflight.pop(object_id, None)
            flight.event.set()
        return flight.result

    def _transfer(self, object_id: str, prefer: Optional[dict],
                  deadline: Optional[float]) -> Optional[StoredObject]:
        OBJECT_PLANE_STATS["pulls_started"] += 1
        acquired = self._sem.acquire(
            timeout=None if deadline is None
            else max(0.0, deadline - time.monotonic()))
        if not acquired:
            OBJECT_PLANE_STATS["pulls_failed"] += 1
            return None
        partial_fired = {"v": False}

        def _first_chunk(nbytes: int) -> None:
            # winner-only, once per transfer: register this node as a
            # PARTIAL holder so the broadcast coordinator dispatches
            # our subtree against the landing (cut-through)
            if partial_fired["v"] or not _CFG.pull_cut_through:
                return
            partial_fired["v"] = True
            if self._on_partial is not None:
                try:
                    self._on_partial(object_id, nbytes)
                except Exception:
                    pass

        try:
            stored = self._store.get_stored(object_id, timeout=0)
            if stored is not None:      # landed while we queued
                return stored
            for source_id, conn in self._iter_sources(object_id, prefer):
                if conn is None or getattr(conn, "closed", False):
                    continue
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    break
                try:
                    stored = pull_object(conn, object_id,
                                         timeout=remaining,
                                         budget=self._budget,
                                         store=self._store,
                                         on_first_chunk=_first_chunk)
                except PullBudgetExceeded:
                    # our own admission control, not the source's
                    # fault: keep the location, and stop rotating —
                    # every other source hits the same budget wall
                    # (each attempt would strand another pinned
                    # encoded blob on a holder until its TTL)
                    break
                except TimeoutError:
                    # the CALLER's deadline expired mid-transfer, not
                    # the holder failing: reporting this as a source
                    # failure would deregister a valid copy cluster-
                    # wide (and trigger spurious lineage re-execution)
                    break
                except protocol.ConnectionClosed:
                    stored = None
                if stored is not None:
                    OBJECT_PLANE_STATS["pulls_completed"] += 1
                    # the manifest land path sealed into the store
                    # itself (closing the landing->store serve gap);
                    # only the blob path still needs the put here.
                    # contains() is a residency probe (spilled counts):
                    # get_stored would synchronously restore a copy
                    # the LRU pass just spilled, on this thread
                    if not self._store.contains(object_id):
                        OBJECT_PLANE_STATS["pull_bytes"] += stored.nbytes
                        self._store.put_stored(stored)
                    if self._on_complete is not None:
                        try:
                            self._on_complete(object_id, stored,
                                              source_id)
                        except Exception:
                            pass
                    return stored
                if self._on_source_failed is not None:
                    try:
                        self._on_source_failed(object_id, source_id)
                    except Exception:
                        pass
            OBJECT_PLANE_STATS["pulls_failed"] += 1
            return None
        finally:
            self._sem.release()
            if partial_fired["v"] and self._on_partial_failed is not None:
                # the transfer registered as a partial holder but never
                # completed (this thread is leaving without a store
                # copy): retract the advisory location. Residency
                # probe, NOT get_stored: a sealed-then-spilled copy is
                # still held (retracting would drop the FULL location)
                # and must not cost a synchronous disk restore here
                if not self._store.contains(object_id):
                    try:
                        self._on_partial_failed(object_id)
                    except Exception:
                        pass

    def _iter_sources(self, object_id: str, prefer: Optional[dict]):
        """The caller's source rotation with suspect holders deferred
        to the tail (r17): lazily forwarded when no deprioritize hook
        is installed, so the agent-side lazy peer dials keep their
        one-dial-per-yield behavior."""
        if self._deprioritize is None:
            yield from self._sources_fn(object_id, prefer)
            return
        deferred = []
        for src in self._sources_fn(object_id, prefer):
            try:
                suspect = bool(self._deprioritize(src[0]))
            except Exception:
                suspect = False
            if suspect:
                OBJECT_PLANE_STATS["pull_suspect_deferred"] += 1
                deferred.append(src)
            else:
                yield src
        yield from deferred

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def stats(self) -> dict:
        return {"inflight": self.inflight(),
                "inflight_bytes": self._budget.used,
                "budget_bytes": self._budget.cap}
