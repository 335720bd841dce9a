"""Cluster object directory: object_id -> holder node set.

The head-resident location service of the distributed object plane
(reference src/ray/object_manager/ownership_based_object_directory.cc;
here the head IS the owner of record for every object). Updated on
seal/put (NODE_TASK_DONE ``located`` entries, OBJECT_ADDED), on
pull-complete (a puller registers its replica and immediately serves
it), and on evict/holder-death (OBJECT_REMOVED, node purge). Read by:

- getters (head ``_pull_remote`` + agent multi-source pulls via
  LOCATE_OBJECT),
- the scheduler's locality hint (place a task where its argument
  bytes already live — ``locality_bytes``),
- the tree-broadcast coordinator (location-added listeners drive the
  dispatch cascade: a node's registration unlocks its subtree).

r16: internally striped by object id (striped.py discipline) — every
TASK_DONE ``located`` entry, OBJECT_ADDED, and delete used to take
ONE directory lock, serializing the poller thread against getters and
the locality scorer at 100k-object scale. Entries are already
reference-counted out (the holder-set emptying pops the id and its
nbytes), so striping adds no retention risk. Listeners fire OUTSIDE
the stripe locks (they send frames / touch other subsystem locks).
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

from ray_tpu_torch._private import striped


class _DirStripe:
    """One stripe: its own lock + the three per-object tables."""

    __slots__ = ("lock", "locations", "partial", "nbytes")

    def __init__(self):
        self.lock = threading.Lock()
        # full holders: oid -> {node_id}
        self.locations: dict[str, set[str]] = {}
        # PARTIAL holders (r12 cut-through): nodes mid-pull that have
        # landed >= 1 chunk and can serve landed ranges to
        # manifest-speaking children. Advisory — never handed to
        # regular getters, never counted as a real copy. Promoted to
        # `locations` on the full OBJECT_ADDED, retracted on pull
        # failure / node death.
        self.partial: dict[str, set[str]] = {}
        self.nbytes: dict[str, int] = {}


class ObjectDirectory:
    def __init__(self):
        self.n = striped.stripe_count()
        self._mask = self.n - 1
        self._stripes = [_DirStripe() for _ in range(self.n)]
        self.contended = [0] * self.n
        self._listeners: list[Callable[[str, str, bool], None]] = []
        # counters for the object_plane_stats surface (plain-int bumps,
        # GIL-coherent enough for stats)
        self.adds = 0
        self.removes = 0
        self.partial_adds = 0

    def _stripe(self, oid: str) -> _DirStripe:
        i = hash(oid) & self._mask
        st = self._stripes[i]
        if not st.lock.acquire(False):
            self.contended[i] += 1
            st.lock.acquire()
        return st

    # ------------------------------------------------------- mutation
    def add_listener(self, fn: Callable[[str, str, bool], None]) -> None:
        """``fn(object_id, node_id, partial)`` runs after every NEW
        location registration (not on re-adds; partial=True for
        cut-through partial-holder adds), outside the stripe lock."""
        self._listeners.append(fn)

    def add(self, object_id: str, node_id: str, nbytes: int = 0,
            partial: bool = False) -> bool:
        """Register a copy; returns True (and notifies listeners) only
        when the holder set actually grew. ``partial=True`` records an
        advisory cut-through holder instead (ignored when the node
        already holds a full copy)."""
        st = self._stripe(object_id)
        try:
            full = st.locations.get(object_id)
            if partial:
                if full is not None and node_id in full:
                    return False          # full copy supersedes
                p = st.partial.setdefault(object_id, set())
                new = node_id not in p
                p.add(node_id)
                if nbytes:
                    st.nbytes[object_id] = nbytes
                if new:
                    self.partial_adds += 1
            else:
                s = st.locations.setdefault(object_id, set())
                new = node_id not in s
                s.add(node_id)
                # promotion: the full copy replaces the partial entry
                p = st.partial.get(object_id)
                if p is not None:
                    p.discard(node_id)
                    if not p:
                        st.partial.pop(object_id, None)
                if nbytes:
                    st.nbytes[object_id] = nbytes
                if new:
                    self.adds += 1
        finally:
            st.lock.release()
        if new:
            for fn in self._listeners:
                try:
                    fn(object_id, node_id, partial)
                except Exception:
                    pass
        return new

    def remove(self, object_id: str,
               node_id: Optional[str] = None) -> None:
        """Drop one holder (full AND partial), or the whole entry when
        node_id is None."""
        st = self._stripe(object_id)
        try:
            if node_id is None:
                if st.locations.pop(object_id, None) is not None:
                    self.removes += 1
                st.partial.pop(object_id, None)
                st.nbytes.pop(object_id, None)
                return
            p = st.partial.get(object_id)
            if p is not None and node_id in p:
                p.discard(node_id)
                if not p:
                    st.partial.pop(object_id, None)
            s = st.locations.get(object_id)
            if s is not None and node_id in s:
                s.discard(node_id)
                self.removes += 1
                if not s:
                    st.locations.pop(object_id, None)
                    st.partial.pop(object_id, None)
                    st.nbytes.pop(object_id, None)
        finally:
            st.lock.release()

    def purge_node(self, node_id: str) -> list[str]:
        """Drop `node_id` from every entry; returns object ids left
        with NO full copy anywhere (lineage-recovery candidates —
        partial holders don't count: a relay whose source died can
        never finish its copy). Sweeps one stripe at a time (node
        death is rare; holding no global lock keeps the hot paths
        moving during the sweep)."""
        orphaned: list[str] = []
        for st in self._stripes:
            with st.lock:
                for oid in list(st.partial):
                    p = st.partial[oid]
                    p.discard(node_id)
                    if not p:
                        st.partial.pop(oid, None)
                for oid in list(st.locations):
                    s = st.locations[oid]
                    if node_id in s:
                        s.discard(node_id)
                        self.removes += 1
                        if not s:
                            st.locations.pop(oid, None)
                            st.partial.pop(oid, None)
                            st.nbytes.pop(oid, None)
                            orphaned.append(oid)
        return orphaned

    # --------------------------------------------------------- queries
    def locations(self, object_id: str) -> list[str]:
        st = self._stripe(object_id)
        try:
            return list(st.locations.get(object_id, ()))
        finally:
            st.lock.release()

    def has(self, object_id: str) -> bool:
        st = self._stripe(object_id)
        try:
            return bool(st.locations.get(object_id))
        finally:
            st.lock.release()

    def holds(self, object_id: str, node_id: str) -> bool:
        st = self._stripe(object_id)
        try:
            return node_id in st.locations.get(object_id, ())
        finally:
            st.lock.release()

    def holds_partial(self, object_id: str, node_id: str) -> bool:
        st = self._stripe(object_id)
        try:
            return node_id in st.partial.get(object_id, ())
        finally:
            st.lock.release()

    def partial_locations(self, object_id: str) -> list[str]:
        st = self._stripe(object_id)
        try:
            return list(st.partial.get(object_id, ()))
        finally:
            st.lock.release()

    def nbytes(self, object_id: str) -> int:
        st = self._stripe(object_id)
        try:
            return st.nbytes.get(object_id, 0)
        finally:
            st.lock.release()

    def empty(self) -> bool:
        # lock-free scan; hint only (scheduler locality fast path)
        return not any(st.locations for st in self._stripes)

    def locality_bytes(self, object_ids: Iterable[str],
                       node_ids: Iterable[str]) -> dict[str, int]:
        """node_id -> total known bytes of `object_ids` resident there
        (objects with unknown size count 1 byte: presence still
        matters). Only nodes in `node_ids` are scored; nodes holding
        nothing are absent from the result. Each object reads only its
        own stripe."""
        wanted = set(node_ids)
        out: dict[str, int] = {}
        for oid in object_ids:
            st = self._stripe(oid)
            try:
                holders = st.locations.get(oid)
                if not holders:
                    continue
                size = max(st.nbytes.get(oid, 0), 1)
                for nid in holders:
                    if nid in wanted:
                        out[nid] = out.get(nid, 0) + size
            finally:
                st.lock.release()
        return out

    # ---------------------------------------------------- persistence
    def snapshot(self) -> tuple[dict, dict]:
        """(locations, nbytes) merged one-dict copies for the head
        snapshot (legacy blob keys; captured stripe by stripe)."""
        locations: dict = {}
        nbytes: dict = {}
        for st in self._stripes:
            with st.lock:
                for k, v in st.locations.items():
                    locations[k] = set(v)
                nbytes.update(st.nbytes)
        return locations, nbytes

    def restore(self, locations: dict, nbytes: dict) -> None:
        # partial holders deliberately don't survive a head restart:
        # they are advisory in-flight state (the pull either completes
        # and re-registers full, or failed while the head was down)
        shards: list[tuple[dict, dict]] = [({}, {})
                                           for _ in range(self.n)]
        for k, v in locations.items():
            shards[hash(k) & self._mask][0][k] = set(v)
        for k, v in nbytes.items():
            shards[hash(k) & self._mask][1][k] = v
        for st, (locs, nb) in zip(self._stripes, shards):
            with st.lock:
                st.locations = locs
                st.partial = {}
                st.nbytes = nb

    def stats(self) -> dict:
        objects = replicas = partial = tracked = 0
        for st in self._stripes:
            with st.lock:
                objects += len(st.locations)
                replicas += sum(len(s) for s in st.locations.values())
                partial += sum(len(s) for s in st.partial.values())
                tracked += sum(st.nbytes.values())
        return {
            "objects": objects,
            "replicas": replicas,
            "partial_replicas": partial,
            "tracked_bytes": tracked,
            "adds": self.adds,
            "removes": self.removes,
            "partial_adds": self.partial_adds,
        }

    def shard_stats(self) -> dict:
        sizes = [len(st.locations) for st in self._stripes]
        return {"stripes": self.n, "entries": sum(sizes),
                "max_stripe": max(sizes),
                "contended": sum(self.contended)}
