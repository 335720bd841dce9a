"""Tree broadcast: cluster-wide object distribution in O(log N) waves.

``ray_tpu_torch.broadcast(ref)`` distributes one object to every alive node
with the SOURCE serving at most ``bcast_fanout`` transfers (reference
envelope row: 1 GiB object broadcast to 50+ nodes — the workload weight
broadcast for serving and SPMD training leans on; all-pull-from-source
makes the producer the bottleneck at fanout N).

The head coordinates: nodes are arranged in a complete ``fanout``-ary
tree rooted at a holder. Each target gets a BCAST_PLAN naming its
PARENT as the pull source; the plan for a node is dispatched only when
its parent's copy registers in the object directory (the coordinator
listens on directory adds), so every completed puller immediately
serves its subtree while the upper levels are already done. An agent
whose parent fails falls back to its pull manager's multi-source path
(any registered holder), so a mid-tree death degrades to extra load on
the survivors instead of a stuck subtree.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.config import CONFIG as _CFG


def build_tree(order: list[str], fanout: int) -> dict[str, list[str]]:
    """parent node_id -> children node_ids for a complete fanout-ary
    tree over `order` (order[0] is the root/source)."""
    out: dict[str, list[str]] = {}
    for i in range(1, len(order)):
        out.setdefault(order[(i - 1) // fanout], []).append(order[i])
    return out


def tree_depth(n_targets: int, fanout: int) -> int:
    """Depth of the deepest target in a complete fanout-ary tree with
    the source at depth 0 and `n_targets` nodes below it."""
    depth = 0
    i = n_targets              # deepest node sits at index n_targets
    while i > 0:
        i = (i - 1) // fanout
        depth += 1
    return depth


class _Job:
    def __init__(self, object_id: str, nbytes: int, fanout: int,
                 order: list[str]):
        self.object_id = object_id
        self.nbytes = nbytes
        self.fanout = fanout
        self.order = order                  # [source, target, ...]
        self.children = build_tree(order, fanout)
        self.pending: set[str] = set(order[1:])
        self.completed: set[str] = {order[0]}
        self.dispatched: set[str] = set()
        self.failed: set[str] = set()
        self.done = threading.Event()
        self.started = time.monotonic()
        # tracing plane: (trace_id, span_id) of the coordinator's
        # broadcast span; every BCAST_PLAN hop carries it so the
        # cascade's per-node pulls stitch under one timeline root
        self.trace: Optional[tuple] = None

    def snapshot(self) -> dict:
        return {
            "object_id": self.object_id,
            "nbytes": self.nbytes,
            "fanout": self.fanout,
            "source": self.order[0],
            "nodes": len(self.order) - 1,
            "completed": len(self.completed) - 1,
            "failed": sorted(self.failed),
            "depth": tree_depth(len(self.order) - 1, self.fanout),
            "seconds": round(time.monotonic() - self.started, 4),
        }


class BroadcastCoordinator:
    """Head-side: one active job per object id; completions arrive via
    directory add-listener callbacks (OBJECT_ADDED / object_at /
    NODE_TASK_DONE located entries all land there)."""

    def __init__(self, runtime):
        self._rt = runtime
        self._lock = threading.Lock()
        self._jobs: dict[str, _Job] = {}
        self.trees_built = 0

    # ------------------------------------------------------ directory
    def on_location(self, object_id: str, node_id: str,
                    partial: bool = False) -> None:
        """Directory listener: a node registered a copy — if it is part
        of an active broadcast, unlock its subtree. A PARTIAL
        registration (r12 cut-through: the node landed its first chunk
        and serves landed ranges from the in-flight landing) dispatches
        the children WITHOUT completing the node, so tree depth costs
        per-chunk instead of per-object latency; the full registration
        later completes it (children already dispatched are skipped by
        the job's dispatched set)."""
        with self._lock:
            job = self._jobs.get(object_id)
            if job is None or node_id not in job.pending:
                return
            if not partial:
                job.pending.discard(node_id)
                job.completed.add(node_id)
            to_dispatch = [c for c in job.children.get(node_id, ())
                           if c not in job.dispatched]
            if not job.pending:
                job.done.set()
        for child in to_dispatch:
            self._dispatch(job, child, parent=node_id)

    # ------------------------------------------------------- dispatch
    def _describe(self, node_id: str) -> dict:
        """Source descriptor a child agent can dial."""
        if node_id == self._rt.head_node_id:
            return {"head": True, "node_id": node_id}
        rec = self._rt.cluster.get_node(node_id)
        addr = getattr(rec.scheduler, "advertise_addr",
                       None) if rec else None
        if addr is None:
            return {"head": True, "node_id": node_id}  # degraded: pull head
        return {"host": addr[0], "port": int(addr[1]),
                "node_id": node_id}

    def _dispatch(self, job: _Job, node_id: str, parent: str) -> None:
        with self._lock:
            if node_id in job.dispatched:
                return
            job.dispatched.add(node_id)
        rec = self._rt.cluster.get_node(node_id)
        conn = getattr(rec.scheduler, "conn", None) if rec else None
        ok = False
        if conn is not None and rec.alive:
            try:
                plan = {"type": protocol.BCAST_PLAN,
                        "object_id": job.object_id,
                        "nbytes": job.nbytes,
                        "source": self._describe(parent)}
                if job.trace is not None:
                    plan["_trace"] = job.trace
                conn.send(plan)
                ok = True
            except protocol.ConnectionClosed:
                ok = False
        if not ok:
            self._fail_node(job, node_id)

    def _fail_node(self, job: _Job, node_id: str) -> None:
        """Mark a target failed and re-root its children on the source
        (their pull managers fall back to any holder regardless)."""
        with self._lock:
            if node_id not in job.pending:
                return
            job.pending.discard(node_id)
            job.failed.add(node_id)
            children = [c for c in job.children.get(node_id, ())
                        if c not in job.dispatched]
            if not job.pending:
                job.done.set()
        for child in children:
            self._dispatch(job, child, parent=job.order[0])

    # ------------------------------------------------------------ api
    def broadcast(self, object_id: str, fanout: Optional[int] = None,
                  timeout: Optional[float] = None) -> dict:
        """Distribute `object_id` to every alive agent node; blocks
        until all copies register (or timeout). Returns job stats.
        Concurrent broadcasts of one object join the active job."""
        with _tp.span("bcast", "bcast:" + object_id[:16], root=True):
            return self._broadcast_inner(object_id, fanout, timeout)

    def _broadcast_inner(self, object_id: str,
                         fanout: Optional[int] = None,
                         timeout: Optional[float] = None) -> dict:
        fanout = max(1, int(fanout or _CFG.bcast_fanout))
        timeout = timeout if timeout is not None else _CFG.bcast_timeout_s
        rt = self._rt
        holders = set(rt.controller.locations(object_id))
        head_has = rt.store.contains(object_id)
        if head_has:
            holders.add(rt.head_node_id)
        if not holders:
            # not sealed anywhere yet: wait for it (producer may still
            # be running) via the cluster-wide blocking fetch
            stored = rt._get_stored_anywhere(object_id, timeout)
            if stored is None:
                raise TimeoutError(
                    f"broadcast({object_id}): object not available "
                    f"within {timeout}s")
            holders = set(rt.controller.locations(object_id))
            holders.add(rt.head_node_id)
        # source: prefer the head (it can serve any agent without a
        # peer dial), else any agent holder
        source = (rt.head_node_id if rt.head_node_id in holders
                  else sorted(holders)[0])
        nbytes = rt.controller.directory.nbytes(object_id)
        if not nbytes:
            stored = rt.store.get_stored(object_id, timeout=0,
                                         restore=False)
            if stored is not None:
                nbytes = stored.nbytes
        targets = [n.node_id for n in rt.cluster.alive_nodes()
                   if getattr(n.scheduler, "conn", None) is not None
                   and n.node_id not in holders]
        with self._lock:
            job = self._jobs.get(object_id)
            if job is None:
                if not targets:
                    snap = _Job(object_id, nbytes, fanout,
                                [source]).snapshot()
                    snap["timed_out"] = False   # same shape everywhere
                    return snap
                job = _Job(object_id, nbytes, fanout, [source] + targets)
                job.trace = _tp.wire_ctx()
                self._jobs[object_id] = job
                self.trees_built += 1
                owner = True
            else:
                owner = False
        if owner:
            for child in job.children.get(source, ()):
                self._dispatch(job, child, parent=source)
            # close the registration race: a target whose copy (or
            # first cut-through chunk) landed between the target-list
            # read and the job registration will never fire another
            # directory add event
            for nid in list(job.pending):
                if rt.controller.directory.holds(object_id, nid):
                    self.on_location(object_id, nid)
                elif rt.controller.directory.holds_partial(object_id,
                                                           nid):
                    self.on_location(object_id, nid, partial=True)
        # wait in slices so dead nodes are pruned promptly
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not job.done.is_set():
            left = (None if deadline is None
                    else deadline - time.monotonic())
            if left is not None and left <= 0:
                break
            job.done.wait(timeout=0.25 if left is None
                          else min(0.25, left))
            alive = {n.node_id for n in rt.cluster.alive_nodes()}
            with self._lock:
                lost = [nid for nid in job.pending if nid not in alive]
            for nid in lost:
                self._fail_node(job, nid)
        if owner:
            with self._lock:
                self._jobs.pop(object_id, None)
        snap = job.snapshot()
        snap["timed_out"] = not job.done.is_set()
        return snap

    def stats(self) -> dict:
        with self._lock:
            return {"active_jobs": len(self._jobs),
                    "trees_built": self.trees_built}
