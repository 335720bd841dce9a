"""Cluster task manager: multi-node placement, PGs, node health.

Parity map (reference src/ray/):
- node selection policies -> raylet/scheduling/policy/
  hybrid_scheduling_policy.h:50 (pack-until-threshold-then-spread),
  spread, node-affinity; bundle policies
  raylet/scheduling/policy/bundle_scheduling_policy.cc.
- placement groups -> gcs/gcs_server GcsPlacementGroupManager/-Scheduler
  2-phase reserve/commit with rollback.
- node lifecycle + health -> GcsNodeManager (gcs_node_manager.h:62) +
  GcsHealthCheckManager (gcs_health_check_manager.h:39): heartbeat
  staleness marks a node dead and triggers task/actor/PG recovery.
- spillback -> ClusterTaskManager::ScheduleOnNode redirect: a task aging
  in one node's queue is handed back and re-placed on a node with room.

Nodes here are in-process Scheduler instances (each owning real worker
subprocesses) — the same-host multi-raylet topology the reference uses
for cluster testing (python/ray/cluster_utils.py:135), which is also the
honest TPU-era model for one driver managing N pod hosts.
"""
from __future__ import annotations

import logging
import threading
import time
import uuid

log = logging.getLogger(__name__)
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.scheduler import Scheduler, fits
from ray_tpu_torch._private.specs import ActorSpec, TaskSpec, bump_attempt
from ray_tpu_torch.exceptions import PlacementGroupUnschedulableError

# PG states (reference rpc::PlacementGroupTableData).
PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"
PG_RESCHEDULING = "RESCHEDULING"

from ray_tpu_torch._private.config import CONFIG as _CFG
_HYBRID_THRESHOLD = 0.5


@dataclass
class NodeRecord:
    node_id: str
    scheduler: Scheduler
    is_head: bool = False
    alive: bool = True
    labels: Dict[str, str] = field(default_factory=dict)
    last_heartbeat: float = field(default_factory=time.monotonic)
    started_at: float = field(default_factory=time.time)
    # Drain-before-kill state (r14 preemption notice): a draining node
    # is alive but receives no new placements; drain_acked flips when
    # every interested party (elastic trainers) has flushed state and
    # the node may be released before its deadline. The deadline itself
    # is enforced by whoever issued the drain (the autoscaler's sweep),
    # not here — the cluster only tracks the routing/ack state.
    draining: bool = False
    drain_acked: bool = False
    # Suspicion state (r17 gray failures): heartbeat older than
    # RAY_TPU_SUSPECT_S but younger than the death timeout. A suspect
    # node is alive — no recovery runs — but routing/rebalance/spill
    # skip it, pulls deprioritize it, and the autoscaler excludes its
    # capacity. The NEXT heartbeat clears the flag inline (recovery is
    # free); recovered_pending defers the RECOVERED event + infeasible
    # retry to the monitor sweep, which may publish/lock — heartbeat()
    # is called from under node locks and must stay lock-free.
    suspect: bool = False
    recovered_pending: bool = False


@dataclass
class PGRecord:
    pg_id: str
    bundles: List[dict]
    strategy: str
    name: str = ""
    state: str = PG_PENDING
    # bundle index -> node_id (filled when reserved)
    bundle_nodes: List[Optional[str]] = field(default_factory=list)
    created_at: float = field(default_factory=time.time)


class ClusterTaskManager:
    """Owns the node set; places tasks/actors/bundles onto nodes."""

    def __init__(self, runtime):
        self._rt = runtime
        # With an autoscaler attached, "no node fits" is pending demand
        # (capacity may be provisioned), not a hard error; the
        # Autoscaler flips this (reference: feasibility is judged
        # against node TYPES, not live nodes, when autoscaling).
        self.autoscaling_enabled = False
        self.autoscaler_node_types: List[dict] = []
        from ray_tpu_torch._private.debug_sync import make_lock
        self._lock = make_lock("cluster", reentrant=True)
        self._nodes: Dict[str, NodeRecord] = {}
        self._pgs: Dict[str, PGRecord] = {}
        self._pending_pgs: List[str] = []
        self._infeasible: List = []       # specs no live node can EVER fit
        # r17 membership observability (liveness_stats / metrics);
        # bumped via bump_liveness from the monitor thread AND
        # per-connection reader threads — dict += is a non-atomic
        # read-modify-write, so increments go through one small lock
        self.liveness_counters: Dict[str, int] = {
            "suspected": 0, "recovered": 0, "deaths": 0, "fenced": 0,
            "stalls_credited": 0}
        self._counter_lock = threading.Lock()
        # node_id -> rejoin deadline: rehydrated agents expected to
        # re-register after a head restart (reference: raylets reconnect
        # to a restarted GCS; gcs_init_data.cc rehydrated node table)
        self._rejoining: Dict[str, float] = {}
        self._running = True
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="ray-tpu-health", daemon=True)
        self._monitor.start()
        # r10 delegated steal: its own thread — a wedged agent can
        # stall the revoke SEND (socket buffer full, 30s SO_SNDTIMEO),
        # which must never delay the health monitor's death detection
        self._rebalancer = threading.Thread(
            target=self._rebalance_loop, name="ray-tpu-rebalance",
            daemon=True)
        self._rebalancer.start()

    # ------------------------------------------------------------ nodes
    def add_node(self, resources: Dict[str, float],
                 max_workers: Optional[int] = None, is_head: bool = False,
                 labels: Optional[Dict[str, str]] = None) -> NodeRecord:
        node_id = ("head_" if is_head else "node_") + uuid.uuid4().hex[:8]
        sched = Scheduler(self._rt, dict(resources), self._rt.address,
                          max_workers, node_id=node_id, cluster=self)
        rec = NodeRecord(node_id=node_id, scheduler=sched, is_head=is_head,
                         labels=dict(labels or {}))
        with self._lock:
            self._nodes[node_id] = rec
        self._rt.controller.register_node(node_id, resources,
                                          is_head=is_head, labels=labels)
        self._rt.controller.publish_node_event(node_id, "ALIVE")
        sched.start()
        # New capacity: retry anything parked as infeasible + pending PGs.
        self._retry_infeasible()
        self._retry_pending_pgs()
        return rec

    def add_remote_node(self, conn, resources: Dict[str, float],
                        labels: Optional[Dict[str, str]] = None,
                        advertise_addr: Optional[tuple] = None,
                        node_id: Optional[str] = None) -> NodeRecord:
        """A node-agent process registered over TCP (reference
        GcsNodeManager::HandleRegisterNode, gcs_node_manager.h:62). The
        node's scheduler is a RemoteNodeHandle proxy; the real scheduler
        + worker pool run in the agent. The agent mints its own node id
        (its scheduler must exist before the head can route to it)."""
        from ray_tpu_torch._private.remote_node import RemoteNodeHandle
        node_id = node_id or ("node_" + uuid.uuid4().hex[:8])
        ha = getattr(self._rt, "_ha", None)
        proxy = RemoteNodeHandle(node_id, conn, dict(resources),
                                 advertise_addr or ("127.0.0.1", 0),
                                 wal_log=(ha.log if ha is not None
                                          else None))
        rec = NodeRecord(node_id=node_id, scheduler=proxy, is_head=False,
                         labels=dict(labels or {}))
        # r17: every (re)registration earns a fresh incarnation; the
        # runtime stamps it on the agent's connection and frames from
        # older epochs are fenced at the frame-apply points.
        proxy.incarnation = self._rt.controller.mint_incarnation(node_id)
        with self._lock:
            old = self._nodes.get(node_id)
            self._nodes[node_id] = rec
            self._rejoining.pop(node_id, None)   # made it back in time
        if old is not None and old.alive and old.scheduler is not proxy:
            # transient reconnect replacing a live handle: inherit its
            # mirror so in-flight completions still pop their specs,
            # and stop its lease flusher (it would leak a thread)
            try:
                old.scheduler._lease_flusher.stop()
                with old.scheduler._lock:
                    # snapshot under the OLD handle's lock: its reader
                    # thread may still be popping entries for late
                    # completions
                    work = dict(old.scheduler._work)
                    leased = set(old.scheduler._leased)
                proxy.adopt_mirror(work, leased)
            except Exception:
                log.exception("mirror hand-over on reconnect failed")
        self._rt.controller.register_node(node_id, resources,
                                          is_head=False, labels=labels)
        self._rt.controller.publish_node_event(node_id, "ALIVE")
        # Deferred: retries may issue bundle-reserve RPCs on THIS conn,
        # and we are on its reader thread (a blocking request here would
        # deadlock against ourselves).
        threading.Thread(target=self._retry_after_join,
                         name="rtpu-join-retry", daemon=True).start()
        return rec

    def _retry_after_join(self) -> None:
        try:
            self._retry_infeasible()
            self._retry_pending_pgs()
        except Exception:
            pass

    def remove_node(self, node_id: str, graceful: bool = True) -> None:
        """Graceful drain or simulated abrupt node death."""
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.alive:
                return
        if graceful:
            self._on_node_death(node_id, cause="removed")
        else:
            # Abrupt: kill worker processes without notice and stop the
            # heartbeat; the health monitor must *detect* it (the
            # reference's failure-detection path, not the removal path).
            rec.scheduler.die_silently()

    def nodes(self) -> List[NodeRecord]:
        with self._lock:
            return list(self._nodes.values())

    def alive_nodes(self) -> List[NodeRecord]:
        with self._lock:
            return [n for n in self._nodes.values() if n.alive]

    def schedulable_nodes(self) -> List[NodeRecord]:
        """Alive nodes that accept NEW placements: draining nodes (a
        preemption notice is in flight) and SUSPECT nodes (heartbeat
        stale past RAY_TPU_SUSPECT_S — a gray failure in progress) are
        excluded so nothing fresh lands on a host about to die. A
        suspect node rejoins this set the instant its next heartbeat
        lands (heartbeat() clears the flag inline)."""
        with self._lock:
            return [n for n in self._nodes.values()
                    if n.alive and not n.draining and not n.suspect]

    # ------------------------------------------- drain-before-kill (r14)
    def drain_node(self, node_id: str,
                   deadline_s: Optional[float] = None) -> bool:
        """Preemption-notice drain: stop routing new work to `node_id`,
        reclaim its queued-not-started backlog through the r10 lease-
        revoke machinery and re-place it elsewhere, and publish a
        DRAINING node event (elastic trainers flush a checkpoint on
        it). The node stays ALIVE — the caller terminates it once the
        drain is acknowledged or `deadline_s` lapses; the deadline is
        advisory here (the autoscaler's drain sweep owns the clock).
        Returns False for unknown/dead/head nodes."""
        del deadline_s                       # caller-enforced (see doc)
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.alive or rec.is_head:
                return False
            if rec.draining:
                return True                  # idempotent re-notice
            rec.draining = True
            rec.drain_acked = False
        try:
            rec.scheduler.set_draining(True)
        except Exception:
            pass
        self._rt.controller.publish_node_event(
            node_id, "DRAINING", cause="preemption notice")
        self._reclaim_draining(rec)
        return True

    def _reclaim_draining(self, rec: NodeRecord) -> None:
        """Pull queued-not-started work off a draining node and
        re-place it. Delegated agents hand specs back via the r10
        lease_reclaimed event (the runtime re-submits them; routing now
        skips the draining node); local schedulers reclaim through
        reclaim_tasks with a resubmit callback. Running tasks stay —
        they either finish inside the drain window or ride the normal
        node-death recovery."""
        h = rec.scheduler
        if getattr(h, "revoke_lease", None) is not None:
            # remote agent: reclaim through NODE_LEASE_REVOKE whenever
            # the peer SPEAKS the op (wire MINOR >= 3) — delegation
            # off still mirrors pushed specs in _work and the agent's
            # revoke handler works in either lease mode. An older peer
            # cannot reclaim; its queued work rides the death path.
            if h.conn.peer_speaks_delegate():
                ids = h.queued_task_ids(limit=4096)
                if ids:
                    h.revoke_lease(ids)
            return
        if not hasattr(h, "reclaim_tasks"):
            return
        ids = h.queued_task_ids()
        if not ids:
            return

        def _resubmit(specs):
            for spec in specs:
                try:
                    bump_attempt(spec)
                    self.submit(spec)
                except Exception:
                    log.exception("drain resubmit failed")

        h.reclaim_tasks(ids, _resubmit)

    def acknowledge_drain(self, node_id: str) -> None:
        """A drain listener (elastic trainer) flushed its state: the
        node may be released before its deadline. Publishes DRAINED so
        the autoscaler's next sweep (or an external provider loop) can
        terminate immediately."""
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.draining or rec.drain_acked:
                return
            rec.drain_acked = True
        self._rt.controller.publish_node_event(node_id, "DRAINED")

    def is_draining(self, node_id: str) -> bool:
        with self._lock:
            rec = self._nodes.get(node_id)
            return bool(rec is not None and rec.alive and rec.draining)

    def alive_node_count(self) -> int:
        """LOCK-FREE alive-node count (single atomic dict scan): safe to
        call while holding a node lock, where taking the cluster lock
        would ABBA-deadlock against cluster->node lock paths."""
        return sum(1 for n in list(self._nodes.values()) if n.alive)

    def get_node(self, node_id: str) -> Optional[NodeRecord]:
        with self._lock:
            return self._nodes.get(node_id)

    def heartbeat(self, node_id: str) -> None:
        # Lock-free by contract: local schedulers call this from under
        # their own node lock every dispatch tick. Clearing suspicion
        # here is what makes blip recovery FREE — the node is
        # schedulable again before the monitor's next 0.5 s sweep; the
        # sweep only publishes the deferred RECOVERED event.
        rec = self._nodes.get(node_id)
        if rec is not None:
            rec.last_heartbeat = time.monotonic()
            if rec.suspect:
                rec.suspect = False
                rec.recovered_pending = True

    def bump_liveness(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self.liveness_counters[key] = \
                self.liveness_counters.get(key, 0) + n

    def is_suspect(self, node_id: str) -> bool:
        rec = self._nodes.get(node_id)
        return bool(rec is not None and rec.alive and rec.suspect)

    def liveness_stats(self) -> dict:
        """Per-node liveness view + transition counters (r17): the
        `liveness_stats` state op and the /metrics liveness gauges
        read this."""
        now = time.monotonic()
        with self._lock:
            nodes = [{
                "node_id": n.node_id,
                "is_head": n.is_head,
                "state": ("dead" if not n.alive
                          else "suspect" if n.suspect
                          else "draining" if n.draining
                          else "alive"),
                "last_heartbeat_age_s": round(now - n.last_heartbeat, 3),
            } for n in self._nodes.values()]
        with self._counter_lock:
            counters = dict(self.liveness_counters)
        return {"nodes": nodes, "counters": counters}

    def total_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.alive_nodes():
            for k, v in n.scheduler.total.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def available_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.alive_nodes():
            for k, v in n.scheduler.avail.items():
                out[k] = out.get(k, 0.0) + v
        return out

    # ------------------------------------------------- worker routing
    def scheduler_for_worker(self, worker_id: str) -> Optional[Scheduler]:
        # Snapshot under the cluster lock, probe AFTER releasing it:
        # owns_worker takes the node's scheduler lock, and dispatch paths
        # hold that lock while calling back into cluster methods — probing
        # lock-held is a cluster->scheduler / scheduler->cluster ABBA
        # (flagged by the RAY_TPU_DEBUG_LOCKS order detector).
        with self._lock:
            nodes = list(self._nodes.values())
        for n in nodes:
            if n.scheduler.owns_worker(worker_id):
                return n.scheduler
        return None

    def scheduler_for_node(self, node_id: str) -> Optional[Scheduler]:
        rec = self.get_node(node_id)
        return rec.scheduler if rec else None

    # -------------------------------------------------------- placement
    def submit(self, spec) -> None:
        """Route a TaskSpec/ActorSpec to a node queue (two-stage
        scheduling, stage 1: ClusterTaskManager::QueueAndScheduleTask)."""
        affinity = getattr(spec, "node_id", None)
        if affinity:
            rec = self.get_node(affinity)
            if rec is None or not rec.alive:
                if getattr(spec, "affinity_soft", False):
                    spec.node_id = None  # soft: fall back anywhere
                else:
                    # Hard affinity to a dead node fails immediately
                    # (reference NodeAffinitySchedulingStrategy
                    # soft=False semantics) instead of hanging.
                    self._rt.on_unplaceable(
                        spec, f"node {affinity} is dead or unknown")
                    return
        node = self._select_node(spec)
        if node is None:
            pg_id = getattr(spec, "placement_group_id", None)
            if pg_id:
                pg = self._pgs.get(pg_id)
                if pg is None or pg.state == PG_REMOVED:
                    self._rt.on_unplaceable(
                        spec, f"placement group {pg_id} does not exist "
                        f"or was removed")
                    return
                # PG pending/rescheduling: park until bundles reserve.
                with self._lock:
                    self._infeasible.append(spec)
                return
            with self._lock:
                self._infeasible.append(spec)
            import sys
            sys.stderr.write(
                f"ray_tpu_torch: no node can ever satisfy resources "
                f"{getattr(spec, 'resources', {})} for "
                f"{getattr(spec, 'name', spec)} — task will hang until a "
                f"node with capacity joins\n")
            return
        node.scheduler.enqueue(spec)

    def try_spill(self, spec, from_node_id: str) -> bool:
        """Stage-1 re-placement for a task aging in a node queue.

        Returns True if the spec was moved to another node."""
        if getattr(spec, "node_id", None) or getattr(
                spec, "placement_group_id", None):
            return False                  # constrained: cannot move
        constraints = getattr(spec, "label_constraints", None)
        need = Scheduler.need_of(spec)
        best = None
        for n in self.schedulable_nodes():
            if n.node_id == from_node_id:
                continue
            if constraints is not None:
                from ray_tpu_torch.util.scheduling_strategies import \
                    labels_match
                if not labels_match(n.labels, constraints[0]):
                    continue
            if fits(n.scheduler.effective_avail(), need):
                best = n
                break
        if best is None:
            return False
        best.scheduler.enqueue(spec)
        return True

    def _select_node(self, spec) -> Optional[NodeRecord]:
        """Hybrid policy (hybrid_scheduling_policy.h:50): walk nodes in
        creation order packing onto any node under the utilization
        threshold that fits; else least-utilized feasible node; honours
        node-affinity and PG bundle locations first."""
        affinity = getattr(spec, "node_id", None)
        pg_id = getattr(spec, "placement_group_id", None)
        # Draining nodes take nothing new; explicit affinity/PG-bundle
        # placements below still resolve (the user pinned them there).
        nodes = self.schedulable_nodes()
        if affinity:
            rec = self.get_node(affinity)
            return rec if rec is not None and rec.alive else None
        if pg_id:
            pg = self._pgs.get(pg_id)
            if pg is None or pg.state == PG_REMOVED:
                return None
            idx = getattr(spec, "placement_group_bundle_index", -1)
            candidates = (pg.bundle_nodes if idx in (-1, None)
                          else [pg.bundle_nodes[idx]])
            for nid in candidates:
                rec = self.get_node(nid) if nid else None
                if rec is not None and rec.alive:
                    return rec
            return None
        need = Scheduler.need_of(spec)
        feasible = [n for n in nodes if fits(n.scheduler.total, need)]
        constraints = getattr(spec, "label_constraints", None)
        if constraints is not None:
            # node-label scheduling (reference
            # NodeLabelSchedulingStrategy): hard constraints filter,
            # soft constraints prefer among the survivors
            from ray_tpu_torch.util.scheduling_strategies import labels_match
            hard, soft = constraints
            feasible = [n for n in feasible
                        if labels_match(n.labels, hard)]
            if soft:
                preferred = [n for n in feasible
                             if labels_match(n.labels, soft)]
                if preferred:
                    feasible = preferred
        if not feasible:
            return None
        # AT MOST one effective_avail snapshot (= one scheduler-lock
        # round trip) per node per selection, taken lazily: the
        # pack/spread phases below previously re-took that hot lock
        # 3-5x per submit, serializing submission against dispatch/
        # completion processing — a large share of per-submit head CPU
        # under a drain (r7 profile). Lazy, so the common case (first
        # node passes the pack check) still touches one node.
        eff_cache: dict = {}
        util_cache: dict = {}

        def _eff(n):
            e = eff_cache.get(id(n))
            if e is None:
                e = eff_cache[id(n)] = n.scheduler.effective_avail()
            return e

        def _util(n):
            u = util_cache.get(id(n))
            if u is None:
                u = util_cache[id(n)] = Scheduler.utilization_from(
                    _eff(n), n.scheduler.total)
            return u

        # Locality phase (reference locality-aware hybrid policy:
        # scheduling prefers nodes already holding the task's argument
        # bytes): consult the cluster object directory for where the
        # spec's pinned refs live, and take the best-scoring feasible
        # node if it can run the task NOW. Directory misses (inline
        # args, single-node, head-resident objects) cost one empty-dict
        # check.
        pinned = getattr(spec, "pinned_refs", None)
        if pinned and _CFG.scheduler_locality:
            ctrl = getattr(self._rt, "controller", None)
            directory = getattr(ctrl, "directory", None) if ctrl else None
            if directory is not None and not directory.empty():
                scores = directory.locality_bytes(
                    pinned, [n.node_id for n in feasible])
                if scores:
                    local = [n for n in feasible
                             if scores.get(n.node_id)]
                    local.sort(key=lambda n: -scores[n.node_id])
                    for n in local:
                        if fits(_eff(n), need):
                            return n

        # Pack phase: first node (stable order) with enough room now and
        # below the utilization threshold (both incl. queued demand).
        for n in feasible:
            if _util(n) < _HYBRID_THRESHOLD and fits(_eff(n), need):
                return n
        # Spread phase: least-utilized node that fits now.
        fitting = [n for n in feasible if fits(_eff(n), need)]
        if fitting:
            return min(fitting, key=_util)
        # Nothing fits *now*: queue on the least-utilized feasible node;
        # its dispatch loop waits for resources (or spills back later).
        return min(feasible, key=_util)

    def _retry_infeasible(self) -> None:
        with self._lock:
            specs, self._infeasible = self._infeasible, []
        for spec in specs:
            self.submit(spec)

    # ------------------------------------------------- placement groups
    def create_pg(self, bundles: List[dict], strategy: str,
                  name: str = "") -> PGRecord:
        if strategy not in ("PACK", "SPREAD", "STRICT_PACK",
                            "STRICT_SPREAD"):
            raise ValueError(f"unknown placement strategy {strategy!r}")
        if not bundles:
            raise ValueError("placement group needs at least one bundle")
        for b in bundles:
            if not b or any(v < 0 for v in b.values()):
                raise ValueError(f"invalid bundle {b!r}")
        pg = PGRecord(pg_id="pg_" + uuid.uuid4().hex[:8],
                      bundles=[dict(b) for b in bundles],
                      strategy=strategy, name=name,
                      bundle_nodes=[None] * len(bundles))
        self._check_feasible_ever(pg)
        with self._lock:
            self._pgs[pg.pg_id] = pg
        if not self._try_reserve(pg):
            with self._lock:
                self._pending_pgs.append(pg.pg_id)
        self._rt.controller.register_pg_view(self.pg_table_entry(pg))
        return pg

    def _check_feasible_ever(self, pg: PGRecord) -> None:
        """Raise if no future availability could ever satisfy the PG
        (VERDICT r1: unschedulable must raise, not silently ignore).
        Under autoscaling, feasibility is judged against the
        autoscaler's node TYPES (capacity can appear) instead of live
        nodes."""
        if self.autoscaling_enabled:
            types = self.autoscaler_node_types
            if types:
                for b in pg.bundles:
                    if not any(fits(t, b) for t in types):
                        raise PlacementGroupUnschedulableError(
                            f"no autoscaler node type can fit bundle "
                            f"{b} (types: {types})")
            return
        nodes = self.alive_nodes()
        if pg.strategy == "STRICT_SPREAD":
            if len(pg.bundles) > len(nodes):
                raise PlacementGroupUnschedulableError(
                    f"STRICT_SPREAD needs {len(pg.bundles)} nodes, "
                    f"cluster has {len(nodes)}")
            unplaced = [b for b in pg.bundles
                        if not any(fits(n.scheduler.total, b)
                                   for n in nodes)]
            if unplaced:
                raise PlacementGroupUnschedulableError(
                    f"no node can fit bundle {unplaced[0]}")
        elif pg.strategy == "STRICT_PACK":
            merged: Dict[str, float] = {}
            for b in pg.bundles:
                for k, v in b.items():
                    merged[k] = merged.get(k, 0.0) + v
            if not any(fits(n.scheduler.total, merged) for n in nodes):
                raise PlacementGroupUnschedulableError(
                    f"no single node can fit STRICT_PACK total {merged}")
        else:
            for b in pg.bundles:
                if not any(fits(n.scheduler.total, b) for n in nodes):
                    raise PlacementGroupUnschedulableError(
                        f"no node can ever fit bundle {b}")

    def _try_reserve(self, pg: PGRecord) -> bool:
        """2-phase: plan an assignment against current availability,
        reserve each bundle, roll back all on any failure."""
        plan = self._plan_bundles(pg)
        if plan is None:
            return False
        reserved: List[Tuple[str, int]] = []
        for idx, node_id in enumerate(plan):
            sched = self.scheduler_for_node(node_id)
            if sched is None or not sched.reserve_bundle(
                    pg.pg_id, idx, pg.bundles[idx]):
                for nid, i in reserved:      # rollback
                    s = self.scheduler_for_node(nid)
                    if s is not None:
                        s.release_bundle(pg.pg_id, i)
                return False
            reserved.append((node_id, idx))
        pg.bundle_nodes = list(plan)
        pg.state = PG_CREATED
        self._rt.controller.register_pg_view(self.pg_table_entry(pg))
        return True

    def _plan_bundles(self, pg: PGRecord) -> Optional[List[str]]:
        nodes = self.schedulable_nodes()
        if not nodes:
            return None
        # Work on copies of availability so the plan is consistent.
        avail = {n.node_id: dict(n.scheduler.avail) for n in nodes}
        order = [n.node_id for n in nodes]

        def take(nid, b):
            for k, v in b.items():
                avail[nid][k] = avail[nid].get(k, 0.0) - v

        plan: List[Optional[str]] = [None] * len(pg.bundles)
        if pg.strategy == "STRICT_PACK":
            for nid in order:
                trial = dict(avail[nid])
                ok = True
                for b in pg.bundles:
                    if not fits(trial, b):
                        ok = False
                        break
                    for k, v in b.items():
                        trial[k] = trial.get(k, 0.0) - v
                if ok:
                    return [nid] * len(pg.bundles)
            return None
        if pg.strategy == "STRICT_SPREAD":
            used: set = set()
            for idx, b in enumerate(pg.bundles):
                placed = False
                for nid in order:
                    if nid in used or not fits(avail[nid], b):
                        continue
                    plan[idx] = nid
                    used.add(nid)
                    placed = True
                    break
                if not placed:
                    return None
            return plan  # type: ignore[return-value]
        if pg.strategy == "SPREAD":
            # Round-robin best effort across nodes.
            i = 0
            for idx, b in enumerate(pg.bundles):
                placed = False
                for off in range(len(order)):
                    nid = order[(i + off) % len(order)]
                    if fits(avail[nid], b):
                        plan[idx] = nid
                        take(nid, b)
                        i = (i + off + 1) % len(order)
                        placed = True
                        break
                if not placed:
                    return None
            return plan  # type: ignore[return-value]
        # PACK: fill nodes in order, overflow to the next.
        for idx, b in enumerate(pg.bundles):
            placed = False
            for nid in order:
                if fits(avail[nid], b):
                    plan[idx] = nid
                    take(nid, b)
                    placed = True
                    break
            if not placed:
                return None
        return plan  # type: ignore[return-value]

    def _retry_pending_pgs(self) -> None:
        with self._lock:
            pending, self._pending_pgs = self._pending_pgs, []
        reserved_any = False
        for pg_id in pending:
            pg = self._pgs.get(pg_id)
            if pg is None or pg.state in (PG_CREATED, PG_REMOVED):
                continue
            if self._try_reserve(pg):
                reserved_any = True
            else:
                with self._lock:
                    self._pending_pgs.append(pg_id)
        if reserved_any:
            self._retry_infeasible()   # tasks parked on pending PGs

    def remove_pg(self, pg_id: str) -> None:
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None or pg.state == PG_REMOVED:
                return
            pg.state = PG_REMOVED
            if pg_id in self._pending_pgs:
                self._pending_pgs.remove(pg_id)
        for idx, nid in enumerate(pg.bundle_nodes):
            if nid is None:
                continue
            sched = self.scheduler_for_node(nid)
            if sched is not None:
                sched.release_bundle(pg_id, idx)
        self._rt.controller.register_pg_view(self.pg_table_entry(pg))

    def get_pg(self, pg_id: str) -> Optional[PGRecord]:
        with self._lock:
            return self._pgs.get(pg_id)

    def wait_pg(self, pg_id: str, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            pg = self.get_pg(pg_id)
            if pg is None or pg.state == PG_REMOVED:
                return False
            if pg.state == PG_CREATED:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            self._retry_pending_pgs()
            time.sleep(0.05)

    def pg_table_entry(self, pg: PGRecord) -> dict:
        return {"placement_group_id": pg.pg_id, "state": pg.state,
                "bundles": pg.bundles, "strategy": pg.strategy,
                "name": pg.name, "bundle_nodes": list(pg.bundle_nodes)}

    def fail_type_infeasible(self, type_fits) -> None:
        """Fail parked tasks whose shape NO autoscaler node type can
        satisfy (they would otherwise wait forever; reference
        autoscaler surfaces these as infeasible-request errors)."""
        with self._lock:
            doomed = [s for s in self._infeasible
                      if not type_fits(dict(getattr(s, "resources", None)
                                            or {"CPU": 1.0}))]
            for s in doomed:
                self._infeasible.remove(s)
        for s in doomed:
            self._rt.on_unplaceable(
                s, "no autoscaler node type can satisfy "
                   f"{getattr(s, 'resources', None)}")

    def cancel_parked(self, task_id: str):
        """Remove + return a task parked as infeasible (cancel path:
        parked tasks are in NO node queue, so node-level cancel misses
        them)."""
        with self._lock:
            for spec in list(self._infeasible):
                if getattr(spec, "task_id", None) == task_id:
                    self._infeasible.remove(spec)
                    return spec
        return None

    def pg_table(self) -> List[dict]:
        with self._lock:
            return [self.pg_table_entry(pg) for pg in self._pgs.values()]

    # --------------------------------------------- head-restart rejoin
    def expect_rejoin(self, node_id: str, grace_s: float) -> None:
        """A rehydrated node gets `grace_s` to re-register before its
        actors/objects are recovered as dead."""
        with self._lock:
            self._rejoining[node_id] = time.monotonic() + grace_s

    def restore_pgs(self, entries: List[dict]) -> None:
        """Rebuild PG records from rehydrated controller views. Bundle
        reservations live agent-side and survive the head restart; a
        node that never rejoins triggers rescheduling via
        _fail_rejoining_node."""
        with self._lock:
            for e in entries:
                pg = PGRecord(
                    pg_id=e["placement_group_id"],
                    bundles=[dict(b) for b in e["bundles"]],
                    strategy=e["strategy"], name=e.get("name", ""),
                    state=e["state"],
                    bundle_nodes=list(e.get("bundle_nodes",
                                            [None] * len(e["bundles"]))))
                self._pgs[pg.pg_id] = pg
                if pg.state in (PG_PENDING, PG_RESCHEDULING):
                    self._pending_pgs.append(pg.pg_id)

    def _fail_rejoining_node(self, node_id: str) -> None:
        """A rehydrated node missed its rejoin deadline: run the
        node-death recovery that _on_node_death would have (there is no
        NodeRecord/scheduler to drain — the head that owned it died)."""
        with self._lock:
            if node_id in self._nodes:
                # the agent's registration raced the deadline sweep and
                # won: it is alive — do not recover (duplicate) actors
                return
        self._rt.controller.set_node_state(
            node_id, alive=False, cause="did not rejoin after head restart")
        self._rt.controller.publish_node_event(
            node_id, "DEAD", cause="did not rejoin after head restart")
        # r15: the node's rehydrated spec mirror was parked awaiting its
        # rejoin — its workers died with the old head's cluster, so
        # every mirrored plain task re-places exactly once (the r10
        # agent-death resubmit semantics, driven from persisted state)
        ha = getattr(self._rt, "_ha", None)
        pend = ha.take_pending_node(node_id) if ha is not None else None
        self._rt.controller.bump_incarnation(node_id)
        if pend is not None:
            for key, (spec, _dispatched) in pend.work.items():
                if isinstance(spec, TaskSpec):
                    self._rt.controller.record_task_event(
                        spec.task_id, spec.name, "RESUBMITTED",
                        error=f"node {node_id} did not rejoin after "
                              f"head restart")
                    try:
                        bump_attempt(spec)
                        self.submit(spec)
                    except Exception:
                        log.exception("rejoin-expiry resubmit failed")
        for actor_id in self._rt.controller.actors_on_node(node_id):
            self._rt._recover_actor(actor_id)
        if hasattr(self._rt, "on_node_objects_lost"):
            self._rt.on_node_objects_lost(node_id)
        self._reschedule_pgs_for(node_id)

    def _reschedule_pgs_for(self, node_id: str) -> None:
        """Bundles reserved on a dead node go back to pending and try to
        re-reserve elsewhere (GcsPlacementGroupManager rescheduling)."""
        with self._lock:
            hit = [pg for pg in self._pgs.values()
                   if pg.state == PG_CREATED and node_id in pg.bundle_nodes]
        for pg in hit:
            for idx, nid in enumerate(pg.bundle_nodes):
                if nid is not None and nid != node_id:
                    sched = self.scheduler_for_node(nid)
                    if sched is not None:
                        sched.release_bundle(pg.pg_id, idx)
            pg.bundle_nodes = [None] * len(pg.bundles)
            pg.state = PG_RESCHEDULING
            if not self._try_reserve(pg):
                with self._lock:
                    self._pending_pgs.append(pg.pg_id)

    # ------------------------------------------- delegated steal (r10)
    def _rebalance_loop(self) -> None:
        """Stage-1 spillback for DELEGATED agents: local queues spill
        themselves (`Scheduler._spill_aged_locked`), but an agent runs
        with cluster=None and its bulk-leased backlog is invisible to
        any local spill scan — so the head, which still owns every
        leased spec, periodically revokes queued-not-started work from
        an agent reporting unmet demand and re-places it on a node
        with room (reference ClusterTaskManager::ScheduleOnNode
        redirect, applied to leases)."""
        while self._running:
            time.sleep(1.0)
            try:
                self._rebalance_once()
            except Exception:
                log.exception("delegated rebalance sweep failed")

    def _rebalance_once(self) -> None:
        nodes = self.alive_nodes()
        if len(nodes) < 2:
            return
        for n in nodes:
            h = n.scheduler
            if (getattr(h, "revoke_lease", None) is None
                    or not h.delegates()):
                continue            # local node / pre-delegation agent
            shapes = h.pending_shapes()
            if not shapes:
                continue            # no unmet demand: nothing stuck
            if not any(fits(m.scheduler.effective_avail(), shapes[0])
                       for m in nodes
                       if m is not n and m.alive and not m.draining
                       and not m.suspect):
                continue            # nowhere better: leave the lease
            ids = h.steal_candidates()
            if ids:
                # fire-and-forget: the agent's lease_reclaimed event
                # hands the specs back and the runtime re-places them
                # (spill-count-capped there) — no blocking reply to
                # stall this sweep against a wedged agent
                h.revoke_lease(ids)

    # ----------------------------------------------------- node failure
    def _monitor_loop(self) -> None:
        """GcsHealthCheckManager parity: staleness-based liveness.

        A tick that comes late by more than half a period means this
        process stalled (a multi-GB copy in one C call holds the GIL):
        no heartbeat was read meanwhile, so the stall is credited to
        every node's heartbeat before the sweep, and only time this
        process could listen counts against a node (ROADMAP queue 3,
        item 12)."""
        period = 0.5
        last = time.monotonic()
        while self._running:
            time.sleep(period)
            now = time.monotonic()
            late, last = now - last - period, now
            try:
                if late > period / 2:
                    self._credit_stall(late, now)
                self._sweep_liveness()
            except Exception:
                log.exception("liveness sweep failed")

    def _credit_stall(self, stalled_s: float, now: float) -> None:
        """Move every live node's last heartbeat `stalled_s` later (never
        past `now`): a heartbeat that arrived while this process could
        not read it must not age the node toward a death."""
        self.bump_liveness("stalls_credited")
        with self._lock:
            for n in self._nodes.values():
                if n.alive:
                    n.last_heartbeat = min(now, n.last_heartbeat + stalled_s)

    def _sweep_liveness(self) -> None:
        """One liveness pass (r17: alive -> SUSPECT -> dead instead of
        alive -> dead). Separated from the loop so tests drive
        deterministic transitions. SUSPECT is pure routing state — no
        recovery runs, which is the whole point: a blip shorter than
        the death timeout costs scheduling preference, not a node-
        death recovery (and heartbeat() clears it for free)."""
        now = time.monotonic()
        suspect_s = _CFG.suspect_s
        dead_s = _CFG.heartbeat_timeout_s
        if suspect_s >= dead_s > 0:
            # the documented constraint is suspect_s < timeout; an
            # operator lowering the death timeout alone would
            # otherwise silently lose the whole suspect state (the
            # death branch always wins) — clamp and say so once
            if not getattr(self, "_suspect_clamp_warned", False):
                self._suspect_clamp_warned = True
                log.warning(
                    "RAY_TPU_SUSPECT_S (%.2fs) >= heartbeat_timeout_s "
                    "(%.2fs); clamping suspicion to %.2fs", suspect_s,
                    dead_s, dead_s / 2.0)
            suspect_s = dead_s / 2.0
        dead = []
        expired = []
        suspected = []
        recovered = []
        with self._lock:
            for n in self._nodes.values():
                if not n.alive:
                    # death already superseded any pending recovery
                    # event (never publish RECOVERED after DEAD)
                    n.recovered_pending = False
                    continue
                if n.recovered_pending:
                    n.recovered_pending = False
                    recovered.append(n.node_id)
                age = now - n.last_heartbeat
                if age > dead_s and not (
                        n.is_head and getattr(n.scheduler, "_running", False)):
                    # the head node's scheduler runs in this process:
                    # while it runs, a stale head heartbeat is this
                    # process stalled (a multi-GB copy holding the GIL),
                    # never a dead node (ROADMAP queue 3, item 9); a head
                    # node killed by `remove_node(graceful=False)` has
                    # stopped it and dies as any other (item 11)
                    dead.append(n.node_id)
                elif (suspect_s > 0 and not n.suspect and not n.is_head
                        and age > suspect_s):
                    n.suspect = True
                    # heartbeat() is lock-free by contract and may
                    # have landed between our age read and the flag
                    # set: re-check so a fresh beat is never wrongly
                    # suspected for a whole sweep period
                    if now - n.last_heartbeat <= suspect_s:
                        n.suspect = False
                        n.recovered_pending = False
                    else:
                        suspected.append(n.node_id)
            for nid, deadline in list(self._rejoining.items()):
                if now > deadline:
                    self._rejoining.pop(nid)
                    expired.append(nid)
        for nid in suspected:
            self.bump_liveness("suspected")
            self._rt.controller.publish_node_event(
                nid, "SUSPECT", cause="heartbeat stale")
        for nid in recovered:
            self.bump_liveness("recovered")
            self._rt.controller.publish_node_event(
                nid, "RECOVERED", cause="heartbeat resumed")
        if recovered:
            # a blip may have parked fresh submissions as infeasible
            # (every capable node was suspect): re-place them now
            self._retry_infeasible()
        for nid in dead:
            self._on_node_death(nid, cause="heartbeat timeout")
        for nid in expired:
            try:
                self._fail_rejoining_node(nid)
            except Exception:
                # the node was already popped from _rejoining, so
                # this recovery will not re-run — never lose it
                # silently
                log.exception("rejoin-expiry recovery for %s failed",
                              nid)

    def _on_node_death(self, node_id: str, cause: str) -> None:
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None or not rec.alive:
                return
            rec.alive = False
            rec.suspect = False
            rec.recovered_pending = False
            self._rt.controller.publish_node_event(node_id, "DEAD",
                                                   cause=cause)
        self.bump_liveness("deaths")
        self._rt.controller.set_node_state(node_id, alive=False,
                                           cause=cause)
        # 0. Fence the incarnation BEFORE any re-placement (r17): the
        #    node may be a partitioned/stalled zombie, not a corpse —
        #    from here on, frames still arriving under its old epoch
        #    are dropped and answered with NODE_FENCED, so nothing the
        #    zombie produces can race the recovery below.
        self._rt.controller.bump_incarnation(node_id)
        # 1. Tear down the node's workers; collect its queue + running
        #    work. A death declared by HEARTBEAT STALENESS keeps the
        #    agent's control connection open (a partition delivers no
        #    FIN either): if the node is actually alive, its next
        #    frame on that connection earns the NODE_FENCED answer
        #    that tells it to reset and re-register — closing the
        #    socket here would instead surface as a clean reconnect
        #    and hide the split-brain.
        keep_conn = (cause == "heartbeat timeout"
                     and getattr(rec.scheduler, "conn", None) is not None)
        if keep_conn:
            queued, running_tasks, actor_ids = \
                rec.scheduler.drain_for_death(close_conn=False)
            # Bounded fencing window: if the node really is dead (no
            # process left to ever close its end), the kept socket
            # would leak for the head's lifetime — reap it once the
            # window lapses and no NEW registration replaced it. A
            # partition outlasting the window still recovers: the
            # agent sees the close on heal and rejoins, where the
            # fresh incarnation + drained-mirror dedup give the same
            # exactly-once outcome as the fence path.
            old_conn = rec.scheduler.conn
            window = max(10.0, 3.0 * _CFG.heartbeat_timeout_s)

            def _reap(conn=old_conn):
                # idempotent: a fenced agent already closed its side,
                # and an ACTIVE chaos partition defers this close just
                # like any other (the relay keeps test semantics)
                try:
                    conn.close()
                except Exception:
                    pass

            t = threading.Timer(window, _reap)
            t.daemon = True
            t.start()
        else:
            queued, running_tasks, actor_ids = \
                rec.scheduler.drain_for_death()
        # 2. Re-place queued work (attempt bumped: a zombie's terminal
        #    event for the old attempt must lose to the re-placed
        #    winner, first-terminal-wins).
        for spec in queued:
            bump_attempt(spec)
            self.submit(spec)
        # 3. Recover running tasks and actors through the runtime's
        #    existing retry/restart machinery.
        for task in running_tasks:
            self._rt._recover_task(task)
        for actor_id in actor_ids:
            self._rt._recover_actor(actor_id)
        # 3b. Objects whose only copy lived on the dead node: lineage
        #     reconstruction (ResubmitTask parity).
        if hasattr(self._rt, "on_node_objects_lost"):
            self._rt.on_node_objects_lost(node_id)
        # 4. PG bundles reserved on the dead node go back to pending and
        #    try to re-reserve elsewhere (GcsPlacementGroupManager
        #    rescheduling path).
        self._reschedule_pgs_for(node_id)

    # -------------------------------------------------------- lifecycle
    def stats(self) -> dict:
        return {
            "nodes": [{
                "node_id": n.node_id, "alive": n.alive,
                "is_head": n.is_head,
                "draining": n.draining,
                "suspect": n.suspect,
                "resources_total": dict(n.scheduler.total),
                "resources_available": dict(n.scheduler.avail),
                "labels": n.labels,
            } for n in self.nodes()],
            "num_placement_groups": len(self._pgs),
            "infeasible_tasks": len(self._infeasible),
        }

    def shutdown(self) -> None:
        self._running = False
        for n in self.nodes():
            n.scheduler.shutdown()
