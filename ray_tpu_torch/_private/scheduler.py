"""Scheduler + worker pool: the raylet-equivalent per-node layer.

Parity map (reference src/ray/raylet/):
- ``Scheduler`` dispatch loop -> ClusterTaskManager::QueueAndScheduleTask +
  LocalTaskManager::DispatchScheduledTasksToWorkers
  (cluster_task_manager.cc:44, local_task_manager.cc:122) collapsed into one
  loop because the v0 cluster is one logical node owned by the driver.
- ``WorkerPool`` -> raylet WorkerPool (worker_pool.h:366 PopWorker): spawns
  `python -m ray_tpu_torch._private.worker_main` subprocesses on demand up to a
  cap, reusing idle ones keyed by runtime-env hash (dispatch prefers a
  worker whose applied env already matches, and workers keep their env
  applied between same-env tasks).
- blocked-worker resource release mirrors the reference's behavior where a
  worker blocked in `ray.get` releases its CPU so the node can oversubscribe
  (avoids the classic nested-task deadlock); its GPU cards stay with it,
  since its process stays pinned to them.
- resource accounting -> ClusterResourceScheduler fixed-point math
  (common/scheduling/) simplified to float math on dicts.
- GPU leases hold named cards (reference GPU instance ids,
  cluster_resource_data.h): the node's `CardPool`, or a bundle's carved
  out of it, gives each charge its cards, the TASK/ACTOR_CREATE frame
  carries them as `cards`, and the worker pins `CUDA_VISIBLE_DEVICES`
  to them. A worker that has initialised CUDA (it reports `cuda_bound`
  on its completions) takes only leases of the cards it is bound to.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ray_tpu_torch._private import metrics_plane as _mp
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.accelerators.gpu import (CardPool, Cards,
                                                     card_names, sub_cards)
from ray_tpu_torch._private.runtime_env import has_container
from ray_tpu_torch._private.specs import ActorSpec, ActorTaskSpec, TaskSpec

IDLE = "idle"
BUSY = "busy"
ACTOR = "actor"
STARTING = "starting"
DEAD = "dead"

from ray_tpu_torch._private.config import CONFIG as _CFG


@dataclass
class WorkerRec:
    worker_id: str
    proc: Optional[subprocess.Popen] = None
    conn: Optional[protocol.Connection] = None
    state: str = STARTING
    # In-flight normal tasks in dispatch (= execution) order; the worker
    # runs them FIFO on its single exec thread, so pipelining depth>1
    # overlaps the TASK_DONE round-trip with the next task's execution
    # (reference worker-lease pipelining).
    tasks: "dict[str, TaskSpec]" = field(default_factory=dict)
    # task_id -> (need, pg_key, charged): per-task resource charge so
    # completions release exactly their own share. charged=False marks
    # a task pipelined onto this worker's existing grant (reference
    # worker-lease model: a queued task reuses the lease's resources);
    # it is charged when its predecessor completes and releases them.
    task_res: dict = field(default_factory=dict)
    actor_id: Optional[str] = None
    # actor-lifetime resources (ACTOR workers only)
    acquired: dict[str, float] = field(default_factory=dict)
    # (pg_id, bundle_index) whose ledger `acquired` was charged against,
    # or None when charged against the node's free pool.
    pg_key: Optional[tuple] = None
    blocked_depth: int = 0
    started_at: float = field(default_factory=time.time)
    # hash of the runtime env last applied in this worker — dispatch
    # prefers matching workers so pooled workers skip env churn
    # (reference worker_pool.cc runtime-env-keyed reuse)
    env_hash: str = ""
    # spawned inside a container image: permanently bound to that env —
    # only exact-hash tasks may use it, and its hash never changes
    container: bool = False
    # cards of each GPU-holding entry of task_res, and of `acquired`
    task_cards: "dict[str, Cards]" = field(default_factory=dict)
    actor_cards: Optional[Cards] = None
    # the CUDA_VISIBLE_DEVICES the process had when it initialised CUDA
    # ("*" when it had none): it takes only GPU leases of exactly these
    bound_cards: Optional[str] = None


def _node_memory_fraction() -> float:
    """Fraction of node memory in use (1 - MemAvailable/MemTotal)."""
    try:
        with open("/proc/meminfo") as f:
            info = {}
            for line in f:
                k, _, rest = line.partition(":")
                info[k] = int(rest.split()[0])
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", total)
        if total <= 0:
            return 0.0
        return 1.0 - avail / total
    except OSError:
        return 0.0


def sample_host_stats(worker_pids=()) -> dict:
    """Per-node reporter sample (reference dashboard/modules/reporter):
    load, memory, and the worker pool's aggregate RSS — carried on node
    heartbeats and surfaced by the dashboard's /nodes endpoint."""
    stats: dict = {"ts": time.time(), "num_cpus": os.cpu_count(),
                   "num_workers": len(worker_pids)}
    try:
        stats["load_1m"] = round(os.getloadavg()[0], 2)
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as f:
            info = {}
            for line in f:
                k, _, rest = line.partition(":")
                info[k] = int(rest.split()[0])          # kB
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", total)
        stats["mem_total_mb"] = total // 1024
        stats["mem_available_mb"] = avail // 1024
        if total > 0:
            stats["mem_used_pct"] = round(100 * (1 - avail / total), 1)
    except OSError:
        pass
    rss = 0
    page = os.sysconf("SC_PAGE_SIZE")
    for pid in worker_pids:
        try:
            with open(f"/proc/{pid}/statm") as f:
                rss += int(f.read().split()[1]) * page
        except (OSError, ValueError, IndexError):
            pass
    stats["workers_rss_mb"] = rss // (1024 * 1024)
    return stats


def fits(avail: dict[str, float], need: dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in need.items() if v)


def acquire(avail: dict[str, float], need: dict[str, float]) -> None:
    for k, v in need.items():
        if v:
            avail[k] = avail.get(k, 0.0) - v


def release(avail: dict[str, float], got: dict[str, float]) -> None:
    for k, v in got.items():
        if v:
            avail[k] = avail.get(k, 0.0) + v




class Scheduler:
    """Per-node scheduler: task queue, resource ledger, worker pool.

    One instance per (simulated or real) node; the ClusterTaskManager
    routes work between instances and monitors their heartbeats."""

    def __init__(self, runtime, node_resources: dict[str, float],
                 listen_addr: tuple[str, int],
                 max_workers: Optional[int] = None,
                 node_id: Optional[str] = None, cluster=None):
        self._rt = runtime
        self.node_id = node_id or ("node_" + uuid.uuid4().hex[:8])
        self._cluster = cluster
        self.total = dict(node_resources)
        self.avail = dict(node_resources)
        self._cards = CardPool.of_node(node_resources.get("GPU", 0.0))
        self._card_names = card_names(len(self._cards.free))
        self._addr = listen_addr
        self._max_workers = (max_workers or _CFG.worker_pool_max
                             or max(int(node_resources.get("CPU", 4)) * 2,
                                    8))
        from ray_tpu_torch._private.debug_sync import make_lock
        self._lock = make_lock(f"scheduler:{self.node_id}",
                               reentrant=True)
        self._cv = threading.Condition(self._lock)
        self._pending: deque = deque()           # TaskSpec | ActorSpec
        self._queued_at: dict[int, float] = {}   # id(spec) -> enqueue time
        # Running sum of queued-but-undispatched demand, maintained on
        # every queue mutation: effective_avail() and the hybrid policy
        # read it O(1) instead of rescanning the queue (that rescan made
        # submission O(n^2) past ~1k queued tasks).
        self._pending_demand: dict[str, float] = {}
        self._last_spill_scan = 0.0
        self._workers: dict[str, WorkerRec] = {}
        # (pg_id, bundle_index) -> {"total": {...}, "avail": {...}}
        self._bundles: dict[tuple, dict] = {}
        self._running = True
        self._spawning = 0
        # Drain state (r14 preemption notice): a draining node keeps
        # running what it has but receives no NEW placements — the
        # cluster's routing (submit/spill/PG planning) skips it and its
        # queued-not-started backlog is reclaimed via reclaim_tasks.
        self.draining = False
        # Memory-pressure monitor (reference raylet memory_monitor +
        # worker_killing_policy.cc): injectable for tests.
        self.memory_fraction_fn: Callable[[], float] = \
            _node_memory_fraction
        self._last_mem_check = 0.0
        self._last_mem_kill = 0.0
        self._thread = threading.Thread(
            target=self._loop, name=f"ray-tpu-sched-{self.node_id}",
            daemon=True)

    def start(self) -> None:
        self._thread.start()

    # ---- placement-group bundle ledgers ----
    def reserve_bundle(self, pg_id: str, index: int,
                       resources: dict[str, float]) -> bool:
        """Phase-1 reserve: carve the bundle, and its cards, out of the
        node free pool."""
        with self._cv:
            if not fits(self.avail, resources):
                return False
            cards = None
            if resources.get("GPU"):
                cards = self._cards.choose(resources["GPU"])
                if cards is None:
                    return False
            self._charge(None, resources, cards)
            self._bundles[(pg_id, index)] = {
                "total": dict(resources), "avail": dict(resources),
                "cards": CardPool(dict(cards or ()))}
            return True

    def release_bundle(self, pg_id: str, index: int) -> None:
        """Return a bundle's unused capacity to the free pool. Resources
        held by still-running bundle workers rejoin the pool when those
        workers finish (their pg_key no longer resolves)."""
        with self._cv:
            led = self._bundles.pop((pg_id, index), None)
            if led is not None:
                self._refund(None, led["avail"],
                             tuple(led["cards"].free.items()))
                if self._running and self._pending:
                    self._try_dispatch_locked(self._INLINE_SCAN_LIMIT)
            self._cv.notify_all()

    def _bundle_for(self, spec) -> Optional[tuple]:
        pg_id = getattr(spec, "placement_group_id", None)
        if not pg_id:
            return None
        idx = getattr(spec, "placement_group_bundle_index", -1)
        if idx is not None and idx >= 0:
            # The bundle may have left this node (remove_placement_group /
            # reschedule during the seconds-long worker spawn); returning
            # the key unconditionally would KeyError in dispatch and kill
            # the scheduler thread.
            return (pg_id, idx) if (pg_id, idx) in self._bundles else None
        # index -1: any bundle of this pg on this node that fits.
        need = self.need_of(spec)
        for key, led in self._bundles.items():
            if key[0] == pg_id and fits(led["avail"], need):
                return key
        # fall back to any bundle of the pg (task waits for capacity)
        for key in self._bundles:
            if key[0] == pg_id:
                return key
        return None

    # ---- submission ----
    def _demand_add(self, spec) -> None:
        for k, v in self._effective_need(spec).items():
            if v:
                self._pending_demand[k] = self._pending_demand.get(k, 0.0) + v

    def _demand_sub(self, spec) -> None:
        for k, v in self._effective_need(spec).items():
            if v:
                left = self._pending_demand.get(k, 0.0) - v
                if left > 1e-9:
                    self._pending_demand[k] = left
                else:
                    self._pending_demand.pop(k, None)

    def enqueue(self, spec) -> None:
        with self._cv:
            was_empty = not self._pending
            self._pending.append(spec)
            self._queued_at[id(spec)] = time.monotonic()
            self._demand_add(spec)
            # Inline dispatch on the submitting thread — saves a
            # scheduler-loop thread handoff (the dominant sync-RTT cost
            # on 1 core) — but ONLY when the queue was empty: with a
            # backlog, this spec cannot jump the queue, and a per-
            # enqueue scan makes bulk submission O(n^2). Completions
            # drive dispatch while a backlog exists.
            if self._running and was_empty:
                self._try_dispatch_locked(self._INLINE_SCAN_LIMIT)
            self._cv.notify_all()

    def enqueue_many(self, specs) -> None:
        """Queue a bulk-lease batch under ONE lock acquisition with
        ONE trailing dispatch sweep (r10 delegated dispatch: a 64-spec
        lease would otherwise pay 64 lock round-trips and up to 64
        inline sweeps on the agent's head-connection reader)."""
        if not specs:
            return
        with self._cv:
            now = time.monotonic()
            for spec in specs:
                self._pending.append(spec)
                self._queued_at[id(spec)] = now
                self._demand_add(spec)
            if self._running:
                self._try_dispatch_locked(self._INLINE_SCAN_LIMIT)
            self._cv.notify_all()

    def enqueue_front(self, spec) -> None:
        with self._cv:
            self._pending.appendleft(spec)
            self._queued_at[id(spec)] = time.monotonic()
            self._demand_add(spec)
            if self._running:
                self._try_dispatch_locked(self._INLINE_SCAN_LIMIT)
            self._cv.notify_all()

    def cancel_pending(self, task_id: str) -> Optional[TaskSpec]:
        with self._cv:
            for spec in list(self._pending):
                if isinstance(spec, TaskSpec) and spec.task_id == task_id:
                    self._pending.remove(spec)
                    self._queued_at.pop(id(spec), None)
                    self._demand_sub(spec)
                    return spec
        return None

    # ---- worker lifecycle ----
    def spawn_worker(self, renv: Optional[dict] = None) -> WorkerRec:
        wid = "w_" + uuid.uuid4().hex[:8]
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_WORKER_ID"] = wid
        env["RAY_TPU_NODE_ID"] = self.node_id
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.worker_main",
               "--addr", f"{self._addr[0]}:{self._addr[1]}",
               "--worker-id", wid]
        spawn_hash = ""
        from ray_tpu_torch._private.runtime_env import (container_command,
                                                  has_container)
        if has_container(renv):
            # the worker process itself must start inside the image
            # (reference image_uri plugin); the worker is permanently
            # bound to this env — marked via env_hash at spawn so only
            # matching tasks reuse it
            cmd = container_command(renv, cmd)
            from ray_tpu_torch._private.runtime_env import env_hash
            spawn_hash = env_hash(renv) or ""
        proc = subprocess.Popen(cmd, env=env)
        rec = WorkerRec(worker_id=wid, proc=proc, env_hash=spawn_hash,
                        container=bool(spawn_hash))
        with self._cv:
            self._workers[wid] = rec
            self._spawning += 1
        return rec

    def on_worker_registered(self, worker_id: str,
                             conn: protocol.Connection) -> None:
        with self._cv:
            rec = self._workers.get(worker_id)
            if rec is None:             # worker from a previous epoch
                conn.close()
                return
            rec.conn = conn
            if rec.state == STARTING:
                rec.state = IDLE
                self._spawning = max(0, self._spawning - 1)
            conn.meta["worker_id"] = worker_id
            # the driver side of a worker connection is a hot emitter
            # (TASK dispatch bursts): coalesce its fire-and-forget sends
            conn.enable_coalescing()
            self._cv.notify_all()

    def on_worker_lost(self, worker_id: str):
        """Returns (in-flight tasks, actor_id) for recovery."""
        with self._cv:
            rec = self._workers.get(worker_id)
            if rec is None or rec.state == DEAD:
                return [], None
            if rec.state == STARTING:
                self._spawning = max(0, self._spawning - 1)
            tasks, actor_id = list(rec.tasks.values()), rec.actor_id
            self._release_worker_res_locked(rec)
            rec.state = DEAD
            rec.tasks.clear()
            rec.task_res.clear()
            rec.task_cards.clear()
            rec.acquired = {}
            rec.actor_cards = None
            rec.pg_key = None
            self._cv.notify_all()
            return tasks, actor_id

    # ---- aggregate per-worker resource charge (blocked release etc.)
    def _ledger_for_key(self, pg_key) -> dict[str, float]:
        if pg_key is not None:
            led = self._bundles.get(pg_key)
            if led is not None:
                return led["avail"]
        return self.avail

    def _cards_for_key(self, pg_key) -> CardPool:
        """The card pool beside `_ledger_for_key(pg_key)`: a released
        bundle's cards went back to the node's."""
        if pg_key is not None:
            led = self._bundles.get(pg_key)
            if led is not None:
                return led["cards"]
        return self._cards

    def _charge(self, pg_key, need: dict[str, float],
                cards: Optional[Cards]) -> None:
        acquire(self._ledger_for_key(pg_key), need)
        self._cards_for_key(pg_key).charge(cards)

    def _refund(self, pg_key, got: dict[str, float],
                cards: Optional[Cards]) -> None:
        release(self._ledger_for_key(pg_key), got)
        self._cards_for_key(pg_key).refund(cards)

    def _lease_str(self, cards: Cards) -> str:
        """A lease's cards as `CUDA_VISIBLE_DEVICES` names them."""
        return ",".join(self._card_names[i] for i, _ in cards)

    def _promote_next_charge_locked(self, rec: WorkerRec) -> None:
        """Lease handoff: after a CHARGED entry leaves rec.task_res
        (completion or steal-back), charge the oldest uncharged
        successor out of the share just released — its need fits by
        the dispatch-time chain condition. While the worker is
        blocked, charges are parked: mark only; worker_unblocked
        re-acquires marked entries."""
        for tid, (need, pg_key, charged) in rec.task_res.items():
            if not charged:
                self._settle_locked(rec, pg_key, need,
                                    rec.task_cards.get(tid), charge=True)
                rec.task_res[tid] = (need, pg_key, True)
                break

    def _settle_locked(self, rec: WorkerRec, pg_key, need: dict,
                       cards: Optional[Cards], charge: bool) -> None:
        """Charge or refund one of rec's entries as its blocked state has
        it: a blocked worker gave back all but its cards (worker_blocked),
        which stay with the process pinned to them."""
        if rec.blocked_depth:
            need = {"GPU": need["GPU"]} if need.get("GPU") else {}
        (self._charge if charge else self._refund)(pg_key, need, cards)

    def _release_worker_res_locked(self, rec: WorkerRec) -> None:
        """Give back everything the worker holds (its death)."""
        if rec.acquired:
            self._settle_locked(rec, rec.pg_key, rec.acquired,
                                rec.actor_cards, charge=False)
        for tid, (need, pg_key, charged) in rec.task_res.items():
            if charged:
                self._settle_locked(rec, pg_key, need,
                                    rec.task_cards.get(tid), charge=False)

    def _blocked_part_locked(self, rec: WorkerRec, charge: bool) -> None:
        """Give back (or take again) what a worker blocked in `get`
        frees: all it holds but its cards."""
        move = acquire if charge else release
        entries = [(rec.pg_key, rec.acquired)] if rec.acquired else []
        entries += [(pg_key, need) for need, pg_key, charged
                    in rec.task_res.values() if charged]
        for pg_key, need in entries:
            move(self._ledger_for_key(pg_key),
                 {k: v for k, v in need.items() if k != "GPU"})

    def heartbeat_snapshot(self) -> dict:
        """Consistent copies of the ledgers a node heartbeat reports —
        taken under the scheduler lock so a concurrent dispatch can't
        mutate the dicts mid-serialization."""
        with self._lock:
            snap = {
                "avail": dict(self.avail),
                "total": dict(self.total),
                "pending_demand": dict(self._pending_demand),
                "pending_shapes": self.pending_shapes(),
                "is_idle": self.is_idle(),
            }
            pids = [r.proc.pid for r in self._workers.values()
                    if r.proc is not None]
        snap["host_stats"] = sample_host_stats(pids)
        snap["workers"] = self.workers_snapshot()
        return snap

    def host_stats(self) -> dict:
        """Reporter sample alone (for the head's own list_nodes view) —
        avoids copying the full resource ledgers heartbeat_snapshot
        builds."""
        with self._lock:
            pids = [r.proc.pid for r in self._workers.values()
                    if r.proc is not None]
        return sample_host_stats(pids)

    def workers_snapshot(self) -> list[dict]:
        """Worker-manager table rows (reference GcsWorkerManager /
        worker_pool.cc state): one dict per pooled worker."""
        now = time.time()
        with self._lock:
            return [{
                "worker_id": r.worker_id,
                "pid": r.proc.pid if r.proc is not None else None,
                "state": r.state,
                "actor_id": r.actor_id,
                "inflight_tasks": len(r.tasks),
                "blocked_depth": r.blocked_depth,
                "env_hash": r.env_hash,
                "age_s": round(now - r.started_at, 1),
                # which wire engine the worker registered with (r7):
                # a mixed-mode fleet is a perf-debugging smell
                "wire_native": (r.conn.meta.get("wire_native")
                                if r.conn is not None else None),
                # r18 worker-direct serving socket (None: no listener)
                "direct_port": (r.conn.meta.get("direct_port")
                                if r.conn is not None else None),
            } for r in self._workers.values()]

    def direct_port_of(self, worker_id: str):
        """The worker's r18 direct-serving port (None when it has no
        listener or is gone) — resolve-time input for the direct
        actor call plane."""
        with self._lock:
            rec = self._workers.get(worker_id)
            if rec is None or rec.state == DEAD or rec.conn is None:
                return None
            return rec.conn.meta.get("direct_port")

    def worker_running_task(self, task_id: str):
        """(worker_id, spec) currently executing (or queued in) the
        worker that holds task_id, or None."""
        with self._lock:
            for rec in self._workers.values():
                if rec.state == BUSY and task_id in rec.tasks:
                    return rec.worker_id, rec.tasks[task_id]
        return None

    def cancel_running(self, worker_id: str, task_id: str) -> bool:
        with self._lock:
            rec = self._workers.get(worker_id)
        if rec is None or rec.conn is None:
            return False
        try:
            rec.conn.send({"type": protocol.CANCEL_TASK,
                           "task_id": task_id})
            return True
        except protocol.ConnectionClosed:
            return False

    def kill_worker(self, worker_id: str) -> None:
        with self._lock:
            rec = self._workers.get(worker_id)
        if rec is None:
            return
        if rec.conn is not None:
            try:
                rec.conn.send({"type": protocol.SHUTDOWN})
            except Exception:
                pass
        if rec.proc is not None:
            try:
                rec.proc.terminate()
            except Exception:
                pass

    # ---- blocked-worker accounting ----
    def worker_blocked(self, worker_id: str) -> None:
        steal: list[str] = []
        with self._cv:
            rec = self._workers.get(worker_id)
            if rec is None:
                return
            rec.blocked_depth += 1
            if rec.blocked_depth == 1 and (rec.acquired or rec.task_res):
                self._blocked_part_locked(rec, charge=False)
                # freed resources: start queued work immediately
                if self._running and self._pending:
                    self._try_dispatch_locked(self._INLINE_SCAN_LIMIT)
            # Steal back tasks pipelined BEHIND the now-blocked task:
            # the worker executes FIFO on one thread, so they cannot
            # start until the blocked get returns — and if that get
            # transitively depends on one of them (nested submission),
            # that is a deadlock, not just a stall.
            if len(rec.tasks) > 1 and rec.conn is not None:
                steal = list(rec.tasks.keys())[1:]
            self._cv.notify_all()
        for tid in steal:
            self._steal_queued_task(rec, tid)

    def _pop_worker_task_locked(self, rec: WorkerRec,
                                task_id: str) -> Optional[TaskSpec]:
        """UNQUEUE accounting shared by the steal-back and lease-
        reclaim paths: remove a worker-confirmed-unstarted task from
        rec's FIFO mirror and settle its resource charge. Caller holds
        the lock and has an ``ok`` UNQUEUE reply in hand; returns the
        spec, or None when the record went stale (worker replaced /
        task already gone)."""
        cur = self._workers.get(rec.worker_id)
        if cur is not rec:
            return None
        spec = rec.tasks.pop(task_id, None)
        need_pg = rec.task_res.pop(task_id, None)
        cards = rec.task_cards.pop(task_id, None)
        if spec is None:
            return None
        if need_pg is not None and need_pg[2]:
            # what this entry still holds (all of it once the worker
            # unblocked between steal and reply; uncharged pipelined
            # tasks never held a share)
            self._settle_locked(rec, need_pg[1], need_pg[0], cards,
                                charge=False)
            # a charged entry left the chain: hand its share to the
            # next queued task, or the rest of the pipeline would run
            # permanently uncharged
            self._promote_next_charge_locked(rec)
        if rec.state == BUSY and not rec.tasks:
            rec.state = IDLE
        return spec

    def _steal_queued_task(self, rec: WorkerRec, task_id: str) -> None:
        """Ask the worker to drop a not-yet-started pipelined task from
        its local FIFO and requeue it here. Runs async: this path is
        reached on the worker connection's reader thread, so a blocking
        request would deadlock against our own reply."""
        try:
            fut = rec.conn.request_async(
                {"type": protocol.UNQUEUE_TASK, "task_id": task_id})
        except protocol.ConnectionClosed:
            return

        def _done(f) -> None:
            try:
                rep = f.result(0)
            except BaseException:
                return                # worker died: death path requeues
            if not rep.get("ok"):
                return                # already started: FIFO handles it
            with self._cv:
                spec = self._pop_worker_task_locked(rec, task_id)
                if spec is None:
                    return
                self._pending.appendleft(spec)
                self._queued_at[id(spec)] = time.monotonic()
                self._demand_add(spec)
                if self._running:
                    self._try_dispatch_locked(self._INLINE_SCAN_LIMIT)
                self._cv.notify_all()

        fut.add_done_callback(_done)

    def find_task(self, task_id: str):
        """Where a task currently lives on this node: ("pending", None)
        while queued here, ("running", worker_id) while in a worker's
        FIFO (dispatched; possibly not yet started), else None. The
        head's cancel path uses this in delegated mode, where per-task
        dispatch events are suppressed."""
        with self._lock:
            for spec in self._pending:
                if getattr(spec, "task_id", None) == task_id:
                    return ("pending", None)
            for rec in self._workers.values():
                if rec.state != DEAD and task_id in rec.tasks:
                    return ("running", rec.worker_id)
        return None

    def reclaim_tasks(self, task_ids: list,
                      callback: Callable[[list], None]) -> None:
        """Lease revoke (r10): pull queued-NOT-started tasks back out
        of this node and hand their specs to `callback` in one shot.
        Pending-queue entries come out synchronously; tasks already
        pipelined into a worker's FIFO go through the r6 UNQUEUE_TASK
        tombstone machinery (async — the worker refuses if the task
        started, in which case it stays leased here and runs to
        completion). `callback(reclaimed_specs)` fires exactly once,
        after every worker probe resolves."""
        reclaimed: list = []
        probes: list = []               # (rec, task_id, future)
        want = set(task_ids)
        with self._cv:
            # ONE pass over the queue and worker FIFOs builds the id
            # indexes — per-id rescans of a 10k-deep backlog (exactly
            # the state that triggers a rebalance revoke) would stall
            # dispatch under this lock for the whole sweep
            pending_hits = {}
            for spec in self._pending:
                tid = getattr(spec, "task_id", None)
                if tid in want:
                    pending_hits[tid] = spec
            if pending_hits:
                # one rebuild, not a deque.remove per id (each remove
                # rescans from the front — the same O(ids x backlog)
                # this index exists to avoid)
                drop = set(map(id, pending_hits.values()))
                self._pending = deque(
                    s for s in self._pending if id(s) not in drop)
                for spec in pending_hits.values():
                    self._queued_at.pop(id(spec), None)
                    self._demand_sub(spec)
                    reclaimed.append(spec)
            worker_hits = {}
            for rec in self._workers.values():
                if rec.state == DEAD or rec.conn is None:
                    continue
                # FIFO head = (likely) already executing; only the
                # queued tail is reclaimable
                it = iter(rec.tasks)
                next(it, None)
                for tid in it:
                    if tid in want:
                        worker_hits[tid] = rec
            for tid in task_ids:
                if tid in pending_hits:
                    continue
                rec = worker_hits.get(tid)
                if rec is not None:
                    try:
                        fut = rec.conn.request_async(
                            {"type": protocol.UNQUEUE_TASK,
                             "task_id": tid})
                        probes.append((rec, tid, fut))
                    except protocol.ConnectionClosed:
                        pass
        if not probes:
            callback(reclaimed)
            return
        state = {"left": len(probes)}
        state_lock = threading.Lock()

        def _probe_done(rec, tid, fut) -> None:
            try:
                ok = bool(fut.result(0).get("ok"))
            except BaseException:
                ok = False              # worker died: death path covers
            if ok:
                with self._cv:
                    spec = self._pop_worker_task_locked(rec, tid)
                    if spec is not None:
                        reclaimed.append(spec)
                    self._cv.notify_all()
            with state_lock:
                state["left"] -= 1
                last = state["left"] == 0
            if last:
                callback(reclaimed)

        for rec, tid, fut in probes:
            fut.add_done_callback(
                lambda f, rec=rec, tid=tid: _probe_done(rec, tid, f))

    def worker_unblocked(self, worker_id: str) -> None:
        with self._cv:
            rec = self._workers.get(worker_id)
            if rec is None:
                return
            rec.blocked_depth = max(0, rec.blocked_depth - 1)
            if (rec.blocked_depth == 0 and rec.state != DEAD
                    and (rec.acquired or rec.task_res)):
                # Re-acquire (may oversubscribe transiently, as the reference
                # raylet does when a blocked worker resumes).
                self._blocked_part_locked(rec, charge=True)

    # ---- completion ----
    def task_finished(self, worker_id: str,
                      task_id: Optional[str] = None,
                      cuda_bound: Optional[str] = None
                      ) -> Optional[TaskSpec]:
        """A task's completion; `cuda_bound` is the worker's report that
        its process has initialised CUDA on those cards."""
        with self._cv:
            rec = self._workers.get(worker_id)
            if rec is None:
                return None
            if cuda_bound is not None:
                rec.bound_cards = cuda_bound
            if task_id is None and rec.tasks:   # legacy callers: FIFO
                task_id = next(iter(rec.tasks))
            task = rec.tasks.pop(task_id, None) if task_id else None
            need_pg = rec.task_res.pop(task_id, None) if task_id else None
            cards = rec.task_cards.pop(task_id, None) if task_id else None
            if need_pg is not None and need_pg[2]:
                self._settle_locked(rec, need_pg[1], need_pg[0], cards,
                                    charge=False)
                self._promote_next_charge_locked(rec)
            if rec.state == BUSY and not rec.tasks:
                rec.state = IDLE
            # Dispatch the next queued specs NOW, on the completion
            # reader thread, instead of bouncing through the loop
            # thread — but with refill hysteresis: only sweep once this
            # worker has >= 2 free pipeline slots (or went idle), so
            # replacements leave as multi-spec burst frames and the
            # worker's back-to-back completions coalesce, instead of
            # the per-completion lock-step that emits single TASK and
            # TASK_DONE frames. Halves the sweeps per task too. The
            # 20 Hz loop tick remains the convergence backstop.
            # floor of 1: at depth <= 2 every completion refills (the
            # pre-hysteresis behavior), else the last slot would only
            # refill via the 20 Hz backstop — a round-trip bubble
            depth = _CFG.worker_pipeline_depth
            if (self._running and self._pending
                    and (rec.state != BUSY
                         or len(rec.tasks) <= max(depth - 2, 1))):
                self._try_dispatch_locked(self._INLINE_SCAN_LIMIT)
            self._cv.notify_all()
            return task

    def actor_ready(self, worker_id: str) -> None:
        with self._cv:
            if self._running and self._pending:
                self._try_dispatch_locked(self._INLINE_SCAN_LIMIT)
            self._cv.notify_all()

    # ---- dispatch loop ----
    @staticmethod
    def _spec_env_hash(spec) -> str:
        """Cached on the spec: the dispatch loop rescans queued specs
        every pass and must not re-serialize envs each time."""
        h = getattr(spec, "_env_hash_cache", None)
        if h is None:
            from ray_tpu_torch._private.runtime_env import env_hash
            h = env_hash(getattr(spec, "runtime_env", None)) or ""
            try:
                spec._env_hash_cache = h
            except AttributeError:
                pass
        return h

    @staticmethod
    def _spec_need_key(spec) -> tuple:
        """Cached hashable shape of a spec's resource need (r16 sweep
        miss-memo key component). Resources never change after
        submission, so the tuple is computed once per spec — a full
        sweep over a 100k backlog must not rebuild it per pass."""
        k = getattr(spec, "_need_key_cache", None)
        if k is None:
            k = tuple(sorted(Scheduler.need_of(spec).items()))
            try:
                spec._need_key_cache = k
            except AttributeError:
                pass
        return k

    def _pick_worker(self, spec=None,
                     lease: Optional[str] = None) -> Optional[WorkerRec]:
        """Idle worker, preferring one whose last applied runtime env
        matches the spec's (runtime-env-keyed reuse). Pipelining onto a
        BUSY worker is the dispatch sweep's job (_pick_piggyback): it
        rides the worker's lease uncharged, so a worker never holds
        more than one resource charge — keeping spare capacity visible
        to idle/new workers instead of concentrating charges on a few
        pipelines. A GPU lease (`lease`: its cards) skips workers bound
        to other cards."""
        want = "" if spec is None else self._spec_env_hash(spec)
        # container tasks can only run in a worker SPAWNED inside the
        # image (exact env-hash match); plain workers can't adopt one
        exact_only = spec is not None and has_container(
            getattr(spec, "runtime_env", None))
        fallback = None
        for rec in self._workers.values():
            if rec.conn is None:
                continue
            if rec.container and rec.env_hash != want:
                continue    # image-bound: invisible to other tasks
            if (lease is not None and rec.bound_cards is not None
                    and rec.bound_cards != lease):
                continue    # its process sees other cards for good
            if rec.state == IDLE:
                if rec.env_hash == want:
                    return rec
                if fallback is None and not exact_only:
                    fallback = rec
        return fallback

    def _gpu_lease_locked(self, spec, amount: float, pg_key):
        """(cards, idle worker or None) for a lease of `amount` GPUs out
        of `pg_key`'s pool, or (None, None) when no cards hold it. An
        idle worker bound to cards the pool can give again comes first:
        it keeps its CUDA context."""
        pool = self._cards_for_key(pg_key)
        index = {n: i for i, n in enumerate(self._card_names)}
        want = self._spec_env_hash(spec)
        for rec in self._workers.values():
            if (rec.conn is None or rec.state != IDLE
                    or rec.bound_cards is None
                    or (rec.container and rec.env_hash != want)):
                continue
            ids = [index.get(n) for n in rec.bound_cards.split(",")]
            if None in ids:
                continue
            cards = pool.choose(amount, only=ids)
            if cards is not None:
                return cards, rec
        cards = pool.choose(amount)
        if cards is None:
            return None, None
        return cards, self._pick_worker(spec, self._lease_str(cards))

    def _evict_bound_idle_locked(self, lease: str) -> bool:
        """Stop one idle worker bound to cards other than `lease`'s, so
        a full pool can spawn a worker the lease can run on."""
        for rec in self._workers.values():
            if (rec.state == IDLE and rec.bound_cards is not None
                    and rec.bound_cards != lease):
                rec.state = DEAD
                self.kill_worker(rec.worker_id)
                return True
        return False

    def _refillable_locked(self) -> set:
        """Workers a dispatch sweep may pipeline onto: non-BUSY, or
        BUSY with >= 2 free pipeline slots. Snapshotted at sweep start
        and kept for the whole sweep, so an eligible worker is topped
        up to FULL depth in one multi-spec burst while a worker one
        task short of full is left alone — per-completion single-frame
        refills (which defeat wire coalescing) cannot happen."""
        depth = _CFG.worker_pipeline_depth
        floor = max(depth - 2, 1)
        return {wid for wid, rec in self._workers.items()
                if rec.state != BUSY or len(rec.tasks) <= floor}

    def _pick_piggyback(self, spec, need: dict[str, float],
                        pg_key, eligible: set):
        """Saturation-path pipelining (reference worker-lease model):
        when the free pool cannot cover `need`, a normal task may still
        queue FIFO on a BUSY same-env worker, riding that worker's
        existing resource grant — uncharged until the task ahead of it
        completes and hands its share over (task_finished). Sound
        because of the dispatch-time chain condition: the task's need
        fits inside its immediate predecessor's on the same ledger, so
        the predecessor's release always covers the successor's
        acquire. Returns (worker, cards) or (None, None): a GPU task
        rides only a worker whose last lease holds the same cards, and
        takes its share of them."""
        if isinstance(spec, ActorSpec):
            return None, None
        if getattr(spec, "placement_group_id", None):
            # PG tasks keep queue-or-fail semantics: pipelining one
            # behind a bundle's occupant would dodge the pending-queue
            # sweep that fails it fast on remove_placement_group, and
            # its lease hand-off would straddle a bundle ledger that
            # can be torn down mid-chain.
            return None, None
        depth = _CFG.worker_pipeline_depth
        if depth <= 1:
            return None, None
        want = self._spec_env_hash(spec)
        gpu = need.get("GPU", 0.0)
        for rec in self._workers.values():
            if (rec.conn is None or rec.state != BUSY
                    or rec.worker_id not in eligible
                    or rec.blocked_depth > 0 or rec.env_hash != want
                    or len(rec.tasks) >= depth or not rec.task_res):
                continue
            last_tid = next(reversed(rec.task_res))
            last_need, last_pg, _ = rec.task_res[last_tid]
            if last_pg != pg_key:
                continue            # predecessor charges another ledger
            if not all(last_need.get(k, 0.0) >= v for k, v in need.items()):
                continue
            if not gpu:
                return rec, None
            last = rec.task_cards.get(last_tid)
            cards = sub_cards(last, gpu)
            if cards is not None and [i for i, _ in cards] == [
                    i for i, _ in last]:
                return rec, cards
        return None, None

    def _alive_count(self) -> int:
        return sum(1 for r in self._workers.values() if r.state != DEAD)

    @staticmethod
    def need_of(spec) -> dict[str, float]:
        res = dict(spec.resources) if spec.resources else {}
        if "CPU" not in res and not res.get("_pg_reserved"):
            res.setdefault("CPU", 1.0)
        res.pop("_pg_reserved", None)
        return res

    def _effective_need(self, spec) -> dict[str, float]:
        return self.need_of(spec)

    def effective_avail(self) -> dict[str, float]:
        """Availability minus demand already queued here but not yet
        dispatched (workers take seconds to spawn, so `avail` alone
        wildly overstates capacity during placement bursts)."""
        with self._lock:
            eff = dict(self.avail)
            for k, v in self._pending_demand.items():
                eff[k] = eff.get(k, 0.0) - v
            return eff

    def pending_shapes(self) -> list[dict[str, float]]:
        """Resource shapes of queued specs beyond current availability
        (autoscaler demand units): simulate dispatch against a copy of
        avail; what doesn't fit is unmet demand."""
        with self._lock:
            eff = dict(self.avail)
            unmet = []
            for spec in self._pending:
                need = self._effective_need(spec)
                if fits(eff, need):
                    acquire(eff, need)
                else:
                    unmet.append(need)
            return unmet

    def set_draining(self, flag: bool = True) -> None:
        """Flip drain state (drain-before-kill, r14). Routing decisions
        live cluster-side; this flag is what they consult. Dispatch of
        already-queued work continues — the cluster reclaims what it
        wants moved via ``reclaim_tasks`` and leaves the rest to finish
        here before the node is released."""
        self.draining = bool(flag)

    def queued_task_ids(self, limit: int = 1 << 20) -> list:
        """Task ids of queued-NOT-(necessarily-)started work on this
        node: the pending queue plus each worker FIFO's tail (the head
        entry is likely already executing). The drain path feeds these
        to ``reclaim_tasks`` — the local-scheduler analogue of the
        delegated ``steal_candidates`` (r10). Movable work only: actor
        calls are bound to their actor's worker, and affinity/PG-
        pinned specs would just be re-routed straight back here."""
        def _movable(spec) -> bool:
            return (isinstance(spec, TaskSpec)
                    and not getattr(spec, "node_id", None)
                    and not getattr(spec, "placement_group_id", None))

        ids: list = []
        with self._lock:
            for spec in self._pending:
                tid = getattr(spec, "task_id", None)
                if tid is not None and _movable(spec):
                    ids.append(tid)
            for rec in self._workers.values():
                if rec.state == DEAD:
                    continue
                it = iter(rec.tasks.items())
                next(it, None)
                ids.extend(tid for tid, spec in it if _movable(spec))
        return ids[:limit]

    def known_task_ids(self) -> list:
        """EVERY plain-task id this node currently holds: the pending
        queue plus every worker-FIFO entry, including the (likely
        executing) head of each FIFO. The agent's head-restart rejoin
        report is built from this (r15): a rehydrated head re-places
        only mirrored tasks the agent does NOT know — resubmitting a
        task that is queued, running, or finishing here would break
        exactly-once."""
        ids: list = []
        with self._lock:
            for spec in self._pending:
                tid = getattr(spec, "task_id", None)
                if tid is not None:
                    ids.append(tid)
            for rec in self._workers.values():
                if rec.state == DEAD:
                    continue
                ids.extend(rec.tasks.keys())
        return ids

    def is_idle(self) -> bool:
        """Nothing queued, nothing running, no PG bundles, full
        availability — evaluated atomically (autoscaler scale-down)."""
        with self._lock:
            if self._pending or self._bundles or self._spawning:
                return False
            if any(r.state in (BUSY, ACTOR) for r in
                   self._workers.values()):
                return False
            return all(abs(self.avail.get(k, 0.0) - v) < 1e-6
                       for k, v in self.total.items())

    @staticmethod
    def utilization_from(eff: dict[str, float],
                         total: dict[str, float]) -> float:
        """utilization() over a caller-held effective_avail snapshot —
        the hybrid selection loop takes ONE snapshot per node and
        derives both its fits() check and this from it, instead of
        re-taking the hot scheduler lock for every phase."""
        u = 0.0
        for k, tot in total.items():
            if tot > 0:
                u = max(u, 1.0 - eff.get(k, 0.0) / tot)
        return u

    def utilization(self) -> float:
        """Max per-resource utilization fraction incl. queued demand
        (hybrid-policy input; may exceed 1.0 under backlog)."""
        return self.utilization_from(self.effective_avail(), self.total)

    def live_actors(self) -> dict[str, str]:
        """actor_id -> worker_id for actors with a live worker here —
        reported to the head when this agent rejoins after a head
        restart, so rehydrated actor records re-attach to their
        still-running workers instead of restarting them."""
        with self._lock:
            return {r.actor_id: r.worker_id
                    for r in self._workers.values()
                    if r.actor_id is not None and r.state != DEAD}

    def owns_worker(self, worker_id: str) -> bool:
        with self._lock:
            return worker_id in self._workers

    def _ledger(self, rec: WorkerRec) -> dict[str, float]:
        """The availability pool `rec.acquired` was charged against. A
        bundle released while its workers still run falls back to the
        node pool (the bundle's ledger is gone)."""
        return self._ledger_for_key(rec.pg_key)

    def _loop(self) -> None:
        """Periodic dispatch backstop. Inline dispatch (enqueue/
        completion/unblock paths) handles the hot path, so this thread
        deliberately does NOT wake on queue notifies — per-event wakeups
        made it re-sweep the whole backlog on every task (O(n^2) drain,
        ~600us of head CPU per task). It ticks on a fixed cadence with a
        bounded sweep, and runs the unbounded convergence sweep (deep
        queues, odd resource shapes) every ~2s."""
        last_full = 0.0
        while True:
            with self._cv:
                if not self._running:
                    return
                if self._cluster is not None:
                    self._cluster.heartbeat(self.node_id)
                self._reap_failed_spawns_locked()
                self._spill_aged_locked()
                now = time.monotonic()
                if now - last_full >= 2.0:
                    self._try_dispatch_locked()
                    last_full = now
                else:
                    self._try_dispatch_locked(512)
            try:
                self._memory_monitor_step()
            except Exception:
                pass          # the dispatch backstop must never die
            time.sleep(0.05)

    # ------------------------------------------------ memory pressure
    def _memory_monitor_step(self) -> None:
        """Kill a task worker when node memory usage crosses the
        threshold (reference raylet memory monitor). Victim selection is
        the reference's retriable-FIFO policy
        (worker_killing_policy.cc): retriable task workers first,
        newest-started first — the cheapest work to redo — and never
        actors (their loss cascades)."""
        threshold = _CFG.memory_monitor_threshold
        if threshold <= 0 or not self._running:
            return
        now = time.monotonic()
        if now - self._last_mem_check < _CFG.memory_monitor_refresh_s:
            return
        self._last_mem_check = now
        try:
            frac = self.memory_fraction_fn()
        except Exception:
            return
        if frac < threshold:
            return
        # cooldown: a kill takes seconds to actually release memory —
        # without it, sustained (possibly external) pressure would
        # massacre every worker within a few ticks
        cooldown = max(5.0, 3 * _CFG.memory_monitor_refresh_s)
        if now - self._last_mem_kill < cooldown:
            return
        with self._lock:
            candidates = [r for r in self._workers.values()
                          if r.state == BUSY and r.conn is not None
                          and r.tasks]
            if not candidates:
                return

            def retriable(rec: WorkerRec) -> bool:
                return all(t.retries_used < t.max_retries
                           for t in rec.tasks.values())

            pool = [r for r in candidates if retriable(r)] or candidates
            victim = max(pool, key=lambda r: r.started_at)
            names = [t.name or t.task_id
                     for t in victim.tasks.values()]
            victim_id = victim.worker_id
        self._last_mem_kill = now
        sys.stderr.write(
            f"ray_tpu_torch: node {self.node_id} memory usage "
            f"{frac:.0%} >= {threshold:.0%}; killing worker "
            f"{victim_id} (tasks: {names}) to relieve "
            f"pressure — retriable tasks will be retried\n")
        self.kill_worker(victim_id)

    def _spill_aged_locked(self) -> None:
        """Spillback (stage-1 redirect): hand unconstrained tasks that
        aged past the spill_delay_s knob without resources back to the cluster
        for re-placement on a node with room."""
        if self._cluster is None:
            return
        now = time.monotonic()
        # Throttle: the scan is O(queue) with dict churn per spec; at
        # most ~4 scans/s, and none when there is nowhere to spill to.
        # NOTE: the node lock is held here — only the cluster's
        # LOCK-FREE node count may be read (cluster-lock calls from
        # under a node lock are the ABBA deadlock _fail_if_pg_removed
        # documents).
        if now - self._last_spill_scan < 0.25:
            return
        if self._cluster.alive_node_count() <= 1:
            return
        self._last_spill_scan = now
        for spec in list(self._pending):
            # The lock is dropped around try_spill below, so a concurrent
            # cancel_pending may have removed a later snapshot entry.
            if id(spec) not in self._queued_at:
                continue
            need = self._effective_need(spec)
            if fits(self.avail, need) and (
                    not need.get("GPU")
                    or self._cards.choose(need["GPU"]) is not None):
                continue              # room here (whole cards included)
            t0 = self._queued_at.get(id(spec))
            if t0 is None or now - t0 < _CFG.spill_delay_s:
                continue
            spilled = getattr(spec, "_spill_count", 0)
            if spilled >= 3:
                continue
            # Release the lock around the cluster call (it takes the
            # cluster lock; cluster->node calls take node locks).
            self._pending.remove(spec)
            self._queued_at.pop(id(spec), None)
            self._demand_sub(spec)
            self._cv.release()
            try:
                try:
                    spec._spill_count = spilled + 1
                except AttributeError:
                    pass
                moved = self._cluster.try_spill(spec, self.node_id)
            finally:
                self._cv.acquire()
            if not moved:
                self._pending.appendleft(spec)
                self._queued_at[id(spec)] = t0
                self._demand_add(spec)

    def _reap_failed_spawns_locked(self) -> None:
        """A worker that exits (or hangs) before registering would otherwise
        hold a _spawning slot forever and stall dispatch permanently."""
        now = time.time()
        for rec in self._workers.values():
            if rec.state != STARTING:
                continue
            exited = rec.proc is not None and rec.proc.poll() is not None
            timed_out = now - rec.started_at > _CFG.worker_spawn_timeout_s
            if exited or timed_out:
                rec.state = DEAD
                self._spawning = max(0, self._spawning - 1)
                sys.stderr.write(
                    f"ray_tpu_torch: worker {rec.worker_id} failed to start "
                    f"({'exited' if exited else 'timed out'})\n")
                if timed_out and rec.proc is not None:
                    try:
                        rec.proc.kill()
                    except Exception:
                        pass

    # Inline (event-triggered) dispatches scan at most this many queued
    # specs: one enqueue/completion can enable at most ~one dispatch at
    # the queue head, and an unbounded scan over a long queue of
    # non-fitting specs made hot-path submission O(n^2). The loop
    # thread's periodic full sweep remains the convergence backstop.
    _INLINE_SCAN_LIMIT = 64

    @staticmethod
    def _send_dispatch_outbox(outbox: list,
                              eager: bool = False) -> None:
        """Ship the sweep's accumulated (conn, msg) dispatches through
        each worker connection's coalescing queue: the flusher thread
        pays the encode+sendall (keeping it off the submitting/
        completion-handling thread — it was ~35% of per-submit head CPU)
        and adjacent dispatches to one worker ride ONE BatchFrame. Must
        run BEFORE the scheduler lock is dropped: the steal-back path
        (worker_blocked) takes the lock and sends UNQUEUE_TASK eagerly,
        which flushes the queue first — a TASK parked here can never be
        overtaken, but it must already BE in the queue by then.

        ``eager`` (r18 sync-latency triage): a LONE dispatch with an
        empty queue behind it is a sync round-trip, not a burst — the
        coalescing window would charge it ~wire_batch_delay_ms of pure
        latency for nothing (the submitting thread is about to block
        in get() anyway), the same reasoning as the worker's lone-
        completion eager TASK_DONE. Bursts keep the lazy path: under a
        drain the queue is non-empty and the flusher amortizes."""
        if not outbox:
            return
        for conn, msg in outbox:
            try:
                if eager:
                    conn.send(msg)
                else:
                    conn.send_lazy(msg)
            except protocol.ConnectionClosed:
                pass      # worker-death recovery requeues its tasks
        outbox.clear()

    def _try_dispatch_locked(self, scan_limit: Optional[int] = None
                             ) -> bool:
        """One sweep over the queue, dispatching EVERY spec a free
        worker + resources allow (a per-dispatch rescan made draining n
        queued tasks O(n^2); reference LocalTaskManager::
        DispatchScheduledTasksToWorkers drains its queue per wake the
        same way). `scan_limit` bounds the sweep for inline callers.
        Dispatch frames accumulate in an outbox and ship per-connection
        at the end of the sweep (or before any mid-sweep lock drop)."""
        dispatched = 0
        outbox: list = []
        refillable = self._refillable_locked()
        if scan_limit is None:
            snapshot = list(self._pending)
        else:
            import itertools as _it
            snapshot = list(_it.islice(self._pending, scan_limit))
        # r16 saturated-sweep miss memo: once a plain (no-PG, no-actor)
        # spec of a given (env, need-shape) found neither pool room nor
        # a piggyback slot, every later same-shape spec in THIS sweep
        # skips on one set lookup. Sound within a sweep, including for
        # incomparable multi-resource shapes: (a) fits() cannot start
        # succeeding — the pool only shrinks under the held lock
        # (dispatches acquire, nothing releases; completions need this
        # lock). (b) A piggyback slot for missed shape S cannot open —
        # it requires a worker whose LAST queued need D >= S
        # componentwise (the chain condition), and any mid-sweep
        # dispatch of such a D either passed fits(D) on a pool smaller
        # than the one fits(S) already failed on (D >= S makes that a
        # contradiction) or itself piggybacked behind some P >= D >= S
        # on a worker whose eligibility cannot have improved since S's
        # probe (the eligible set is fixed, FIFO depth only grows
        # mid-sweep, blocked_depth needs this lock). Without the memo,
        # the 2 s full-sweep backstop over a saturated 100k backlog
        # paid O(n) worker probes per pass — head cost proportional to
        # the in-flight population, the very thing r16 removes.
        misses: set = set()
        for spec in snapshot:
            if id(spec) not in self._queued_at:
                continue              # removed while the lock was dropped
            pg_key = self._bundle_for(spec)
            if getattr(spec, "placement_group_id", None) and pg_key is None:
                self._send_dispatch_outbox(outbox)   # next call drops lock
                self._fail_if_pg_removed(spec)
                continue                  # bundle not (yet) on this node
            mkey = None
            if pg_key is None:
                # one cached tuple per spec: the memo probe must cost
                # a getattr + set hit, not an env-hash + need rebuild,
                # or scanning a deep backlog stays expensive
                mkey = getattr(spec, "_sweep_key_cache", None)
                if mkey is None and not isinstance(spec, ActorSpec):
                    mkey = (self._spec_env_hash(spec),
                            self._spec_need_key(spec))
                    try:
                        spec._sweep_key_cache = mkey
                    except AttributeError:
                        pass
                if mkey is not None and mkey in misses:
                    continue          # proven unplaceable this sweep
            need = self._effective_need(spec)
            pool = (self._bundles[pg_key]["avail"] if pg_key is not None
                    else self.avail)
            charged = True
            cards = None
            worker = None
            room = fits(pool, need)
            if room and need.get("GPU"):
                cards, worker = self._gpu_lease_locked(
                    spec, need["GPU"], pg_key)
                room = cards is not None
            if not room:
                # Saturated: the spec may still pipeline onto a BUSY
                # worker's existing grant (uncharged until the task
                # ahead of it completes) — reference worker-lease
                # pipelining. This is what keeps per-worker bursts >1
                # task deep, which the wire coalescing turns into
                # multi-spec TASK frames and paired TASK_DONEs.
                worker, cards = self._pick_piggyback(spec, need, pg_key,
                                                     refillable)
                if worker is None:
                    if mkey is not None:
                        misses.add(mkey)
                    continue
                charged = False
            else:
                if cards is None:
                    worker = self._pick_worker(spec)
                if worker is None:
                    # no idle worker: pipeline onto a busy one rather
                    # than stalling the sweep on a spawn round-trip;
                    # spawning still happens below when even piggyback
                    # has no room, growing the pool toward max_workers
                    ride, ride_cards = self._pick_piggyback(
                        spec, need, pg_key, refillable)
                    if ride is not None:
                        worker, cards, charged = ride, ride_cards, False
            if worker is None:
                blocked = sum(1 for r in self._workers.values()
                              if r.blocked_depth > 0
                              and r.state not in (DEAD, ACTOR))
                # The max_workers soft cap governs the REUSABLE task-worker
                # pool only. Workers pinned by live actors are dedicated
                # processes outside the cap (reference worker_pool.cc keeps
                # its soft limit for returnable workers; actor workers are
                # started on demand) — otherwise long-lived actors starve
                # task/actor dispatch permanently.
                pool_count = sum(1 for r in self._workers.values()
                                 if r.state not in (DEAD, ACTOR))
                if (cards is not None
                        and pool_count - blocked >= self._max_workers
                        and self._evict_bound_idle_locked(
                            self._lease_str(cards))):
                    pool_count -= 1
                # Spawn only for unmet demand: never more in-flight spawns
                # than pending work items (raylet WorkerPool prestart logic,
                # worker_pool.cc PrestartWorkers, is demand-capped the same
                # way).
                if (pool_count - blocked < self._max_workers
                        and self._spawning < min(len(self._pending), 4)):
                    spawn_err: Optional[BaseException] = None
                    self._send_dispatch_outbox(outbox)
                    self._cv.release()
                    try:
                        # container envs bind the worker at spawn time
                        self.spawn_worker(
                            getattr(spec, "runtime_env", None))
                    except Exception as e:
                        # e.g. container engine/image missing: fail THE
                        # TASK (like a worker-side env error) instead of
                        # letting the exception escape into whatever
                        # thread ran this sweep and retrying forever
                        spawn_err = e
                    finally:
                        self._cv.acquire()
                    if spawn_err is not None:
                        if (has_container(getattr(spec, "runtime_env",
                                                  None))
                                and id(spec) in self._queued_at):
                            # env-driven spawn error (engine/image
                            # missing): deterministic — fail the task
                            self._pending.remove(spec)
                            self._queued_at.pop(id(spec), None)
                            self._demand_sub(spec)
                            self._cv.release()
                            try:
                                self._rt.on_unplaceable(
                                    spec, f"worker spawn failed: "
                                          f"{spawn_err}")
                            finally:
                                self._cv.acquire()
                        else:
                            # transient fork/exec failure: leave the
                            # spec queued; the 20 Hz backstop retries
                            sys.stderr.write(
                                f"ray_tpu_torch: worker spawn failed "
                                f"({spawn_err}); will retry\n")
                break                 # no free worker: stop the sweep
            self._pending.remove(spec)
            t_enq = self._queued_at.pop(id(spec), None)
            if t_enq is not None:
                # metrics plane (r11): queue-wait phase from the stamp
                # the queue already keeps — enqueue pays nothing, and
                # the gate short-circuits with RAY_TPU_METRICS=0
                _mp.observe_queue_wait(time.monotonic() - t_enq,
                                       self.node_id)
            self._demand_sub(spec)
            if charged:
                acquire(pool, need)
                self._cards_for_key(pg_key).charge(cards)
            if not worker.container:     # image-bound hash is immutable
                worker.env_hash = self._spec_env_hash(spec)
            if isinstance(spec, ActorSpec):
                worker.acquired = need
                worker.actor_cards = cards
                worker.pg_key = pg_key
                worker.state = ACTOR
                worker.actor_id = spec.actor_id
                self._rt.on_actor_dispatched(spec, worker.worker_id)
                msg = {"type": protocol.ACTOR_CREATE, "spec": spec}
                if cards:
                    msg["cards"] = self._lease_str(cards)
                outbox.append((worker.conn, msg))
            else:
                worker.state = BUSY
                worker.tasks[spec.task_id] = spec
                worker.task_res[spec.task_id] = (need, pg_key, charged)
                self._rt.on_task_dispatched(spec, worker.worker_id)
                msg = {"type": protocol.TASK, "spec": spec}
                if cards:
                    worker.task_cards[spec.task_id] = cards
                    msg["cards"] = self._lease_str(cards)
                # getattr: a spec pickled by a pre-r9 peer has no
                # trace fields (dataclasses pickle via __dict__)
                if _tp.enabled() and getattr(spec, "trace_id", 0):
                    self._record_dispatch_spans(spec, worker, t_enq,
                                                charged, msg)
                outbox.append((worker.conn, msg))
            dispatched += 1
        self._send_dispatch_outbox(
            outbox, eager=(len(outbox) == 1 and not self._pending))
        return dispatched > 0

    def _record_dispatch_spans(self, spec, worker: WorkerRec,
                               t_enq: Optional[float],
                               charged: bool, msg: dict) -> None:
        """Tracing plane (r9): the scheduler's two spans for a traced
        task — "queue" (enqueue → this sweep, derived from the
        _queued_at timestamp the queue already keeps, so enqueue pays
        nothing) and "lease" (the dispatch decision; charged=False
        marks a pipelined ride on a BUSY worker's grant). The TASK
        message carries (trace_id, lease span) so the worker's recv/
        exec spans chain under it across the process boundary."""
        t_now = _tp.now()
        t0 = int(t_enq * 1e9) if t_enq is not None else t_now
        sid_q = _tp.new_id()
        _tp.record("sched", "queue", t0, t_now, spec.trace_id, sid_q,
                   getattr(spec, "parent_span", 0),
                   {"node": self.node_id})
        sid_d = _tp.new_id()
        _tp.record("sched", "lease", t_now, _tp.now(), spec.trace_id,
                   sid_d, sid_q,
                   {"worker": worker.worker_id, "charged": charged})
        msg["_trace"] = (spec.trace_id, sid_d)

    def _fail_if_pg_removed(self, spec) -> None:
        """A queued spec whose placement group was removed can never run;
        surface the error instead of parking it forever. Called with the
        node lock held; the lock is DROPPED around the cluster query and
        the runtime callback (cluster holds its lock while taking node
        locks in scheduler_for_worker, so calling into it lock-held is an
        ABBA deadlock)."""
        if self._cluster is None:
            return
        pg_id = spec.placement_group_id
        self._cv.release()
        try:
            pg = self._cluster.get_pg(pg_id)
            removed = pg is None or pg.state == "REMOVED"
        finally:
            self._cv.acquire()
        if not removed or id(spec) not in self._queued_at:
            return
        self._pending.remove(spec)
        self._queued_at.pop(id(spec), None)
        self._demand_sub(spec)
        reason = (f"placement group {pg_id} was removed before "
                  f"{getattr(spec, 'name', spec)!r} could be scheduled")
        self._cv.release()
        try:
            self._rt.on_unplaceable(spec, reason)
        finally:
            self._cv.acquire()

    # ---- actor task routing (bypasses the queue: direct to its worker) ----
    def send_actor_task(self, actor_worker_id: str,
                        spec: ActorTaskSpec) -> bool:
        with self._lock:
            rec = self._workers.get(actor_worker_id)
            if rec is None or rec.state == DEAD or rec.conn is None:
                return False
            msg = {"type": protocol.ACTOR_TASK, "spec": spec}
            if _tp.enabled() and getattr(spec, "trace_id", 0):
                # actor tasks skip the queue: one "lease" span, no
                # queue span (there is no queueing head-side)
                sid = _tp.new_id()
                t0 = _tp.now()
                _tp.record("sched", "lease", t0, t0, spec.trace_id,
                           sid, getattr(spec, "parent_span", 0),
                           {"worker": actor_worker_id})
                msg["_trace"] = (spec.trace_id, sid)
            try:
                rec.conn.send(msg)
                return True
            except protocol.ConnectionClosed:
                return False

    def worker_for_actor(self, actor_id: str) -> Optional[str]:
        with self._lock:
            for rec in self._workers.values():
                if rec.actor_id == actor_id and rec.state != DEAD:
                    return rec.worker_id
        return None

    def worker_conns(self) -> list[tuple]:
        """(worker_id, connection) for every live registered worker —
        the tracing plane's TRACE_DUMP fan-out reads recorders over
        these (head- and agent-side alike)."""
        with self._lock:
            return [(r.worker_id, r.conn)
                    for r in self._workers.values()
                    if r.conn is not None and r.state != DEAD]

    # ---- introspection ----
    def stats(self) -> dict:
        with self._lock:
            return {
                "node_id": self.node_id,
                "total_resources": dict(self.total),
                "available_resources": dict(self.avail),
                "num_workers": self._alive_count(),
                "num_pending_tasks": len(self._pending),
                "workers": {
                    w: {"state": r.state, "actor_id": r.actor_id,
                        "blocked": r.blocked_depth}
                    for w, r in self._workers.items() if r.state != DEAD},
            }

    def shutdown(self) -> None:
        with self._cv:
            self._running = False
            workers = list(self._workers.values())
            self._cv.notify_all()
        for rec in workers:
            if rec.conn is not None:
                try:
                    rec.conn.send({"type": protocol.SHUTDOWN})
                except Exception:
                    pass
        deadline = time.time() + 3.0
        for rec in workers:
            if rec.proc is not None:
                try:
                    rec.proc.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    rec.proc.kill()

    # ---- node-death paths (ClusterTaskManager hooks) ----
    def die_silently(self) -> None:
        """Simulated abrupt node failure: SIGKILL every worker, stop the
        dispatch loop (and with it the heartbeat) WITHOUT telling anyone.
        The cluster health monitor must detect the death."""
        with self._cv:
            self._running = False
            workers = list(self._workers.values())
            self._cv.notify_all()
        for rec in workers:
            if rec.proc is not None:
                try:
                    rec.proc.kill()
                except Exception:
                    pass
            if rec.conn is not None:
                # Detach the connection so worker-lost callbacks don't fire
                # per-worker; recovery happens in one pass at node death.
                rec.conn.meta.pop("worker_id", None)
                try:
                    rec.conn.close()
                except Exception:
                    pass

    def reset_for_fence(self) -> None:
        """Fenced-node reset (r17): the head declared this node dead
        while it was still alive (partition / stalled link / long
        pause) and has re-placed everything it owed — finishing the
        local work would double-execute it. SIGKILL every worker, drop
        the queue and every ledger, restore full availability. Unlike
        ``die_silently`` the dispatch loop keeps running: the agent
        re-registers fresh and earns NEW work on clean workers."""
        with self._cv:
            workers = list(self._workers.values())
            self._workers.clear()
            self._spawning = 0
            self._pending.clear()
            self._queued_at.clear()
            self._pending_demand.clear()
            self._bundles.clear()
            self.avail = dict(self.total)
            self._cards = CardPool.of_node(self.total.get("GPU", 0.0))
            self._cv.notify_all()
        doomed_oids: list = []
        for rec in workers:
            for task in rec.tasks.values():
                doomed_oids.extend(getattr(task, "return_ids", ()))
            if rec.conn is not None:
                # detach so per-worker lost callbacks don't fire and
                # re-report tasks the head already re-placed: this
                # reset IS the recovery
                rec.conn.meta.pop("worker_id", None)
                try:
                    rec.conn.close()
                except Exception:
                    pass
            if rec.proc is not None:
                try:
                    rec.proc.kill()
                except Exception:
                    pass
        # killed workers may have sealed result shm without delivering
        # TASK_DONE — reap locally (the same hygiene the worker-lost
        # path applies; shm outlives processes until reboot otherwise)
        from ray_tpu_torch._private.object_store import reap_object_segments
        for oid in doomed_oids:
            try:
                reap_object_segments(oid)
            except Exception:
                pass

    def drain_for_death(self):
        """Collect (queued specs, running tasks, actor ids on this node)
        and tear everything down. Called by the cluster after the node is
        marked dead."""
        with self._cv:
            self._running = False
            queued = list(self._pending)
            self._pending.clear()
            self._queued_at.clear()
            workers = list(self._workers.values())
            self._cv.notify_all()
        running_tasks, actor_ids = [], []
        for rec in workers:
            if rec.state == DEAD:
                continue
            running_tasks.extend(t for t in rec.tasks.values()
                                 if isinstance(t, TaskSpec))
            if rec.actor_id is not None:
                actor_ids.append(rec.actor_id)
            rec.state = DEAD
            if rec.conn is not None:
                rec.conn.meta.pop("worker_id", None)
                try:
                    rec.conn.close()
                except Exception:
                    pass
            if rec.proc is not None:
                try:
                    rec.proc.kill()
                except Exception:
                    pass
        return queued, running_tasks, actor_ids
