"""Driver-side runtime: the core-worker + head-node composition.

This process plays three reference roles at once (single-node topology):
- the driver's core worker (reference src/ray/core_worker/core_worker.cc:
  SubmitTask:2166, CreateActor:2243, Put:1246, Get:1551),
- the GCS head (tables live in ``Controller``),
- the raylet (dispatch lives in ``Scheduler``).

Multi-process reality is preserved where it matters — user tasks and actors
always run in separate worker processes wired over the socket protocol, and
bulk data rides shared memory — so the concurrency/failure semantics match
the reference even though control-plane hops are function calls.
"""
from __future__ import annotations

import logging
import os
import shutil
import socket
import subprocess
import threading
import time
from typing import Any, Optional

log = logging.getLogger(__name__)

from ray_tpu_torch._private import context as _context
from ray_tpu_torch._private import metrics_plane as _mp
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.controller import (ALIVE, DEAD, PENDING, RESTARTING,
                                         Controller)
from ray_tpu_torch._private.object_store import LocalStore, StoredObject, deserialize
from ray_tpu_torch._private.refs import ObjectRef
from ray_tpu_torch._private.scheduler import Scheduler
from ray_tpu_torch._private.specs import (ActorSpec, ActorTaskSpec, TaskSpec,
                                    bump_attempt)
from ray_tpu_torch.exceptions import (ActorDiedError, ActorError, GetTimeoutError,
                                TaskCancelledError, TaskError,
                                WorkerDiedError)


def _visible_gpus(var: str, ordinals: int, uuids: list) -> int:
    """How many of this host's CUDA devices a process sees under
    ``CUDA_VISIBLE_DEVICES=var``, read as the CUDA runtime reads it: its
    comma-separated entries (ordinals, or ``GPU-``/``MIG-`` UUID
    prefixes) up to the first one that names no device; a repeated
    entry hides every device."""
    seen: list = []
    for entry in var.split(","):
        entry = entry.strip()
        if entry.startswith(("GPU-", "MIG-")):
            hits = [u for u in uuids if u.startswith(entry)]
            if len(hits) != 1:
                break
            dev = hits[0]
        else:
            digits = len(entry) - len(entry.lstrip("0123456789"))
            if not digits:
                break
            dev = int(entry[:digits])
            if dev >= ordinals:
                break
        if dev in seen:
            return 0
        seen.append(dev)
    return len(seen)


def detect_num_gpus() -> int:
    """CUDA device detection that makes no CUDA context in this process
    (the counterpart of the JAX package's TPU chip probe): the devices
    ``nvidia-smi -L`` lists, as many of them as ``CUDA_VISIBLE_DEVICES``
    leaves visible (``init(num_gpus=...)`` overrides it). A host with no
    driver reports 0."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return 0
    try:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    if out.returncode != 0:
        return 0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("GPU ")]
    uuids = [ln.rsplit("UUID: ", 1)[-1].rstrip(")") for ln in lines]
    var = os.environ.get("CUDA_VISIBLE_DEVICES")
    if var is None:
        return len(lines)
    return _visible_gpus(var, len(lines), uuids)


def _summarize_by_state(rows: list) -> dict:
    out: dict[str, int] = {}
    for r in rows:
        out[r.get("state", "?")] = out.get(r.get("state", "?"), 0) + 1
    return out


class _ActorState:
    """Driver-side actor-task routing state (actor_task_submitter.cc parity:
    per-actor ordered queue while the actor is pending/restarting, inflight
    tracking for failure handling)."""

    def __init__(self):
        self.queued: list[ActorTaskSpec] = []
        self.inflight: dict[str, ActorTaskSpec] = {}
        # r18 direct call plane: specs REMOTE callers mirrored via
        # ACTOR_INFLIGHT_DELTA while their direct calls are in flight
        # (the driver's own direct calls sit in `inflight` like any
        # other — its mirror is in-process). Death/restart recovery
        # claims both tables.
        self.direct_inflight: dict[str, ActorTaskSpec] = {}
        # claim epoch (r18 satellite): bumped by every recovery /
        # unplaceable sweep that claims the inflight table. A send
        # that fails AFTER such a sweep must NOT pop/requeue — the
        # sweep already owns the spec (it may have been requeued and
        # re-sent), and popping here silently dropped the call.
        self.epoch = 0
        # sticky head-routed fallback (r18): set on any direct-path
        # failure; cleared once every book is empty (all prior calls
        # terminal), so a fresh direct call can never overtake an
        # older fallback call still queued at the head.
        self.fallback = False
        # per-actor submission-order stamp: every requeue path inserts
        # by it, so a recovery sweep claiming in-flight calls can
        # never prepend them AHEAD of earlier calls a direct-path NACK
        # already requeued (mixed-source queues broke the old
        # "inflight always precedes queued" prepend invariant).
        self.next_order = 0
        self.lock = threading.Lock()


class Runtime(_context.BaseContext):
    is_driver = True

    def __init__(self, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[dict] = None,
                 max_workers: Optional[int] = None,
                 namespace: str = "default",
                 bind_host: Optional[str] = None,
                 port: Optional[int] = None,
                 labels: Optional[dict] = None):
        self.namespace = namespace
        self._started_at = time.time()
        self._head_labels = {k: str(v) for k, v in (labels or {}).items()}
        self.controller = Controller()
        # capacity via RAY_TPU_OBJECT_STORE_MEMORY (bytes); spill policy
        # must never touch objects pinned by in-flight tasks.
        self.store = LocalStore(pinned_fn=self.controller.pinned_ids)
        from concurrent.futures import ThreadPoolExecutor
        from ray_tpu_torch._private.object_transfer import PullServer
        from ray_tpu_torch._private.waiters import WaiterRegistry
        # Blocked worker gets/waits park here (no thread each); the
        # store's seal hook resolves them. "Present" means a local copy
        # OR a known remote location (multi-host). Spill restores and
        # remote pulls run on a small pool so disk reads / network
        # fetches never block connection reader threads.
        self.waiters = WaiterRegistry(
            lambda oid: (self.store.contains(oid)
                         or self.controller.has_location(oid)))
        self.store.on_seal = self.waiters.notify
        self._restore_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="rtpu-restore")
        self._pull_server = PullServer(self.store,
                                       executor=self._restore_pool)
        self._shutdown = False
        self._actor_states: dict[str, _ActorState] = {}
        self._actor_lock = threading.Lock()
        # Head HA (r15): persistence coordinator (WAL + snapshots) and
        # the per-node reconcile state deferred until each rejoining
        # agent's outage backlog has drained. Set early: the cluster
        # consults _ha when it builds RemoteNodeHandles.
        self._ha = None
        self._pending_reconcile: dict[str, tuple] = {}
        # r16 decref-delta accounting (head side): applied frames/
        # entries + replayed frames dropped by the seq watermark
        self._decref_delta_stats = {"frames": 0, "entries": 0,
                                    "deduped_frames": 0}
        # r18 direct actor call plane: head-side counters (driver-as-
        # caller and head-as-host in one dict), the pending table for
        # head-hosted actors' direct calls, the driver's dialed
        # endpoint connections, and the count of head-routed actor
        # frames (the load-independent "head frames per actor call"
        # signal bench_core reads).
        from ray_tpu_torch._private import direct_actor as _da
        self._direct_stats = _da.new_stats()
        self._direct_stats.update(head_routed_sends=0,
                                  head_actor_dones=0, delta_frames=0,
                                  delta_adds=0, delta_dones=0,
                                  send_race_kept=0)
        self._direct_pending = _da.PendingDirectCalls()
        self._direct_conns: dict[tuple, protocol.Connection] = {}
        # per-actor endpoint the driver is currently streaming to:
        # upgrades (agent-hosted -> worker socket once its port rides
        # a heartbeat) only happen at quiet moments — two inbound
        # channels to one worker could reorder a handle's calls
        self._direct_actor_addr: dict[str, tuple] = {}
        # head-as-host completions the worker's TASK_DONE answered
        # BEFORE the caller's coalesced mirror add arrived (the 25 ms
        # delta window vs ~1 ms execution): late adds for these ids
        # must not pin args or park phantom in-flight entries, and
        # their dones must not re-seal/re-record a terminal call
        import collections as _collections
        self._direct_done_ring: "_collections.OrderedDict" = \
            _collections.OrderedDict()
        self._direct_lock = threading.Lock()
        # r17 membership fencing: frames dropped because their
        # connection's incarnation trails the node table (zombie after
        # a partition/stall) + terminal entries dropped because their
        # attempt counter trails the live spec (first-terminal-wins).
        self._fence_stats = {"fenced_frames": 0, "fence_notices": 0,
                             "stale_attempt_drops": 0}
        # reader threads are per-connection with RAY_TPU_EPOLL=0, so
        # these read-modify-writes need the same discipline as the
        # cluster's liveness counters
        self._fence_lock = threading.Lock()
        # serializes snapshot publication: the periodic loop, manual
        # snapshot_now calls, and WAL compaction share one tmp/.prev
        # rotation chain — concurrent writers would rename each
        # other's files out from underneath
        self._snapshot_lock = threading.Lock()

        if num_cpus is None:
            num_cpus = float(max(os.cpu_count() or 1, 4))
        if num_gpus is None:
            num_gpus = float(detect_num_gpus())
        # GPU is always reported, 0 on a host with no card: a num_gpus
        # request there stays infeasible, never placed on the CPU.
        node_res = {"CPU": float(num_cpus), "GPU": float(num_gpus)}
        from ray_tpu_torch._private.config import CONFIG as _CFG
        node_res["memory"] = float(
            os.environ.get("RAY_TPU_NODE_MEMORY")    # legacy name
            or _CFG.node_memory_bytes)
        if resources:
            node_res.update({k: float(v) for k, v in resources.items()})

        from ray_tpu_torch._private.config import CONFIG as _CFG2
        bind = bind_host or _CFG2.bind_host
        # r10: one epoll/select event loop reads every accepted
        # connection (workers, agents, clients) instead of a reader
        # thread each; None (RAY_TPU_EPOLL=0) restores threads.
        self._poller = protocol.make_poller()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind, int(port or _CFG2.port)))
        self._listener.listen(128)
        self.address = self._listener.getsockname()

        from ray_tpu_torch._private.cluster import ClusterTaskManager
        self.cluster = ClusterTaskManager(self)
        # The accept loop starts only AFTER head persistence has
        # rehydrated (end of __init__): an agent re-registering against
        # half-restored tables would miss its parked mirror and its
        # live-actor re-attachment, and a registration processed before
        # the WAL activates would never be logged — the reference GCS
        # likewise serves no RPCs until gcs_init_data has loaded.
        # connect() still succeeds meanwhile (the listener is bound,
        # backlog holds the handshake).
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ray-tpu-accept", daemon=True)
        head = self.cluster.add_node(node_res, max_workers=max_workers,
                                     is_head=True,
                                     labels=self._head_labels)
        self.head_node_id = head.node_id
        _tp.set_role("driver", self.head_node_id)
        # Object plane v2: the head's own pull manager (deduped,
        # bounded, multi-source fetches from agent holders) and the
        # tree-broadcast coordinator, driven by directory add events.
        from ray_tpu_torch._private.broadcast import BroadcastCoordinator
        from ray_tpu_torch._private.pull_manager import PullManager
        self._pull_mgr = PullManager(
            self.store, sources_fn=self._head_pull_sources,
            on_source_failed=lambda oid, nid:
                self.controller.remove_location(oid, nid),
            # r17: suspect holders go to the end of the rotation
            deprioritize_fn=self.cluster.is_suspect,
            # cut-through (r12): the head mid-pull serves landed chunk
            # ranges too — register/retract it as a partial holder so
            # a broadcast rooted elsewhere can relay through it
            on_partial=lambda oid, nbytes:
                self.controller.add_location(oid, self.head_node_id,
                                             nbytes, partial=True),
            on_partial_failed=lambda oid:
                self.controller.remove_location(oid, self.head_node_id))
        self.bcast = BroadcastCoordinator(self)
        self.controller.directory.add_listener(self.bcast.on_location)
        # Cluster metrics plane (r11): head-side scrape fan-out/merge
        # + retention ring; the head's own sampled gauges (per-node
        # lease ledgers, pull-manager occupancy) refresh at scrape
        # time through the sampler hook.
        self.metrics = _mp.ClusterCollector(self)
        _mp.set_sampler("head", self._sample_metrics)
        self._init_head_persistence()
        self._accept_thread.start()

    # ================= head fault tolerance =================
    def _init_head_persistence(self) -> None:
        """Reference GCS persistence (gcs_server_main.cc:26-33 storage
        backend + gcs_init_data.cc rehydration): when
        RAY_TPU_HEAD_SNAPSHOT_PATH is set, restore controller tables
        from disk, then keep them durable. With the r15 WAL
        (RAY_TPU_HEAD_WAL, default on) every state-mutating event is
        group-commit logged and snapshots are taken by compaction, so
        a restarted head rehydrates to the exact pre-crash frontier;
        RAY_TPU_HEAD_WAL=0 reverts to the 1 Hz snapshot-only mode."""
        from ray_tpu_torch._private.config import CONFIG as _CFG
        self._snapshot_path = _CFG.head_snapshot_path or None
        if self._snapshot_path is None:
            return
        if _CFG.head_wal:
            from ray_tpu_torch._private.head_ha import HeadPersistence
            self._ha = HeadPersistence(
                self._snapshot_path,
                _CFG.head_wal_path or (self._snapshot_path + ".wal"),
                fsync_ms=_CFG.head_wal_fsync_ms,
                compact_bytes=_CFG.head_wal_compact_bytes,
                compact_interval_s=_CFG.head_wal_compact_interval_s)
            try:
                self._rehydrate(self._snapshot_path)
            except Exception:
                log.exception("head state restore failed; "
                              "starting with empty tables")
            # live logging starts only after replay: the controller
            # methods replay drives must not re-log their own input
            self._ha.activate()
            self.controller.ha = self._ha
            try:
                # immediate post-recovery snapshot: everything restored
                # (and anything registered before activation) is durable
                # from the first second, and the WAL restarts from a
                # fresh frontier instead of re-replaying the old tail
                # on the next crash
                self.snapshot_now()
            except Exception:
                log.exception("post-recovery snapshot failed")
        elif os.path.exists(self._snapshot_path):
            try:
                self._rehydrate(self._snapshot_path)
            except Exception:
                log.exception("head snapshot restore failed; "
                              "starting with empty tables")
        self._snapshot_thread = threading.Thread(
            target=self._snapshot_loop, name="rtpu-head-snapshot",
            daemon=True)
        self._snapshot_thread.start()

    def _snapshot_loop(self) -> None:
        from ray_tpu_torch._private.config import CONFIG as _CFG
        if self._ha is not None:
            # WAL mode: snapshots happen at compaction (size/age
            # triggered), not on a timer — the WAL carries everything
            # in between
            while not self._shutdown:
                time.sleep(1.0)
                try:
                    self._ha.maybe_compact(self.snapshot_now)
                except Exception:
                    log.exception("head WAL compaction failed")
            return
        period = max(0.1, _CFG.head_snapshot_period_s)
        while not self._shutdown:
            time.sleep(period)
            try:
                self.snapshot_now()
            except Exception:
                log.exception("head snapshot failed")

    def _mirror_tables(self) -> dict:
        """Snapshot extra: every remote node's spec mirror + lease
        ledger (live proxies), merged with mirrors still parked for
        nodes that have not rejoined yet — a compaction during the
        rejoin grace window must not drop their work."""
        mirrors: dict = {}
        for n in self.cluster.alive_nodes():
            h = n.scheduler
            if not hasattr(h, "_work") or not hasattr(h, "_leased"):
                continue                     # in-process local node
            with h._lock:
                mirrors[n.node_id] = {"work": dict(h._work),
                                      "leased": list(h._leased)}
        if self._ha is not None:
            for nid, m in self._ha.pending_mirrors().items():
                mirrors.setdefault(nid, m)
        return mirrors

    def snapshot_now(self) -> None:
        """Atomic, torn-write-proof controller snapshot: the blob is
        version+checksum framed, flushed+fsynced BEFORE the rename
        (a crash after a bare rename could publish a partially-written
        file), and the previous snapshot is kept as ``.prev`` so a
        corrupt blob falls back instead of zeroing the tables."""
        if self._snapshot_path is None or self._shutdown:
            return
        from ray_tpu_torch._private import head_ha as _hha
        # mirrors are captured AFTER the frontier (extra_fn contract):
        # a task routed in the gap is either in the capture or in a
        # replayed madd record, never in neither
        blob = self.controller.snapshot_state(
            extra_fn=lambda: {"_node_mirrors": self._mirror_tables()})
        with self._snapshot_lock:
            if self._ha is not None:
                self._ha.write_snapshot(blob)
            else:
                _hha.write_snapshot_file(self._snapshot_path, blob)

    def _load_snapshot_blob(self, path: str):
        """Newest intact snapshot blob (current file, else ``.prev``),
        or None when neither verifies."""
        from ray_tpu_torch._private import head_ha as _hha
        if self._ha is not None:
            return self._ha.load_snapshot()
        return _hha.load_snapshot_file(path)[0]

    def _rehydrate(self, path: str) -> None:
        """Restore controller tables (snapshot + WAL tail when the WAL
        is on), park each agent's rehydrated spec mirror until it
        rejoins, then reconcile: agents recorded alive get a rejoin
        grace window; actors whose node died with the old head
        (head-local workers, unknown nodes) restart through the normal
        recovery machinery; live tasks mirrored to NO node (they were
        queued or running on the old head's own workers, which died
        with it) re-place immediately."""
        from ray_tpu_torch._private.config import CONFIG as _CFG
        from ray_tpu_torch._private.specs import TaskSpec as _TaskSpec
        blob = self._load_snapshot_blob(path)
        state: dict = {}
        frontier = 0
        if blob is not None:
            state = self.controller.restore_state(blob)
            frontier = int(state.get("_wal_seq", 0))
        snap_mirrors = state.get("_node_mirrors") or {}
        mirrors: dict = {nid: dict(m.get("work", {}))
                         for nid, m in snap_mirrors.items()}
        leases: dict = {nid: set(m.get("leased", ()))
                        for nid, m in snap_mirrors.items()}
        if self._ha is not None:
            tail = self._ha.wal_tail()
            # seed the sequence counter past EVERYTHING recovered: new
            # records appended to the same segment must sort after the
            # old process's records and above the snapshot frontier, or
            # a second crash replays them wrong (skipped or clobbered
            # by stale state)
            self._ha.wal.advance_seq(
                max([frontier] + [r[0] for r in tail]))
            if blob is None and not tail:
                return                       # genuinely fresh start
            self._ha.replay(self.controller, tail, frontier,
                            mirrors, leases)
        elif blob is None:
            return
        # Resolve mirror entries: WAL-replayed adds carry only the key
        # (the spec rides the task-submit record); entries whose task
        # is no longer live completed before the crash — drop them so
        # a replayed completion dedups and a reconcile cannot
        # double-place finished work.
        live_ids = set(self.controller.live_task_ids())
        mirrored_live: set[str] = set()
        for nid in list(mirrors):
            resolved: dict = {}
            for key, entry in mirrors[nid].items():
                if isinstance(entry, tuple):
                    spec, dispatched = entry
                else:                        # WAL "madd": key only
                    spec, dispatched = (
                        self.controller.live_task(key), False)
                if spec is None or not isinstance(spec, _TaskSpec):
                    continue                 # done, or an actor entry
                if spec.task_id not in live_ids:
                    continue
                resolved[key] = (spec, bool(dispatched))
                mirrored_live.add(spec.task_id)
            if resolved and self._ha is not None:
                self._ha.park_node(nid, resolved,
                                   set(leases.get(nid, ()))
                                   & set(resolved))
        if self._ha is not None:
            self._ha.restored_task_ids = set(mirrored_live)
            self._ha.recovered["live_tasks"] = len(live_ids)
        rejoining: set[str] = set()
        for n in self.controller.list_nodes():
            if n["is_head"] or not n["alive"]:
                continue
            rejoining.add(n["node_id"])
            self.cluster.expect_rejoin(n["node_id"],
                                       _CFG.node_rejoin_grace_s)
        self.cluster.restore_pgs(self.controller.list_pgs())
        for info in self.controller.list_actors():
            rec = self.controller.get_actor(info["actor_id"])
            if rec is None or rec.state == DEAD:
                continue
            if rec.node_id in rejoining:
                continue            # its worker may still be alive there
            # worker died with the old head: normal restart bookkeeping
            rec.worker_id = None
            self._recover_actor(rec.spec.actor_id)
        # Live tasks owned by the dead head's own node: nothing will
        # ever complete them — re-place now (no retry budget consumed:
        # the head's death is not the task's failure, r10 agent-death
        # resubmit semantics).
        resubmitted = 0
        for tid in live_ids:
            if tid in mirrored_live:
                continue                # an agent still owes this task
            spec = self.controller.live_task(tid)
            if spec is None:
                continue
            self.controller.record_task_event(
                tid, getattr(spec, "name", ""), "RESUBMITTED",
                error="head restart")
            try:
                bump_attempt(spec)
                self.cluster.submit(spec)
                resubmitted += 1
            except Exception:
                log.exception("head-restart resubmit of %s failed", tid)
        if self._ha is not None:
            self._ha.recovered["resubmitted"] = resubmitted
        log.info("head rehydrated from %s: %d actors, %d live tasks "
                 "(%d mirrored, %d resubmitted), %d nodes pending "
                 "rejoin", path, len(self.controller.list_actors()),
                 len(live_ids), len(mirrored_live), resubmitted,
                 len(rejoining))

    def _process_rejoin(self, rec, msg: dict) -> None:
        """An agent re-registered after a head restart (or reconnect):
        re-attach its live actors, re-learn its object copies, and
        hand its rehydrated spec mirror to the fresh proxy. The
        mirror RECONCILE (re-placing mirrored tasks absent from the
        agent's reported in-flight set) is deferred until the agent's
        ``rejoin_drained`` marker — its buffered completions must pop
        their mirror entries first, or a just-finished task would be
        re-placed and run twice."""
        proxy = rec.scheduler
        node_id = rec.node_id
        pend = (self._ha.take_pending_node(node_id)
                if self._ha is not None else None)
        if pend is not None:
            from ray_tpu_torch._private.specs import TaskSpec as _TaskSpec
            task_work = {k: v for k, v in pend.work.items()
                         if isinstance(v[0], _TaskSpec)}
            proxy.adopt_mirror(task_work, pend.leased & set(task_work))
            known = msg.get("inflight_tasks")
            self._pending_reconcile[node_id] = (
                set(task_work), None if known is None else set(known))
        for oid, nbytes in msg.get("objects", ()):
            self.controller.add_location(oid, node_id, nbytes)
            self.waiters.notify(oid)
        reported = dict(msg.get("live_actors", {}))
        for actor_id, worker_id in reported.items():
            arec = self.controller.get_actor(actor_id)
            if arec is None or arec.state == DEAD:
                continue
            if arec.node_id != node_id:
                # already recovered elsewhere while this agent was away
                # (transient disconnect): the agent's copy is stale —
                # kill it, or two instances of one actor run forever
                proxy.kill_worker(worker_id)
                continue
            proxy.on_dispatched("actor:" + actor_id, worker_id,
                                actor_id=actor_id)
            proxy.track_live_actor(actor_id, arec.spec)
            self.controller.set_actor_state(actor_id, ALIVE,
                                            worker_id=worker_id,
                                            node_id=node_id)
            self._flush_actor_queue(actor_id)
        # actors the tables place on this node but the agent did NOT
        # report: their workers died while no head was watching —
        # recover them or their callers hang forever
        for actor_id in self.controller.actors_on_node(node_id):
            if actor_id not in reported:
                self._recover_actor(actor_id)

    def _reconcile_node_mirror(self, node_id: str) -> None:
        """Post-rejoin lease-ledger resync (r15): of the RESTORED
        mirror entries (and only those — work enqueued after the
        rejoin is untouched), entries the agent did not report as
        in-flight never reached it (lost lease batch / parked lease
        buffer) — re-place them exactly once; entries whose task is no
        longer live completed while the backlog drained — drop them.
        Runs after the agent's ``rejoin_drained`` marker so buffered
        completions have already popped their mirror entries."""
        st = self._pending_reconcile.pop(node_id, None)
        if st is None:
            return
        restored_keys, known = st
        if known is None:
            return          # agent predates the report: keep mirrored
        rec = self.cluster.get_node(node_id)
        if rec is None or not rec.alive:
            return          # node death recovery already ran
        proxy = rec.scheduler
        resubmit = []
        with proxy._lock:
            for key in restored_keys:
                entry = proxy._work.get(key)
                if entry is None or key in known:
                    continue
                if self.controller.live_task(key) is None:
                    # completed during the drain: off the books
                    proxy._work.pop(key, None)
                    proxy._leased.discard(key)
                    continue
                proxy._work.pop(key, None)
                proxy._leased.discard(key)
                resubmit.append(entry[0])
        for spec in resubmit:
            self.controller.record_task_event(
                spec.task_id, spec.name, "RESUBMITTED",
                error=f"lease lost in head restart ({node_id})")
            try:
                bump_attempt(spec)
                self.cluster.submit(spec)
            except Exception:
                log.exception("lease-resync resubmit failed")
        if resubmit and self._ha is not None:
            self._ha.recovered["resubmitted"] += len(resubmit)
        if resubmit:
            log.info("head HA: re-placed %d task(s) whose lease never "
                     "reached %s", len(resubmit), node_id)

    @property
    def scheduler(self):
        """The head node's scheduler (single-node compatibility view)."""
        rec = self.cluster.get_node(self.head_node_id)
        return rec.scheduler if rec else None

    def _scheduler_for_worker(self, worker_id: str):
        return self.cluster.scheduler_for_worker(worker_id)

    def _sched_for_conn(self, conn: protocol.Connection):
        """Scheduler owning this worker connection, cached on the
        connection at REGISTER. A worker never migrates between nodes
        and the cache dies with the connection on worker death, so the
        entry can't go stale — and the per-message probe it replaces
        took EVERY node's hot scheduler lock on every received
        TASK_DONE/GET/WAIT (r7 profile: a top head-CPU cost under
        drains, serializing reader threads against dispatch)."""
        sched = conn.meta.get("sched")
        if sched is None:
            wid = conn.meta.get("worker_id")
            if not wid:
                return None
            sched = self.cluster.scheduler_for_worker(wid)
            if sched is not None:
                conn.meta["sched"] = sched
        return sched

    # ================= connection plumbing =================
    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = protocol.Connection(sock, self._handle_msg,
                                       self._on_conn_closed, name="driver",
                                       server=True, poller=self._poller)
            conn.start()

    def _on_conn_closed(self, conn: protocol.Connection) -> None:
        # reap pull sessions this peer (agent or worker) had open
        self._pull_server.on_conn_closed(conn)
        if self._shutdown:
            return
        nid = conn.meta.get("node_id")
        if nid is not None:
            # an agent's control connection dropped: node death — unless
            # the agent already re-registered on a NEW connection (the
            # old conn's close callback can arrive after the rejoin)
            rec = self.cluster.get_node(nid)
            if rec is not None and getattr(rec.scheduler, "conn",
                                           None) is not conn:
                return
            self.cluster._on_node_death(nid, cause="agent disconnected")
            return
        wid = conn.meta.get("worker_id")
        if wid is None:
            return
        sched = self._scheduler_for_worker(wid)
        if sched is None:
            return
        tasks, actor_id = sched.on_worker_lost(wid)
        self._drop_direct_calls_of_caller(wid)
        for task in tasks:
            self._recover_task(task)
        if actor_id is not None:
            self._recover_actor(actor_id)

    # ================= failure recovery =================
    def _recover_task(self, spec: TaskSpec) -> None:
        """Reference parity: task retries on worker failure
        (task_manager.cc retry bookkeeping; max_retries option)."""
        if getattr(spec, "cancelled", False):
            self._store_error(spec.return_ids, TaskError(
                TaskCancelledError(spec.task_id), task_name=spec.name))
            self._unpin(spec.pinned_refs)
            self.controller.record_task_event(
                spec.task_id, spec.name, "CANCELLED")
            return
        if spec.retries_used < spec.max_retries:
            spec.retries_used += 1
            bump_attempt(spec)
            self.controller.record_task_event(
                spec.task_id, spec.name, "RETRYING")
            self.cluster.submit(spec)
        else:
            err = TaskError(WorkerDiedError(
                f"worker died running task {spec.name or spec.task_id}"),
                task_name=spec.name)
            self._store_error(spec.return_ids, err)
            self._unpin(spec.pinned_refs)
            self.controller.record_task_event(
                spec.task_id, spec.name, "FAILED", error="worker died")

    def _recover_actor(self, actor_id: str) -> None:
        """GcsActorManager restart-on-failure parity
        (gcs_actor_manager.h:89-91 max_restarts bookkeeping)."""
        rec = self.controller.get_actor(actor_id)
        if rec is None or rec.state == DEAD:
            return
        st = self._actor_state(actor_id)
        with st.lock:
            # claim epoch (r18): any in-flight send that fails after
            # this sweep must not repop/requeue — we own every spec
            st.epoch += 1
            inflight = (list(st.inflight.values())
                        + list(st.direct_inflight.values()))
            st.inflight.clear()
            st.direct_inflight.clear()
        can_restart = (rec.spec.max_restarts < 0
                       or rec.num_restarts < rec.spec.max_restarts)
        if can_restart:
            rec.num_restarts += 1
            self.controller.set_actor_state(actor_id, RESTARTING)
            retried = []
            for t in inflight:           # preserve submission order
                if t.retries_used < t.max_retries:
                    t.retries_used += 1
                    retried.append(t)
                else:
                    self._store_error(t.return_ids, TaskError(
                        ActorError(actor_id, "actor restarting; task lost"),
                        task_name=t.name))
            with st.lock:
                # merge by submission stamp (r18): the queue may
                # already hold EARLIER calls a direct-path NACK
                # requeued — a blind prepend of the claimed in-flight
                # set would put later calls ahead of them
                st.queued = sorted(
                    retried + st.queued,
                    key=lambda s: getattr(s, "_order", 0))
            self.cluster.submit(rec.spec)
        else:
            self.controller.set_actor_state(actor_id, DEAD,
                                            death_cause="worker died")
            self._release_actor_refs(actor_id)
            with st.lock:
                dead_tasks = inflight + st.queued
                st.queued = []
            for t in dead_tasks:
                self._store_error(t.return_ids, TaskError(
                    ActorDiedError(actor_id, f"Actor {actor_id} is dead"),
                    task_name=t.name))

    def _store_error(self, return_ids: list[str], err: BaseException) -> None:
        from ray_tpu_torch._private.object_store import reap_object_segments
        for oid in return_ids:
            # a killed worker may have sealed result buffers for these
            # ids without delivering TASK_DONE; reap them or they leak
            # until host reboot (shm persists past process death)
            reap_object_segments(oid)
            self.store.put(err, object_id=oid)

    def on_unplaceable(self, spec, reason: str) -> None:
        """Cluster callback: a spec can never be placed (e.g. hard node
        affinity to a dead node). Fail fast rather than hang."""
        from ray_tpu_torch._private.specs import ActorSpec as _ActorSpec
        if isinstance(spec, _ActorSpec):
            self.controller.set_actor_state(spec.actor_id, DEAD,
                                            death_cause=reason)
            self._release_actor_refs(spec.actor_id)
            st = self._actor_state(spec.actor_id)
            with st.lock:
                st.epoch += 1
                dead = (st.queued + list(st.inflight.values())
                        + list(st.direct_inflight.values()))
                st.queued = []
                st.inflight.clear()
                st.direct_inflight.clear()
            for t in dead:
                self._store_error(t.return_ids, TaskError(
                    ActorDiedError(spec.actor_id, reason),
                    task_name=t.name))
            return
        self._store_error(spec.return_ids, TaskError(
            WorkerDiedError(f"task unplaceable: {reason}"),
            task_name=spec.name))
        self._unpin(spec.pinned_refs)
        self.controller.record_task_event(spec.task_id, spec.name,
                                          "FAILED", error=reason)

    def _release_actor_refs(self, actor_id: str) -> None:
        """Unpin an actor's constructor refs once it is dead for good
        (killed, out of restarts, its creation failed or unplaceable);
        a second call finds nothing left to unpin."""
        rec = self.controller.get_actor(actor_id)
        if rec is None:
            return
        with self._actor_lock:
            refs = rec.spec.pinned_refs
            rec.spec.pinned_refs = []
        self._unpin(refs)

    def _unpin(self, object_ids: list[str]) -> None:
        for oid in object_ids:
            if self.controller.unpin(oid):
                self._delete_everywhere(oid)

    def _seal_contained(self, object_id: str, ids: list[str]) -> None:
        """Register nested-ref containment for a sealed object; inner
        refs released by a refresh (lineage reseal with fresh ids) go
        through the full deletion path."""
        for cid in self.controller.register_contained(object_id, ids):
            self.decref(cid)

    # ================= scheduler callbacks =================
    def on_task_dispatched(self, spec: TaskSpec, worker_id: str) -> None:
        self.controller.record_task_event(
            spec.task_id, spec.name, "RUNNING", worker_id=worker_id)

    def on_actor_dispatched(self, spec: ActorSpec, worker_id: str) -> None:
        sched = self._scheduler_for_worker(worker_id)
        self.controller.set_actor_state(
            spec.actor_id, PENDING, worker_id=worker_id,
            node_id=getattr(sched, "node_id", None))

    # ================= message handlers =================
    def _reply_off_reader(self, conn, msg, name, fn) -> None:
        """Run `fn` on its own thread and reply with its result: a
        state op that fans out and WAITS for replies (one of which may
        arrive on the requesting connection's reader — with the r10
        shared poller, on the one loop thread serving every
        connection) must never run on a connection reader thread."""
        def _run():
            try:
                conn.reply(msg, value=fn())
            except protocol.ConnectionClosed:
                pass
            except Exception as e:
                # the caller is BLOCKED on this reply: a swallowed
                # exception here means it hangs for its full request
                # timeout instead of seeing the failure
                try:
                    conn.reply(msg, value=None,
                               error=f"{type(e).__name__}: {e}")
                except protocol.ConnectionClosed:
                    pass
        threading.Thread(target=_run, name=name, daemon=True).start()

    # ---- incarnation fencing (r17) ----
    # State-bearing frame types an agent emits: every one of these is
    # admission-checked against the node incarnation table before it
    # can touch head state. Request/reply relays (SUBMIT/WAIT/KV) are
    # deliberately NOT fenced — their effects are idempotent or
    # re-issued by the re-placed winner, and swallowing their replies
    # would hang workers the fence reset is about to kill anyway.
    _FENCED_TYPES = frozenset((
        protocol.NODE_HEARTBEAT, protocol.NODE_EVENT,
        protocol.NODE_TASK_DONE, protocol.NODE_TASK_DONE_BATCH,
        protocol.NODE_DECREF_DELTA, protocol.OBJECT_ADDED,
        protocol.OBJECT_REMOVED, protocol.DECREF,
        protocol.DECREF_BATCH, protocol.ADDREF,
        # r18: a zombie agent's relayed direct-call mirror deltas
        # must not pin refs or park phantom in-flight entries
        protocol.ACTOR_INFLIGHT_DELTA))

    def _admit_node_frame(self, conn: protocol.Connection,
                          msg: dict) -> bool:
        """False = the frame came from a STALE incarnation of its node
        (declared dead while still alive): drop it — none of its
        completions, refcount releases, or location claims may land —
        and answer NODE_FENCED once per connection, telling the zombie
        to kill its workers, clear its ledgers, and re-register."""
        inc = conn.meta.get("incarnation")
        if inc is None:
            return True          # local worker conn / pre-r17 agent
        nid = conn.meta.get("node_id") or msg.get("node_id")
        cur = self.controller.node_incarnation(nid)
        if cur is None or inc == cur:
            return True
        with self._fence_lock:
            self._fence_stats["fenced_frames"] += 1
        if not conn.meta.get("fence_notified"):
            conn.meta["fence_notified"] = True
            with self._fence_lock:
                self._fence_stats["fence_notices"] += 1
            self.cluster.bump_liveness("fenced")
            self.controller.publish_node_event(
                nid, "FENCED",
                cause=f"stale incarnation {inc} < {cur}")
            log.warning("fencing node %s: frame from stale "
                        "incarnation %s (current %s)", nid, inc, cur)
            try:
                conn.send({"type": protocol.NODE_FENCED,
                           "node_id": nid, "incarnation": cur})
            except protocol.ConnectionClosed:
                pass
        return False

    def _handle_msg(self, conn: protocol.Connection, msg: dict) -> None:
        mtype = msg["type"]
        if (mtype in self._FENCED_TYPES
                and not self._admit_node_frame(conn, msg)):
            return
        if mtype == protocol.REGISTER:
            sched = self._scheduler_for_worker(msg["worker_id"])
            if sched is not None:
                sched.on_worker_registered(msg["worker_id"], conn)
                conn.meta["sched"] = sched     # hot-path cache
                # surfaced via workers_snapshot / list_workers
                conn.meta["wire_native"] = bool(
                    msg.get("wire_native", False))
                # r18 worker-direct serving port (None: no listener)
                conn.meta["direct_port"] = msg.get("direct_port")
            else:
                conn.close()              # worker from a dead/old node
        elif mtype == protocol.TASK_DONE:
            self._on_task_done(conn, msg)
        elif mtype == protocol.GET_OBJECT:
            self._on_get_object(conn, msg)
        elif mtype == protocol.WAIT:
            self._on_wait(conn, msg)
        elif mtype == protocol.PUT_OBJECT:
            stored: StoredObject = msg["stored"]
            self._seal_contained(stored.object_id, stored.contained_ids)
            self.store.put_stored(stored)
            self.controller.addref(stored.object_id)
            # producer-side backpressure hint: the WORKER throttles its
            # own puts (blocking this reader thread would stall the
            # completions that release pins)
            conn.reply(msg, ok=True,
                       pressure=self.store.over_capacity())
        elif mtype == protocol.SUBMIT:
            spec: TaskSpec = msg["spec"]
            if msg.get("func_bytes") is not None:
                self.controller.put_function(spec.func_id, msg["func_bytes"])
            self.submit_spec(spec)
            conn.reply(msg, ok=True)
        elif mtype == protocol.SUBMIT_ACTOR:
            aspec: ActorSpec = msg["spec"]
            if msg.get("class_bytes") is not None:
                self.controller.put_function(aspec.class_id,
                                             msg["class_bytes"])
            self.create_actor_from_spec(aspec)
            conn.reply(msg, ok=True)
        elif mtype == protocol.SUBMIT_ACTOR_TASK:
            self.submit_actor_task_spec(msg["actor_id"], msg["spec"],
                                        register_borrows=False)
            conn.reply(msg, ok=True)
        elif mtype == protocol.ACTOR_RESOLVE:
            conn.reply(msg,
                       **self._resolve_actor_endpoint(msg["actor_id"]))
        elif mtype == protocol.ACTOR_TASK_DIRECT:
            self._on_actor_task_direct(conn, msg)
        elif mtype == protocol.ACTOR_INFLIGHT_DELTA:
            self._on_actor_inflight_delta(conn, msg)
        elif mtype == protocol.KV_OP:
            conn.reply(msg, value=self._kv_dispatch(msg))
        elif mtype == protocol.DECREF:
            self.decref(msg["object_id"])
        elif mtype == protocol.DECREF_BATCH:
            self.decref_batch(msg["object_ids"])
        elif mtype == protocol.NODE_DECREF_DELTA:
            self._on_decref_delta(msg)
        elif mtype == protocol.ADDREF:
            self.controller.addref(msg["object_id"])
        elif mtype == protocol.STATE_OP:
            from ray_tpu_torch._private.pubsub import StaleCursorError
            kwargs = msg.get("kwargs", {})
            try:
                if (msg["op"] == "pubsub_poll"
                        and kwargs.get("timeout")):
                    # long-poll parks in the publisher's waiter list and
                    # replies on publish/expiry — NEVER blocks this
                    # reader thread (it carries the subscriber's other
                    # traffic)
                    def _reply(msgs, cursor, conn=conn, msg=msg):
                        try:
                            conn.reply(msg, value=(msgs, cursor))
                        except protocol.ConnectionClosed:
                            pass
                    self.controller.pubsub.add_waiter(
                        kwargs["channel"], kwargs.get("cursor", 0),
                        float(kwargs["timeout"]), _reply)
                elif msg["op"] == "trace_dump":
                    # fans TRACE_DUMP out and WAITS for replies — one
                    # of which may arrive on THIS reader thread (the
                    # requesting worker's own dump): never collect on
                    # a connection reader (same rule as broadcast)
                    self._reply_off_reader(
                        conn, msg, "rtpu-trace-dump",
                        lambda kwargs=kwargs: self._trace_dump(
                            timeout=kwargs.get("timeout", 5.0)))
                elif msg["op"] in ("metrics_dump", "metrics_summary"):
                    # fans METRICS_DUMP out and WAITS for replies —
                    # one may arrive on THIS reader thread (same rule
                    # as trace_dump: never collect on a conn reader)
                    self._reply_off_reader(
                        conn, msg, "rtpu-metrics-dump",
                        lambda op=msg["op"], kwargs=kwargs:
                            self.state_op(op, **kwargs))
                elif msg["op"] == "cancel_task":
                    # issues blocking NODE_CANCEL_PENDING /
                    # NODE_FIND_TASK RPCs to agents whose replies
                    # arrive on THIS reader (with the r10 shared
                    # poller: on the one loop thread serving every
                    # connection) — same rule as trace_dump/broadcast:
                    # never collect on a connection reader
                    self._reply_off_reader(
                        conn, msg, "rtpu-cancel",
                        lambda kwargs=kwargs: self.state_op(
                            "cancel_task", **kwargs))
                elif msg["op"] == "broadcast_object":
                    # blocks until the whole tree completes — never on
                    # a connection reader thread
                    def _bc(conn=conn, msg=msg, kwargs=kwargs):
                        try:
                            conn.reply(msg, value=self.state_op(
                                "broadcast_object", **kwargs))
                        except protocol.ConnectionClosed:
                            pass
                        except Exception as e:
                            # api.broadcast re-raises from this shape,
                            # so remote callers see the same exception
                            # contract as the in-process driver path
                            try:
                                conn.reply(msg, value={
                                    "error": str(e),
                                    "error_type": type(e).__name__})
                            except protocol.ConnectionClosed:
                                pass
                    threading.Thread(target=_bc, name="rtpu-bcast",
                                     daemon=True).start()
                else:
                    conn.reply(msg, value=self.state_op(
                        msg["op"], **kwargs))
            except StaleCursorError as e:
                # one contract across transports: the client-side
                # state_op re-raises this as StaleCursorError(resync=N)
                conn.reply(msg, value=None, stale=True,
                           resync=getattr(e, "resync", 0),
                           detail=str(e))
        elif mtype == protocol.NODE_REGISTER:
            rec = self.cluster.add_remote_node(
                conn, msg["resources"], labels=msg.get("labels"),
                advertise_addr=tuple(msg["advertise_addr"]),
                node_id=msg.get("node_id"))
            conn.meta["node_id"] = rec.node_id
            # r17: this connection speaks for the incarnation minted
            # at THIS registration — frames from any older connection
            # of the same node are fenced from here on
            conn.meta["incarnation"] = rec.scheduler.incarnation
            conn.meta.pop("fence_notified", None)
            if msg.get("rejoin"):
                self._process_rejoin(rec, msg)
            else:
                # a FRESH agent process under this node id restarts
                # its decref-delta seq counter: drop the watermark or
                # its first frames would be deduped as replays
                self.controller.reset_decref_seq(rec.node_id)
            conn.reply(msg, node_id=rec.node_id,
                       incarnation=rec.scheduler.incarnation)
        elif mtype == protocol.NODE_HEARTBEAT:
            nid = msg["node_id"]
            self.cluster.heartbeat(nid)
            rec = self.cluster.get_node(nid)
            if rec is not None:
                rec.scheduler.on_heartbeat(msg)
            if "host_stats" in msg:
                self.controller.update_host_stats(nid, msg["host_stats"])
        elif mtype == protocol.NODE_EVENT:
            self._on_node_event(conn, msg)
        elif mtype == protocol.NODE_TASK_DONE:
            self._on_node_task_done(conn, msg)
        elif mtype == protocol.NODE_TASK_DONE_BATCH:
            self._on_node_task_done_batch(conn, msg)
        elif mtype == protocol.OBJECT_LOOKUP:
            self._on_object_lookup(conn, msg)
        elif mtype == protocol.LOCATE_OBJECT:
            self._on_locate_object(conn, msg)
        elif mtype == protocol.OBJECT_ADDED:
            self._on_object_added(msg)
        elif mtype == protocol.OBJECT_REMOVED:
            self.controller.remove_location(msg["object_id"],
                                            msg.get("node_id"))
        elif mtype == protocol.PULL_OBJECT:
            self._pull_server.handle_pull(conn, msg)
        elif mtype == protocol.PULL_CHUNK:
            self._pull_server.handle_chunk(conn, msg)
        elif mtype == protocol.PING:
            conn.reply(msg, ok=True)

    def _on_task_done(self, conn: protocol.Connection, msg: dict) -> None:
        t_tr = _tp.recv_t0(msg)
        try:
            self._on_task_done_inner(conn, msg)
        finally:
            self._record_done(msg, t_tr)

    def _on_task_done_inner(self, conn: protocol.Connection,
                            msg: dict) -> None:
        results: list[StoredObject] = msg.get("results", [])
        for stored in results:
            self._seal_contained(stored.object_id, stored.contained_ids)
            self.store.put_stored(stored)
            # Fire-and-forget results whose refs were already dropped must
            # be evicted here, or they accumulate until shutdown.
            if self.controller.unreferenced(stored.object_id):
                self._delete_everywhere(stored.object_id)
        if msg.get("direct_located"):
            # r18 worker-direct large results from a HEAD-LOCAL
            # worker: sealed into the head store by the loop above
            # (the owner-side copy every getter resolves against) —
            # the worker already answered its caller inline, so no
            # done routing happens here
            return
        worker_id = conn.meta.get("worker_id", "")
        wsched = self._sched_for_conn(conn)
        if msg.get("is_actor_create"):
            actor_id = msg["actor_id"]
            if wsched is not None:
                wsched.actor_ready(worker_id)
            if msg.get("error"):
                rec = self.controller.get_actor(actor_id)
                if rec is not None:
                    rec.spec.max_restarts = 0  # init failure is terminal
                self.controller.set_actor_state(
                    actor_id, DEAD, death_cause="creation failed")
                self._release_actor_refs(actor_id)
                st = self._actor_state(actor_id)
                with st.lock:
                    dead = st.queued
                    st.queued = []
                cause = msg.get("error_repr", "actor __init__ raised")
                for t in dead:
                    self._store_error(t.return_ids, TaskError(
                        ActorDiedError(actor_id, cause), task_name=t.name))
            else:
                self.controller.set_actor_state(
                    actor_id, ALIVE, worker_id=worker_id,
                    node_id=getattr(wsched, "node_id", None))
                self._flush_actor_queue(actor_id)
            return
        task_id = msg["task_id"]
        if msg.get("is_actor_task"):
            # r18 head-as-host: this completion belongs to a remote
            # caller's direct call — answer it inline on the dialed
            # connection (results are already sealed above, the head
            # store IS the owner-side copy) and clear any mirror entry
            # the caller's delta already parked.
            ent = self._direct_pending.pop(task_id)
            if ent is not None:
                with self._direct_lock:
                    ring = self._direct_done_ring
                    ring[task_id] = None
                    while len(ring) > 4096:
                        ring.popitem(last=False)
                self._reply_direct_done(ent, msg, results)
                st = self._actor_states.get(msg.get("actor_id", ""))
                if st is not None:
                    with st.lock:
                        spec = st.direct_inflight.pop(task_id, None)
                    if spec is not None:
                        self._unpin(spec.pinned_refs)
                state = "FAILED" if msg.get("error") else "FINISHED"
                self.controller.record_task_event(
                    task_id, msg.get("name", ""), state,
                    worker_id=worker_id)
                return
            self._direct_stats["head_actor_dones"] += 1
            st = self._actor_states.get(msg.get("actor_id", ""))
            if st is not None:
                with st.lock:
                    spec = st.inflight.pop(task_id, None)
                if spec is not None:
                    self._unpin(spec.pinned_refs)
                    _mp.observe_task_done(
                        spec, getattr(wsched, "node_id",
                                      self.head_node_id))
            state = "FAILED" if msg.get("error") else "FINISHED"
            self.controller.record_task_event(task_id, msg.get("name", ""),
                                              state, worker_id=worker_id)
            return
        spec = (wsched.task_finished(worker_id, task_id,
                                     cuda_bound=msg.get("cuda_bound"))
                if wsched is not None else None)
        if spec is not None:
            self._unpin(spec.pinned_refs)
            _mp.observe_task_done(
                spec, getattr(wsched, "node_id", self.head_node_id))
            state = "FAILED" if msg.get("error") else "FINISHED"
            self.controller.record_task_event(spec.task_id, spec.name, state,
                                              worker_id=worker_id)

    # ================= node-agent message handlers =================
    def _proxy_for(self, node_id: str):
        rec = self.cluster.get_node(node_id)
        return rec.scheduler if rec is not None else None

    def _on_node_event(self, conn: protocol.Connection, msg: dict) -> None:
        kind = msg["kind"]
        proxy = self._proxy_for(msg["node_id"])
        if kind == "task_dispatched":
            if proxy is not None:
                proxy.on_dispatched(msg["key"], msg["worker_id"])
            self.controller.record_task_event(
                msg["key"], msg.get("name", ""), "RUNNING",
                worker_id=msg["worker_id"])
        elif kind == "actor_dispatched":
            if proxy is not None:
                proxy.on_dispatched(msg["key"], msg["worker_id"],
                                    actor_id=msg["actor_id"])
            self.controller.set_actor_state(msg["actor_id"], PENDING,
                                            worker_id=msg["worker_id"],
                                            node_id=msg["node_id"])
        elif kind == "worker_lost":
            if proxy is not None:
                proxy.on_worker_lost(msg["worker_id"])
            self._drop_direct_calls_of_caller(msg["worker_id"])
            for task in msg.get("tasks", ()):
                if proxy is not None:
                    proxy.on_finished(task.task_id)
                self._recover_task(task)
            actor_id = msg.get("actor_id")
            if actor_id is not None:
                if proxy is not None:
                    proxy.on_finished("actor:" + actor_id)
                self._recover_actor(actor_id)
        elif kind == "lease_reclaimed":
            # r10 lease revoke hand-back: the agent pulled these
            # queued-not-started tasks out of its queue — re-place the
            # MIRROR specs (authoritative retry/trace state). The pop
            # is the dedup guard: a replayed event or a racing death
            # drain finds the mirror empty and does nothing, so a task
            # is re-placed at most once.
            for spec in msg.get("specs", ()):
                mirror = (proxy.on_finished(spec.task_id)
                          if proxy is not None else None)
                if mirror is None:
                    continue
                try:
                    # same churn cap as spillback: a task bounced
                    # between saturated nodes stops moving after 3 hops
                    mirror._spill_count = \
                        getattr(mirror, "_spill_count", 0) + 1
                except AttributeError:
                    pass
                bump_attempt(mirror)
                self.cluster.submit(mirror)
        elif kind == "unplaceable":
            if proxy is not None:
                proxy.on_finished(proxy._key(msg["spec"]))
            self.on_unplaceable(msg["spec"], msg["reason"])
        elif kind == "object_at":
            self._on_object_added(msg)
        elif kind == "location_gone":
            holder = msg.get("holder")
            if holder:
                self.controller.remove_location(msg["object_id"], holder)
        elif kind == "rejoin_drained":
            # the rejoining agent's outage backlog has fully flushed
            # (connection FIFO): safe to reconcile its restored mirror.
            # Off the reader thread — resubmits may fan out RPCs.
            threading.Thread(
                target=self._reconcile_node_mirror,
                args=(msg["node_id"],),
                name="rtpu-ha-reconcile", daemon=True).start()
        elif kind == "actor_task_undeliverable":
            # the agent couldn't hand the pushed task to its worker
            # (worker died in the gap): requeue unless recovery already
            # claimed it (mirrors the local send-failure path)
            spec = msg["spec"]
            st = self._actor_state(msg["actor_id"])
            with st.lock:
                if st.inflight.pop(spec.task_id, None) is not None:
                    self._requeue_in_order(st, spec)

    def _on_node_task_done(self, conn: protocol.Connection,
                           msg: dict) -> None:
        """NODE_TASK_DONE: the control half of a remote TASK_DONE. Bulk
        results either arrived inline (small / errors) or stayed in the
        agent's store with a location registered here."""
        t_tr = _tp.recv_t0(msg)
        try:
            self._on_node_task_done_inner(conn, msg)
        finally:
            self._record_done(msg, t_tr)

    def _on_node_task_done_inner(self, conn: protocol.Connection,
                                 msg: dict) -> None:
        node_id = msg["node_id"]
        proxy = self._proxy_for(node_id)
        self._apply_node_done(node_id, proxy, msg)

    def _on_node_task_done_batch(self, conn: protocol.Connection,
                                 msg: dict) -> None:
        """NODE_TASK_DONE_BATCH (r10 delegated dispatch): N plain-task
        completions in ONE frame — each entry is the control half of a
        classic NODE_TASK_DONE (worker_id, inline/located results,
        error, per-entry trace context). One decode + one handler
        invocation amortizes the head's per-completion cost; the
        per-entry bookkeeping (seal, directory, mirror, task events)
        is unchanged."""
        node_id = msg["node_id"]
        proxy = self._proxy_for(node_id)
        # r15: a rejoining agent re-ships the sent-but-maybe-never-
        # processed tail of its completion ring; entries the old head
        # DID process dedup against the rehydrated mirror below
        replayed = bool(msg.get("replayed"))
        for entry in msg.get("done", ()):
            t_tr = _tp.recv_t0(entry)
            try:
                self._apply_node_done(node_id, proxy, entry,
                                      replayed=replayed)
            finally:
                self._record_done(entry, t_tr)

    def _apply_node_done(self, node_id: str, proxy, msg: dict,
                         replayed: bool = False) -> None:
        # r17 first-terminal-wins: a completion whose attempt counter
        # trails the live spec executed a SUPERSEDED placement (the
        # task was re-placed after a death declaration / reclaim) —
        # drop the whole entry before any seal/directory/unpin runs,
        # or the loser's results and refcount releases would land on
        # top of the winner's. A task that is no longer LIVE already
        # saw its first terminal (winner applied, or cancelled/failed):
        # any later attempt-carrying entry is a loser or a duplicate —
        # drop it too, or its re-seal would refresh nested-ref
        # containment with the loser's fresh inner ids and decref the
        # winner's (premature free).
        att = msg.get("attempt")
        if (att is not None and not msg.get("is_actor_create")
                and not msg.get("is_actor_task")):
            task_id_ = msg.get("task_id")
            live = self.controller.live_task(task_id_)
            if live is None:
                if replayed and self._ha is not None:
                    # r15 accounting: a replayed entry whose task is
                    # already terminal is a dedup, same as the
                    # empty-mirror-pop path it used to take
                    self._ha.note_replayed_completion(task_id_,
                                                      deduped=True)
                else:
                    with self._fence_lock:
                        self._fence_stats["stale_attempt_drops"] += 1
                if proxy is not None:
                    proxy.on_finished(task_id_)   # mirror hygiene
                return
            if getattr(live, "attempt", 0) > att:
                with self._fence_lock:
                    self._fence_stats["stale_attempt_drops"] += 1
                return
        for stored in msg.get("inline", []):
            self._seal_contained(stored.object_id, stored.contained_ids)
            self.store.put_stored(stored)
            if self.controller.unreferenced(stored.object_id):
                self._delete_everywhere(stored.object_id)
        for oid, nbytes, contained in msg.get("located", []):
            self._seal_contained(oid, contained)
            self.controller.add_location(oid, node_id, nbytes)
            self.waiters.notify(oid)
        worker_id = msg.get("worker_id", "")
        if msg.get("is_actor_create"):
            actor_id = msg["actor_id"]
            if proxy is not None:
                proxy.on_finished("actor:" + actor_id)
                # keep the actor's mirror entry: restarts need the spec
                rec0 = self.controller.get_actor(actor_id)
                if rec0 is not None and not msg.get("error"):
                    proxy.track_live_actor(actor_id, rec0.spec)
            if msg.get("error"):
                rec = self.controller.get_actor(actor_id)
                if rec is not None:
                    rec.spec.max_restarts = 0
                self.controller.set_actor_state(
                    actor_id, DEAD, death_cause="creation failed")
                self._release_actor_refs(actor_id)
                st = self._actor_state(actor_id)
                with st.lock:
                    dead = st.queued
                    st.queued = []
                cause = msg.get("error_repr", "actor __init__ raised")
                for t in dead:
                    self._store_error(t.return_ids, TaskError(
                        ActorDiedError(actor_id, cause), task_name=t.name))
            else:
                self.controller.set_actor_state(actor_id, ALIVE,
                                                worker_id=worker_id,
                                                node_id=node_id)
                self._flush_actor_queue(actor_id)
            return
        task_id = msg["task_id"]
        if msg.get("is_actor_task"):
            self._direct_stats["head_actor_dones"] += 1
            st = self._actor_states.get(msg.get("actor_id", ""))
            if st is not None:
                with st.lock:
                    spec = st.inflight.pop(task_id, None)
                if spec is not None:
                    self._unpin(spec.pinned_refs)
                    _mp.observe_task_done(spec, node_id)
            state = "FAILED" if msg.get("error") else "FINISHED"
            self.controller.record_task_event(task_id, msg.get("name", ""),
                                              state, worker_id=worker_id)
            return
        spec = proxy.on_finished(task_id) if proxy is not None else None
        if replayed and self._ha is not None:
            # exactly-once accounting across the restart: a replayed
            # entry whose mirror pop hit counts as a recovered
            # completion; an empty pop means the pre-crash head (or an
            # earlier copy of this entry) already processed it
            self._ha.note_replayed_completion(task_id,
                                              deduped=spec is None)
        if spec is not None:
            self._unpin(spec.pinned_refs)
            _mp.observe_task_done(spec, node_id)
            state = "FAILED" if msg.get("error") else "FINISHED"
            self.controller.record_task_event(spec.task_id, spec.name,
                                              state, worker_id=worker_id)

    def _on_object_added(self, msg: dict) -> None:
        """A node sealed/pulled a copy (OBJECT_ADDED, or the legacy
        object_at node event): register the location — the directory
        listener cascades any active broadcast — and wake getters.
        ``partial`` entries (r12 cut-through: the sender landed its
        first chunk and can relay landed ranges) register advisory
        partial holders only: no refcount, no waiter wakeups — the
        object is not actually available there yet."""
        oid = msg["object_id"]
        if msg.get("partial"):
            self.controller.add_location(oid, msg["node_id"],
                                         msg.get("nbytes", 0),
                                         partial=True)
            return
        self._seal_contained(oid, msg.get("contained") or [])
        if msg.get("addref"):
            self.controller.addref(oid)
        self.controller.add_location(oid, msg["node_id"],
                                     msg.get("nbytes", 0))
        self.waiters.notify(oid)

    def _on_locate_object(self, conn: protocol.Connection,
                          msg: dict) -> None:
        """Non-blocking directory read (LOCATE_OBJECT): every alive
        holder's dial address, for multi-source pulls. Unlike
        OBJECT_LOOKUP this never parks — pull managers use it to
        rotate sources mid-transfer."""
        oid = msg["object_id"]
        locs = []
        alive = {n.node_id: n for n in self.cluster.alive_nodes()}
        for nid in self.controller.locations(oid):
            rec = alive.get(nid)
            addr = (getattr(rec.scheduler, "advertise_addr", None)
                    if rec else None)
            if addr is not None:
                locs.append({"host": addr[0], "port": int(addr[1]),
                             "node_id": nid,
                             # r17: pullers deprioritize suspect
                             # holders (gray failure in progress) —
                             # the flag is the contract; the agent
                             # shuffles and re-orders locally
                             "suspect": rec.suspect})
        conn.reply(msg, locations=locs,
                   head_has=self.store.contains(oid),
                   nbytes=self.controller.directory.nbytes(oid))

    def _on_object_lookup(self, conn: protocol.Connection,
                          msg: dict) -> None:
        """An agent asks where an object lives; parks here until it
        exists anywhere (the head owns waiter parking cluster-wide)."""
        oid = msg["object_id"]

        def answer(w=None, timed_out: bool = False) -> None:
            try:
                if timed_out:
                    conn.reply(msg, stored=None, location=None)
                    return
                stored = self.store.get_stored(oid, timeout=0,
                                               restore=False)
                if stored is None and self.store.contains(oid):
                    # spilled head-side: restore off-thread, then serve
                    self._restore_pool.submit(self._lookup_restore_reply,
                                              conn, msg, oid)
                    return
                if stored is not None:
                    from ray_tpu_torch._private.config import CONFIG as _C
                    from ray_tpu_torch._private.object_transfer import materialize
                    if stored.nbytes <= _C.remote_inline_max_bytes:
                        conn.reply(msg, stored=materialize(stored))
                    else:
                        conn.reply(msg, stored=None, head_pull=True)
                    return
                locs = self.controller.locations(oid)
                alive = {n.node_id: n for n in self.cluster.alive_nodes()}
                for nid in locs:
                    rec = alive.get(nid)
                    addr = getattr(rec.scheduler, "advertise_addr",
                                   None) if rec else None
                    if addr is not None:
                        conn.reply(msg, stored=None,
                                   location={"host": addr[0],
                                             "port": addr[1],
                                             "node_id": nid})
                        return
                conn.reply(msg, stored=None, location=None)
            except protocol.ConnectionClosed:
                pass

        if (self.store.contains(oid)
                or self.controller.has_location(oid)):
            answer()
            return
        self.waiters.add_get(oid, lambda w, to: answer(w, to),
                             msg.get("timeout"))

    def _lookup_restore_reply(self, conn, msg, oid: str) -> None:
        from ray_tpu_torch._private.config import CONFIG as _C
        from ray_tpu_torch._private.object_transfer import materialize
        try:
            stored = self.store.get_stored(oid, timeout=30)
            if stored is None:
                conn.reply(msg, stored=None, location=None)
            elif stored.nbytes <= _C.remote_inline_max_bytes:
                conn.reply(msg, stored=materialize(stored))
            else:
                conn.reply(msg, stored=None, head_pull=True)
        except protocol.ConnectionClosed:
            pass

    def _on_get_object(self, conn: protocol.Connection, msg: dict) -> None:
        """Event-driven get: a fast residency probe on the reader
        thread; on miss the request parks in the waiter registry (no
        thread) and the put_stored seal hook resolves it. Spilled
        objects restore on a small worker pool so the disk read never
        runs on a connection reader thread."""
        oid = msg["object_id"]
        stored = self.store.get_stored(oid, timeout=0, restore=False)
        if stored is not None:
            conn.reply(msg, stored=stored)
            return
        timeout = msg.get("timeout")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        wid = conn.meta.get("worker_id")
        wsched = self._sched_for_conn(conn)
        if self.store.contains(oid) or self.controller.has_location(oid):
            self._restore_pool.submit(
                self._blocking_get_reply, conn, msg, oid, deadline,
                wsched, wid)
            return
        self._park_get(conn, msg, oid, deadline, wsched, wid)

    def _park_get(self, conn, msg, oid, deadline: Optional[float],
                  wsched, wid) -> None:
        """Park a get in the waiter registry until the object seals
        locally or a location registers; resolution routes any actual
        disk/network work back to the restore pool."""
        if wsched is not None:
            wsched.worker_blocked(wid)
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))

        def reply(w, timed_out: bool) -> None:
            try:
                if timed_out:
                    conn.reply(msg, stored=None, timeout=True)
                    return
                got = self.store.get_stored(oid, timeout=0, restore=False)
                if got is not None:
                    conn.reply(msg, stored=got)
                elif (self.store.contains(oid)
                      or self.controller.has_location(oid)):
                    # spilled or remote: remaining budget only
                    self._restore_pool.submit(
                        self._blocking_get_reply, conn, msg, oid,
                        deadline, wsched, wid)
                else:
                    # sealed then evicted in the gap: genuine miss
                    conn.reply(msg, stored=None, timeout=True)
            except protocol.ConnectionClosed:
                pass

        self.waiters.add_get(
            oid, reply, remaining,
            on_done=((lambda: wsched.worker_unblocked(wid))
                     if wsched is not None else None))

    def _blocking_get_reply(self, conn, msg, oid,
                            deadline: Optional[float],
                            wsched=None, wid=None) -> None:
        """Restore/pull-pool path: does only work that is actionable NOW
        (spill restore, remote pull). If the object becomes truly absent
        — stale location dropped, nothing local — the request goes BACK
        to the waiter registry instead of parking a pool thread: the
        2-thread pool must never be consumed by indefinite waits. The
        worker stays marked blocked while we do actual work here
        (oversubscription parity with the old thread-per-get path)."""
        if wsched is not None:
            wsched.worker_blocked(wid)
        try:
            while True:
                got = self.store.get_stored(oid, timeout=0)
                if got is not None:
                    conn.reply(msg, stored=got)
                    return
                if self.controller.has_location(oid):
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    got = self._pull_remote(oid, timeout=remaining)
                    if got is not None:
                        conn.reply(msg, stored=got)
                        return
                    if (deadline is not None
                            and time.monotonic() >= deadline):
                        conn.reply(msg, stored=None, timeout=True)
                        return
                    continue            # stale location dropped; re-check
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    conn.reply(msg, stored=None, timeout=True)
                    return
                # nothing actionable: hand back to the registry
                self._park_get(conn, msg, oid, deadline, wsched, wid)
                return
        except protocol.ConnectionClosed:
            pass
        finally:
            if wsched is not None:
                wsched.worker_unblocked(wid)

    # ================= cross-host object fetch =================
    def _get_stored_anywhere(self, oid: str,
                             timeout: Optional[float]) -> Optional[
                                 StoredObject]:
        """Blocking fetch that spans the cluster: local store (incl.
        spill restore), else chunked pull from whichever alive agent
        holds a copy (reference pull_manager.cc role). Stale locations
        (holder died/evicted) are dropped and the wait resumes, which
        gives lineage resubmission time to regenerate the object."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            stored = self.store.get_stored(oid, timeout=0)
            if stored is not None:
                return stored
            if self.controller.has_location(oid):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                stored = self._pull_remote(oid, timeout=remaining)
                if stored is not None:
                    return stored
                # a failed pull no longer guarantees a location was
                # dropped (semaphore/budget/dedup-join timeouts keep
                # them by design): honour the caller's deadline here
                # or contention turns this loop into a busy spin
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                continue                 # stale location dropped; retry
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                return None
            ev = threading.Event()
            self.waiters.add_get(oid, lambda w, to: ev.set(), remaining)
            ev.wait(None if remaining is None else remaining + 1)
            if deadline is not None and time.monotonic() > deadline:
                # one last probe: the seal may have raced the deadline
                stored = self.store.get_stored(oid, timeout=0)
                if stored is not None:
                    return stored
                if not self.controller.has_location(oid):
                    return None

    def _head_pull_sources(self, oid: str, prefer=None):
        """Pull-manager source iterator: every alive agent holding a
        copy, over its existing control connection (shuffled for load
        spread). Dead / in-process locations are dropped from the
        directory as they are encountered — same stale-location
        hygiene the pre-pull-manager loop had."""
        import random
        nids = self.controller.locations(oid)
        random.shuffle(nids)
        for nid in nids:
            rec = self.cluster.get_node(nid)
            if rec is None or not rec.alive:
                self.controller.remove_location(oid, nid)
                continue
            conn = getattr(rec.scheduler, "conn", None)
            if conn is None:   # local in-process node: nothing to pull
                self.controller.remove_location(oid, nid)
                continue
            yield (nid, conn)

    def _pull_remote(self, oid: str,
                     timeout: Optional[float] = None
                     ) -> Optional[StoredObject]:
        """Pull one object from any alive agent holding it, through the
        head's pull manager (dedup: N parked getters of one object cost
        one transfer; bounded in-flight bytes); caches the bytes in the
        head store (LRU/spill governs them from there). Returns None
        once every registered location proved stale. `timeout` bounds
        this attempt to the caller's remaining budget (default 30s for
        deadline-less gets, so a single attempt can't park forever)."""
        if timeout is None:
            timeout = 30.0
        return self._pull_mgr.pull(oid, timeout=max(0.1, timeout))

    def broadcast_object(self, object_id: str,
                         fanout: Optional[int] = None,
                         timeout: Optional[float] = None) -> dict:
        """Distribute one object to every alive node in a fanout tree
        (the source serves <= fanout transfers; each completed puller
        serves its subtree). Returns the tree/completion stats."""
        return self.bcast.broadcast(object_id, fanout=fanout,
                                    timeout=timeout)

    def _object_plane_stats(self) -> dict:
        """Object-plane observability: head counters + per-node
        heartbeat-carried counters + directory/broadcast state."""
        from ray_tpu_torch._private.object_transfer import OBJECT_PLANE_STATS
        nodes = {}
        for n in self.cluster.alive_nodes():
            op = getattr(n.scheduler, "object_plane", None)
            if op:
                nodes[n.node_id] = dict(op)
        return {
            "head": {
                **OBJECT_PLANE_STATS,
                "sessions": self._pull_server.session_count(),
                "serves_per_object":
                    self._pull_server.serves_per_object(),
                **{"pull_" + k: v
                   for k, v in self._pull_mgr.stats().items()},
            },
            "nodes": nodes,
            "directory": self.controller.directory.stats(),
            "broadcast": self.bcast.stats(),
        }

    # ================= tracing plane: collection =================
    def _trace_dump(self, timeout: float = 5.0) -> dict:
        """Drain every process's flight recorder: the head's own, each
        local worker's, and each agent's (the agent fans out to ITS
        workers and replies with the whole node). Pull, not push —
        heartbeats only carry watermarks. Peer timestamps are aligned
        onto the head's monotonic clock via the request/reply RTT
        midpoint (tracing_plane.rtt_offset); an agent's workers are
        aligned transitively (their offsets are relative to the
        agent)."""
        procs = [dict(_tp.dump(), offset_ns=0,
                      node_id=self.head_node_id)]
        targets: list[tuple] = []    # ((kind, node_id), connection)
        sched = self.scheduler
        if sched is not None:
            for wid, conn in sched.worker_conns():
                targets.append((("worker", self.head_node_id), conn))
        for node in self.cluster.alive_nodes():
            conn = getattr(node.scheduler, "conn", None)
            # an agent that negotiated MINOR < 2 silently drops the
            # unknown TRACE_DUMP type and would burn the shared
            # deadline waiting for a reply that can never come
            if conn is not None and conn._peer_speaks_trace():
                targets.append((("agent", node.node_id), conn))
        for (kind, nid), t0, t1, rep in _tp.fanout_dumps(
                targets, timeout, extra={"timeout": timeout}):
            if kind == "worker":
                d = rep.get("dump")
                if d:
                    procs.append(dict(
                        d, node_id=nid,
                        offset_ns=_tp.rtt_offset(t0, t1, d["now_ns"])))
            else:
                # the agent re-samples its clock just before replying
                # (now_ns field), AFTER its worker drain — an RTT-
                # midpoint estimate over the whole exchange would be
                # skewed by however long that drain took
                if "now_ns" in rep:
                    agent_off = int(rep["now_ns"]) - t1
                else:
                    agent_off = None
                for d in rep.get("processes") or ():
                    if agent_off is None:   # agent's own dump is first
                        agent_off = _tp.rtt_offset(
                            t0, t1, d.get("now_ns", 0))
                    procs.append(dict(
                        d, node_id=nid,
                        offset_ns=(int(d.get("offset_ns", 0))
                                   + agent_off)))
        return {"processes": procs}

    # ================= metrics plane: collection =================
    def _sample_metrics(self) -> None:
        """Head sampler: mirror per-agent delegated-lease ledgers and
        the head's pull-manager/pull-server occupancy into gauges.
        set_many REPLACES the series set, so a removed node's labeled
        gauges drop from the head's own registry immediately."""
        m = _mp._metrics()
        out, batches, leased, revoked = [], [], [], []
        for n in self.cluster.alive_nodes():
            h = n.scheduler
            if not hasattr(h, "_leased"):
                continue                     # in-process local node
            with h._lock:
                out.append(({"node": n.node_id}, float(len(h._leased))))
            batches.append(({"node": n.node_id}, float(h._leases_sent)))
            leased.append(({"node": n.node_id}, float(h._tasks_leased)))
            revoked.append(({"node": n.node_id}, float(
                (h.delegate_stats or {}).get("revoked", 0))))
        m.lease_outstanding.set_many(out)
        m.lease_batches.set_many(batches)
        m.lease_tasks.set_many(leased)
        m.lease_revoked.set_many(revoked)
        pm = self._pull_mgr.stats()
        m.pull_inflight.set(pm["inflight"])
        m.pull_inflight_bytes.set(pm["inflight_bytes"])
        if self._ha is not None:
            # r15 head-HA gauges: WAL volume, fsync tail latency,
            # snapshot staleness, replayed-completion accounting
            st = self._ha.stats()
            wal = st["wal"]
            rows = [({"counter": "wal_bytes"}, float(wal["bytes"])),
                    ({"counter": "wal_records"}, float(wal["records"])),
                    ({"counter": "wal_fsyncs"}, float(wal["fsyncs"])),
                    ({"counter": "compactions"},
                     float(wal["compactions"])),
                    ({"counter": "replayed_completions"}, float(
                        st["recovered"]["replayed_completions"])),
                    ({"counter": "deduped_completions"}, float(
                        st["recovered"]["deduped_completions"]))]
            if wal["fsync_p99_ms"] is not None:
                rows.append(({"counter": "fsync_p99_ms"},
                             float(wal["fsync_p99_ms"])))
            if st["last_snapshot_age_s"] is not None:
                rows.append(({"counter": "last_snapshot_age_s"},
                             float(st["last_snapshot_age_s"])))
            m.head_wal.set_many(rows)
        # r16: striped-table occupancy/contention + decref-delta
        # application counters — the sharding win observable, not
        # just benchable
        rows = []
        for table, st in self.controller.shard_stats().items():
            for k in ("entries", "max_stripe", "contended", "evicted"):
                if k in st:
                    rows.append(({"table": table, "counter": k},
                                 float(st[k])))
        m.head_shard.set_many(rows)
        m.decref_delta.set_many(
            [({"counter": "head_" + k}, float(v))
             for k, v in self._decref_delta_stats.items()])
        # r18 direct actor plane: head-process caller/host counters
        # plus each agent's heartbeat-carried host counters
        rows = [({"party": "head", "counter": k}, float(v))
                for k, v in self._direct_stats.items()]
        for n in self.cluster.alive_nodes():
            for k, v in (getattr(n.scheduler, "direct_stats", None)
                         or {}).items():
                rows.append(({"party": "node:" + n.node_id,
                              "counter": k}, float(v)))
        m.direct_actor.set_many(rows)
        # r17 membership plane: per-node liveness (one-hot by state) +
        # last-heartbeat age, plus fence/suspicion transition counters
        lv = self.cluster.liveness_stats()
        m.node_liveness.set_many(
            [({"node": row["node_id"], "state": row["state"]}, 1.0)
             for row in lv["nodes"]])
        m.node_heartbeat_age.set_many(
            [({"node": row["node_id"]},
              float(row["last_heartbeat_age_s"]))
             for row in lv["nodes"]])
        m.membership.set_many(
            [({"counter": k}, float(v))
             for k, v in {**lv["counters"],
                          **self._fence_stats}.items()])

    def _trace_stats(self) -> dict:
        rec = _tp.recorder()
        nodes = {}
        for n in self.cluster.alive_nodes():
            wm = getattr(n.scheduler, "trace_watermark", None)
            if wm is not None:
                nodes[n.node_id] = wm
        return {"enabled": _tp.enabled(),
                "head": {"watermark": rec.watermark(),
                         "capacity": rec.capacity,
                         "dropped": rec.dropped()},
                "nodes": nodes}

    def _delete_everywhere(self, oid: str) -> None:
        """Deletion fan-out: local store + every agent holding a copy.
        Releases the counts this object held on refs pickled inside it
        (nested-ref ownership), cascading deletes as counts hit zero."""
        self.store.delete(oid)
        for cid in self.controller.pop_contained(oid):
            self.decref(cid)
        locs = self.controller.locations(oid)
        for nid in locs:
            rec = self.cluster.get_node(nid)
            conn = getattr(rec.scheduler, "conn", None) if rec else None
            if conn is not None:
                try:
                    conn.send({"type": protocol.NODE_DELETE_OBJECT,
                               "object_id": oid})
                except protocol.ConnectionClosed:
                    pass
        if locs:
            self.controller.remove_location(oid)
        self.controller.drop_lineage(oid)

    def on_node_objects_lost(self, node_id: str) -> None:
        """Lineage reconstruction (reference task_manager.h:269
        ResubmitTask + object_recovery_manager.h:41): objects whose ONLY
        copy died with `node_id` and are still referenced get their
        producing task resubmitted. Single-level: if the resubmitted
        task's own args were also lost, their gets re-enter this path
        when their holders' deaths are processed."""
        from ray_tpu_torch._private.config import CONFIG as _C
        orphaned = self.controller.purge_node_locations(node_id)
        resubmitted: set[str] = set()
        for oid in orphaned:
            if self.controller.unreferenced(oid):
                self.controller.drop_lineage(oid)
                continue
            spec = self.controller.lineage_for(oid)
            if spec is None or spec.task_id in resubmitted:
                continue
            n = getattr(spec, "lineage_resubmits", 0)
            if n >= _C.lineage_max_resubmits:
                continue
            spec.lineage_resubmits = n + 1
            resubmitted.add(spec.task_id)
            bump_attempt(spec)
            # back on the live books: the regenerating execution must
            # survive a head restart too
            self.controller.task_submitted(spec)
            self.controller.record_task_event(
                spec.task_id, spec.name, "RESUBMITTED",
                error=f"lost output {oid} on {node_id}")
            for pid in spec.pinned_refs:
                self.controller.pin(pid)
            self.cluster.submit(spec)

    def _on_wait(self, conn: protocol.Connection, msg: dict) -> None:
        ids, num_returns = msg["object_ids"], msg["num_returns"]
        ready_now = [o for o in ids if self.store.contains(o)]
        if len(ready_now) >= num_returns:
            conn.reply(msg, ready=ready_now[:num_returns])
            return
        wid = conn.meta.get("worker_id")
        wsched = self._sched_for_conn(conn)
        if wsched is not None:
            wsched.worker_blocked(wid)

        def reply(w, ready: list[str]) -> None:
            try:
                conn.reply(msg, ready=ready[:num_returns])
            except protocol.ConnectionClosed:
                pass

        self.waiters.add_wait(
            ids, num_returns, reply, msg.get("timeout"),
            on_done=((lambda: wsched.worker_unblocked(wid))
                     if wsched is not None else None))

    def _kv_dispatch(self, msg: dict) -> Any:
        op = msg["op"]
        ns = msg.get("namespace", "default")
        key = msg.get("key", "")
        if op == "get":
            return self.controller.kv_get(key, ns)
        if op == "put":
            return self.controller.kv_put(key, msg.get("value"), ns,
                                          msg.get("overwrite", True))
        if op == "del":
            return self.controller.kv_del(key, ns)
        if op == "exists":
            return self.controller.kv_exists(key, ns)
        if op == "keys":
            return self.controller.kv_keys(key, ns)
        if op == "func_get":
            return self.controller.get_function(key)
        raise ValueError(f"unknown kv op {op}")

    # ================= BaseContext API (driver) =================
    def put(self, value: Any) -> ObjectRef:
        from ray_tpu_torch._private.object_store import serialize
        stored = serialize(value)
        self._seal_contained(stored.object_id, stored.contained_ids)
        # driver thread: safe to apply create-queueing backpressure
        self.store.put_stored(stored, block=True)
        self.controller.addref(stored.object_id)
        return ObjectRef(stored.object_id)

    def get_objects(self, object_ids: list[str],
                    timeout: Optional[float]) -> list[Any]:
        deadline = None if timeout is None else time.time() + timeout
        out = []
        for oid in object_ids:
            remaining = None if deadline is None else max(
                0.0, deadline - time.time())
            stored = self._get_stored_anywhere(oid, remaining)
            if stored is None:
                raise GetTimeoutError(
                    f"get() timed out waiting for {oid}")
            try:
                value = deserialize(stored)
            except FileNotFoundError:
                # The spill policy unlinked this object's shm between
                # get_stored and the map (rare: touch-grace usually
                # prevents it). The data lives in the spill file —
                # re-fetch; the restore comes back with inline buffers.
                stored = self._get_stored_anywhere(oid, remaining)
                if stored is None:
                    raise GetTimeoutError(
                        f"get() timed out waiting for {oid}")
                value = deserialize(stored)
            if stored.is_error:
                raise value
            out.append(value)
        return out

    def wait(self, object_ids: list[str], num_returns: int,
             timeout: Optional[float]) -> tuple[list[str], list[str]]:
        """Registry-based wait spanning local residency AND remote
        locations. Contract: at most num_returns ready, input order."""
        result: list[list[str]] = []
        ev = threading.Event()

        def reply(w, ready: list[str]) -> None:
            result.append(ready)
            ev.set()

        self.waiters.add_wait(object_ids, num_returns, reply, timeout)
        ev.wait(None if timeout is None else timeout + 5)
        ready_list = (result[0] if result else [])[:num_returns]
        taken = set(ready_list)
        not_ready = [o for o in object_ids if o not in taken]
        return ready_list, not_ready

    def addref(self, object_id: str) -> None:
        self.controller.addref(object_id)

    def decref(self, object_id: str) -> None:
        if self._shutdown:
            return
        if self.controller.decref(object_id):
            self._delete_everywhere(object_id)

    def decref_batch(self, object_ids: list[str]) -> None:
        """Batched release (head-local workers' DECREF_BATCH and the
        driver's own flusher): counts apply per shard — one stripe
        lock per shard, not one controller lock per release (r16)."""
        if self._shutdown or not object_ids:
            return
        counts: dict[str, int] = {}
        for oid in object_ids:
            counts[oid] = counts.get(oid, 0) + 1
        for oid in self.controller.apply_decref_delta("", 0, counts) or ():
            self._delete_everywhere(oid)

    def _on_decref_delta(self, msg: dict) -> None:
        """NODE_DECREF_DELTA (r16): a delegated agent's coalesced
        release counts. The controller's per-node seq watermark drops
        replayed frames (rejoin replay after a head restart or
        reconnect) so no release is ever applied twice."""
        counts = msg.get("counts") or {}
        dead = self.controller.apply_decref_delta(
            msg.get("node_id", ""), int(msg.get("seq", 0)), counts)
        st = self._decref_delta_stats
        if dead is None:
            st["deduped_frames"] += 1
            return
        st["frames"] += 1
        st["entries"] += len(counts)
        if not self._shutdown:
            for oid in dead:
                self._delete_everywhere(oid)

    # ---- tracing plane (r9) ----
    def _stamp_trace(self, spec) -> Optional[tuple]:
        """Open the spec's submit span: join the caller's active trace
        (or the trace a relaying worker already stamped on the spec;
        else — when the sampler elects this root submission,
        RAY_TPU_TRACE_SAMPLE — start a fresh one) and point the spec's
        parent_span at this span, so downstream scheduler/worker spans
        chain under it. The decision here is the WHOLE decision (r16):
        an unsampled spec keeps trace_id 0, so every downstream
        emission site (scheduler queue/lease, agent, worker recv/exec/
        put, pull manager, done) skips its span and its frames carry
        zero trace bytes — whole-or-nothing across processes, exactly
        the RAY_TPU_TRACE=0 byte shape. Returns (trace_id, span_id,
        parent, t0_ns) for _record_submit, or None when tracing is off
        or this task is unsampled."""
        if not _tp.enabled():
            return None
        tid = getattr(spec, "trace_id", 0)   # pre-r9-pickled specs
        if tid:                              # have no trace fields
            parent = getattr(spec, "parent_span", 0)   # relayed
        else:
            cur = _tp.current()
            if cur:
                tid, parent = cur[0], cur[1]   # nested: inherit
            elif _tp.sample():
                tid, parent = _tp.new_id(), 0  # sampled root
            else:
                return None                    # unsampled: no trace
            spec.trace_id = tid
        sid = _tp.new_id()
        spec.parent_span = sid
        return (tid, sid, parent, _tp.now())

    @staticmethod
    def _record_submit(tr: Optional[tuple], spec) -> None:
        if tr is not None:
            tid, sid, parent, t0 = tr
            _tp.record("submit", spec.name or spec.task_id, t0,
                       _tp.now(), tid, sid, parent)

    @staticmethod
    def _record_done(msg: dict, t0: Optional[int]) -> None:
        """TASK_DONE-processing span, parented under the worker's exec
        span via the envelope-carried trace context."""
        if t0 is None:
            return
        tr = msg.get("_trace")
        if tr:
            _tp.record("done", msg.get("name", "") or
                       str(msg.get("task_id", "")), t0, _tp.now(),
                       tr[0], _tp.new_id(), tr[1])

    def submit_spec(self, spec: TaskSpec) -> list[str]:
        tr = self._stamp_trace(spec)
        _mp.submit_stamp(spec)
        for oid in spec.pinned_refs:
            self.controller.pin(oid)
        # lineage + live-task entry + ONE WAL submit record (r15): a
        # restarted head re-owns this task from here
        self.controller.task_submitted(spec)
        self.controller.record_task_event(spec.task_id, spec.name, "PENDING")
        self.cluster.submit(spec)
        self._record_submit(tr, spec)
        return spec.return_ids

    submit_task = submit_spec

    def register_function(self, func_id: str, data: bytes) -> None:
        self.controller.put_function(func_id, data)

    # ---- actors ----
    def _actor_state(self, actor_id: str) -> _ActorState:
        with self._actor_lock:
            st = self._actor_states.get(actor_id)
            if st is None:
                st = self._actor_states[actor_id] = _ActorState()
            return st

    def create_actor_from_spec(self, spec: ActorSpec) -> str:
        # the constructor's refs stay pinned for the actor's life: a
        # restart resolves them again (released in _release_actor_refs)
        for oid in spec.pinned_refs:
            self.controller.pin(oid)
        self.controller.register_actor(spec)
        self._actor_state(spec.actor_id)
        self.cluster.submit(spec)
        return spec.actor_id

    create_actor = create_actor_from_spec

    def submit_actor_task_spec(self, actor_id: str,
                               spec: ActorTaskSpec,
                               register_borrows: bool = True
                               ) -> list[str]:
        # register_borrows: the driver-as-caller registers its return-
        # id borrows here (in-process, free). Wire-relayed submissions
        # pass False — their caller already addref'd eagerly on the
        # head-routed path.
        if register_borrows:
            for oid in spec.return_ids:
                self.controller.addref(oid)
        _mp.submit_stamp(spec)
        tr = self._stamp_trace(spec)
        try:
            return self._submit_actor_task_inner(actor_id, spec)
        finally:
            self._record_submit(tr, spec)

    def _submit_actor_task_inner(self, actor_id: str,
                                 spec: ActorTaskSpec) -> list[str]:
        for oid in spec.pinned_refs:
            self.controller.pin(oid)
        rec = self.controller.get_actor(actor_id)
        if rec is None:
            self._store_error(spec.return_ids, TaskError(
                ActorError(actor_id, "unknown actor"), task_name=spec.name))
            return spec.return_ids
        st = self._actor_state(actor_id)
        with st.lock:
            if rec.state == DEAD:
                self._store_error(spec.return_ids, TaskError(
                    ActorDiedError(actor_id,
                                   f"Actor {actor_id} is dead: "
                                   f"{rec.death_cause}"),
                    task_name=spec.name))
                return spec.return_ids
            # queued-not-empty implies an ordering predecessor (an
            # undeliverable requeue or a direct-path fallback) still
            # waiting: append BEHIND it even while ALIVE, or this call
            # would overtake it (per-handle submission order)
            self._stamp_order(st, spec)
            if (rec.state != ALIVE or rec.worker_id is None
                    or st.queued):
                was_alive = rec.state == ALIVE and st.queued
                st.queued.append(spec)
                if not was_alive:
                    return spec.return_ids
            else:
                # sticky direct fallback clears once every book is
                # empty: all prior calls reached a terminal state, so
                # a fresh direct call cannot overtake anything
                if (st.fallback and not st.inflight
                        and not st.direct_inflight):
                    st.fallback = False
                spec._route = "direct"   # tentative: the routability
                                         # probe must not see this
                                         # spec as a head predecessor
                st.inflight[spec.task_id] = spec
                claim = st.epoch
                target = rec.worker_id
                use_direct = (not st.fallback
                              and self._direct_routable(rec, st))
                was_alive = False
        if was_alive:                   # appended behind the queue
            self._flush_actor_queue(actor_id)
            return spec.return_ids
        if use_direct and self._try_direct_actor_call(rec, st, spec):
            return spec.return_ids
        spec._route = "head"
        if not self._send_actor_task(target, spec):
            with st.lock:
                # Requeue only if a concurrent _recover_actor didn't
                # already claim it (epoch check): recovery may have
                # requeued AND re-sent this spec already — a blind pop
                # here silently dropped the call (r18 satellite fix).
                if st.epoch != claim:
                    self._direct_stats["send_race_kept"] += 1
                elif st.inflight.pop(spec.task_id, None) is not None:
                    self._requeue_in_order(st, spec)
        return spec.return_ids

    submit_actor_task = submit_actor_task_spec

    def _send_actor_task(self, worker_id: str, spec: ActorTaskSpec) -> bool:
        # load-independent signal for bench_core: every head-routed
        # actor-task send counts (direct-path calls never come here)
        self._direct_stats["head_routed_sends"] += 1
        sched = self._scheduler_for_worker(worker_id)
        if sched is None:
            return False
        return sched.send_actor_task(worker_id, spec)

    def _flush_actor_queue(self, actor_id: str) -> None:
        rec = self.controller.get_actor(actor_id)
        if rec is None or rec.state != ALIVE:
            return
        st = self._actor_state(actor_id)
        while True:
            with st.lock:
                if not st.queued:
                    return
                spec = st.queued.pop(0)
                st.inflight[spec.task_id] = spec
                claim = st.epoch
                target = rec.worker_id
            spec._route = "head"
            if not self._send_actor_task(target, spec):
                with st.lock:
                    # same claim discipline as the submit path: a
                    # recovery sweep between the send failure and this
                    # repop already owns the spec
                    if st.epoch != claim:
                        self._direct_stats["send_race_kept"] += 1
                    elif st.inflight.pop(spec.task_id,
                                         None) is not None:
                        self._requeue_in_order(st, spec)
                return

    # ---- per-handle ordering helpers (r18) ----
    @staticmethod
    def _stamp_order(st, spec) -> None:
        """Assign the actor's next submission-order stamp (caller
        holds st.lock). Idempotent: a re-placed spec keeps its
        original position."""
        if getattr(spec, "_order", None) is None:
            spec._order = st.next_order
            st.next_order += 1

    @staticmethod
    def _requeue_in_order(st, spec) -> None:
        """Insert a re-placed spec into st.queued by its submission
        stamp (caller holds st.lock): requeues arrive from multiple
        sources (direct NACK fallbacks, undeliverable events, recovery
        sweeps) whose processing order is not submission order."""
        import bisect
        keys = [getattr(s, "_order", 0) for s in st.queued]
        i = bisect.bisect(keys, getattr(spec, "_order", 0))
        st.queued.insert(i, spec)

    # ---- direct actor call plane (r18) ----
    def _direct_routable(self, rec, st) -> bool:
        """Whether the driver may dial this actor's host directly:
        config on, the actor lives on a REMOTE healthy node whose
        agent speaks wire MINOR >= 8, and every in-flight call for the
        handle is itself direct (a head-routed call still in transit
        must not be overtaken). Caller holds st.lock."""
        from ray_tpu_torch._private.config import CONFIG as _C
        if not _C.direct_actor:
            return False
        if rec.node_id in (None, self.head_node_id):
            return False          # head-local: already zero-hop here
        node = self.cluster.get_node(rec.node_id)
        if node is None or not node.alive or node.suspect:
            return False
        handle = node.scheduler
        conn = getattr(handle, "conn", None)
        if (conn is None or getattr(handle, "draining", False)
                or not conn.peer_speaks_direct_actor()):
            return False
        return all(getattr(s, "_route", "") == "direct"
                   for s in st.inflight.values())

    def _direct_conn(self, addr: tuple) -> Optional[protocol.Connection]:
        from ray_tpu_torch._private import direct_actor as _da
        return _da.dial_cached(self._direct_conns, self._direct_lock,
                               addr, poller=self._poller)

    def _try_direct_actor_call(self, rec, st, spec) -> bool:
        """Driver-as-caller: stream the call straight to the hosting
        agent's listener; the reply (inline results / located hints)
        lands on the dialed connection and seals into the head store
        in-process — zero head control-plane frames in steady state.
        The spec is already claimed in st.inflight; False falls back
        to the head-routed send."""
        node = self.cluster.get_node(rec.node_id)
        handle = node.scheduler if node else None
        addr = getattr(handle, "advertise_addr", None)
        if not addr:
            return False
        # worker-direct when the worker's listener is known (heartbeat
        # rows); agent-hosted otherwise — same preference as resolve,
        # but never switch endpoints while other calls are in flight
        wport = handle.direct_port_of(rec.worker_id)
        want = (addr[0], int(wport or addr[1]))
        with self._direct_lock:
            prev = self._direct_actor_addr.get(spec.actor_id)
        if prev is not None and prev != want:
            with st.lock:
                if len(st.inflight) > 1:      # beyond this spec
                    want = prev               # quiet moments only
        with self._direct_lock:
            self._direct_actor_addr[spec.actor_id] = want
        conn = self._direct_conn(want)
        if conn is not None:
            # chaos rules match by peer node id: a partition of the
            # node must park this plane's frames too
            conn.meta.setdefault("chaos_peer", rec.node_id)
        if conn is None:
            return False
        spec._route = "direct"
        msg = {"type": protocol.ACTOR_TASK_DIRECT, "spec": spec,
               "actor_id": spec.actor_id, "worker_id": rec.worker_id,
               "epoch": rec.num_restarts,
               "node_incarnation": handle.incarnation}
        if _tp.enabled() and getattr(spec, "trace_id", 0):
            sid = _tp.new_id()
            t0 = _tp.now()
            _tp.record("direct", "send", t0, t0, spec.trace_id, sid,
                       getattr(spec, "parent_span", 0),
                       {"node": rec.node_id})
            spec.parent_span = sid
            msg["_trace"] = (spec.trace_id, sid)
        try:
            fut = conn.request_async(msg)
        except protocol.ConnectionClosed:
            spec._route = "head"
            return False
        self._direct_stats["direct_calls"] += 1
        node_id = rec.node_id
        fut.add_done_callback(
            lambda f: self._on_direct_reply(node_id, st, spec, f))
        return True

    def _on_direct_reply(self, node_id: str, st, spec, fut) -> None:
        try:
            rep = fut.result(timeout=0)
        except BaseException:
            self._direct_fail(st, spec, started=True)
            return
        if rep.get("redirect"):
            self._direct_fail(st, spec,
                              started=bool(rep.get("started")))
            return
        with st.lock:
            if st.inflight.pop(spec.task_id, None) is None:
                # recovery (node death / restart) already claimed this
                # call and re-placed or errored it: first terminal
                # wins — the late reply is dropped whole, results and
                # all, exactly like a stale-attempt NODE_TASK_DONE
                self._direct_stats["stale_replies"] += 1
                return
        self._direct_stats["direct_replies"] += 1
        error = bool(rep.get("error"))
        for stored in rep.get("inline", ()):
            self._seal_contained(stored.object_id, stored.contained_ids)
            self.store.put_stored(stored)
            self._direct_stats["inline_bytes"] += stored.nbytes
            if self.controller.unreferenced(stored.object_id):
                self._delete_everywhere(stored.object_id)
        for oid, nbytes, host_nid, contained in rep.get("located", ()):
            self._seal_contained(oid, contained)
            self.controller.add_location(oid, host_nid or node_id,
                                         nbytes)
            self.waiters.notify(oid)
        self._unpin(spec.pinned_refs)
        _mp.observe_task_done(spec, node_id)
        if _tp.enabled() and getattr(spec, "trace_id", 0):
            t1 = _tp.now()
            _tp.record("direct", "reply:" + (spec.name or ""), t1, t1,
                       spec.trace_id, _tp.new_id(),
                       getattr(spec, "parent_span", 0))
        self.controller.record_task_event(
            spec.task_id, spec.name, "FAILED" if error else "FINISHED")

    def _direct_fail(self, st, spec, started: bool) -> None:
        """A direct call NACKed (stale endpoint, fenced/disconnected
        host) or its connection died. Flip the actor to sticky head-
        routed fallback and route THIS call through the head's own
        semantics: a provably-undelivered call requeues free (the
        actor_task_undeliverable rule); an ambiguous one charges the
        retry budget (the worker-died-inflight rule). The budget is
        GATED here but not consumed: the head-routed re-execution this
        fallback hands the call to charges any subsequent loss through
        its own machinery (undeliverable requeues free, worker-death
        recovery charges) — consuming it here too double-charged one
        worker death (NACK + recovery) and errored calls that still
        had budget."""
        self._direct_stats["redirects"] += 1
        with st.lock:
            st.fallback = True
            if st.inflight.pop(spec.task_id, None) is None:
                self._direct_stats["stale_replies"] += 1
                return               # recovery already owns this call
            retry = (not started
                     or spec.retries_used < spec.max_retries)
            if retry:
                self._requeue_in_order(st, spec)
        if not retry:
            self._store_error(spec.return_ids, TaskError(
                ActorError(spec.actor_id,
                           "direct actor call failed (worker died or "
                           "endpoint fenced); no retries left"),
                task_name=spec.name))
            self._unpin(spec.pinned_refs)
            self.controller.record_task_event(
                spec.task_id, spec.name, "FAILED",
                error="direct call failed")
            return
        self._flush_actor_queue(spec.actor_id)

    def _resolve_actor_endpoint(self, actor_id: str) -> dict:
        """ACTOR_RESOLVE: the actor's direct endpoint for a remote
        caller — hosting listener address, worker id, restart epoch,
        node incarnation — or direct=False when the call must stay
        head-routed (actor pending/queued, node suspect/draining/old-
        wire, head bound to a wildcard address)."""
        from ray_tpu_torch._private.config import CONFIG as _C
        self._direct_stats["resolves"] += 1
        if not _C.direct_actor:
            return {"direct": False, "state": "disabled"}
        rec = self.controller.get_actor(actor_id)
        if rec is None or rec.state == DEAD:
            return {"direct": False, "state": "dead",
                    "cause": (rec.death_cause if rec else
                              "unknown actor")}
        st = self._actor_states.get(actor_id)
        if st is not None:
            with st.lock:
                if st.queued or any(
                        getattr(s, "_route", "") != "direct"
                        for s in st.inflight.values()):
                    # a queued backlog or an in-flight head-routed
                    # call owns the ordering: a direct call resolved
                    # now could overtake it on the wire. Once both
                    # books are clear of head-routed work, every
                    # earlier call has EXECUTED at the host, so the
                    # caller's stream cannot reorder against them.
                    return {"direct": False, "state": "queued"}
        if rec.state != ALIVE or rec.worker_id is None:
            return {"direct": False, "state": "pending"}
        if rec.node_id in (None, self.head_node_id):
            host = self.address[0]
            if host in ("0.0.0.0", "::", ""):
                return {"direct": False, "state": "head_wildcard"}
            # worker-direct when the local worker's listener is known;
            # the head's own listener (head-as-host) otherwise
            sched = self.scheduler
            wport = (sched.direct_port_of(rec.worker_id)
                     if sched is not None else None)
            return {"direct": True, "host": host,
                    "port": int(wport or self.address[1]),
                    "worker_id": rec.worker_id,
                    "node_id": self.head_node_id,
                    "epoch": rec.num_restarts, "incarnation": None}
        node = self.cluster.get_node(rec.node_id)
        handle = node.scheduler if node else None
        conn = getattr(handle, "conn", None)
        if (node is None or not node.alive or node.suspect
                or conn is None
                or getattr(handle, "draining", False)
                or not conn.peer_speaks_direct_actor()):
            return {"direct": False, "state": "no_route"}
        addr = handle.advertise_addr
        # prefer the WORKER's own serving socket (caller -> worker ->
        # caller, no agent hop); its port rides the agent's heartbeat
        # worker rows — until a beat carries it, the agent listener
        # hosts the calls (one extra local hop, still head-free)
        wport = handle.direct_port_of(rec.worker_id)
        return {"direct": True, "host": addr[0],
                "port": int(wport or addr[1]),
                "worker_id": rec.worker_id, "node_id": rec.node_id,
                "epoch": rec.num_restarts,
                "incarnation": handle.incarnation,
                # agent-hosted because the worker's port hasn't ridden
                # a heartbeat yet: the caller may re-resolve later (at
                # a quiet moment) to upgrade to the worker's socket
                "provisional": wport is None}

    def _on_actor_task_direct(self, conn: protocol.Connection,
                              msg: dict) -> None:
        """Head-as-host: a remote caller direct-dialed the head for an
        actor living on the head node. Validate the endpoint is still
        current, forward over the worker's connection, and remember
        the caller — the worker's TASK_DONE answers it inline."""
        from ray_tpu_torch._private import direct_actor as _da
        from ray_tpu_torch._private.config import CONFIG as _C
        spec: ActorTaskSpec = msg["spec"]
        actor_id = msg["actor_id"]
        wid = msg["worker_id"]
        rec = self.controller.get_actor(actor_id)
        reason = None
        if not _C.direct_actor:
            reason = "disabled"
        elif (rec is None or rec.state != ALIVE
              or rec.worker_id != wid
              or rec.node_id not in (None, self.head_node_id)
              or int(msg.get("epoch", -1)) != rec.num_restarts):
            reason = "stale_endpoint"
        if reason is None:
            self._direct_pending.add(spec.task_id, conn,
                                     msg.get("rid"), wid)
            if self._send_actor_task(wid, spec):
                self._direct_stats["served"] += 1
                return
            self._direct_pending.pop(spec.task_id)
            reason = "send_failed"
        self._direct_stats["nacks"] += 1
        _da.nack(conn, msg.get("rid"), reason, False)

    def _reply_direct_done(self, ent: tuple, msg: dict,
                           results: list) -> None:
        """Head-as-host completion: results already sealed into the
        head store (the owner-side copy every getter resolves
        against); answer the dialed caller with inline copies of the
        small ones. Large results stay head-resident — the caller's
        get() falls through to the ordinary pull path."""
        from ray_tpu_torch._private.config import CONFIG as _C
        from ray_tpu_torch._private.object_transfer import materialize
        conn, rid, _wid = ent
        inline = []
        for stored in results:
            if (stored.nbytes <= _C.remote_inline_max_bytes
                    or stored.is_error):
                m = materialize(stored)
                inline.append(m)
                self._direct_stats["served_bytes"] += m.nbytes
        try:
            conn.reply({"rid": rid}, inline=inline, located=[],
                       error=bool(msg.get("error")),
                       error_repr=msg.get("error_repr"))
        except protocol.ConnectionClosed:
            pass          # caller died; the store keeps the results

    def _on_actor_inflight_delta(self, conn: protocol.Connection,
                                 msg: dict) -> None:
        """Coalesced direct-call mirror from a remote caller (the r16
        decref-delta pattern). Adds park the spec (and pin its args)
        so actor death/restart still errors/requeues in-flight direct
        calls; dones release pins and register holder-side result
        locations; fail entries route NACKed calls through the head's
        retry machinery. First terminal wins: a done/fail whose entry
        was already claimed (recovery ran) is dropped whole."""
        self._direct_stats["delta_frames"] += 1
        caller = msg.get("caller")
        for actor_id, spec in msg.get("adds", ()):
            self._direct_stats["delta_adds"] += 1
            with self._direct_lock:
                if spec.task_id in self._direct_done_ring:
                    # head-as-host already answered this call inline
                    # (and recorded its terminal event) before the
                    # caller's coalesced add arrived: a late add would
                    # pin args forever and park a phantom entry the
                    # next recovery sweep re-errors
                    continue
            rec = self.controller.get_actor(actor_id)
            st = self._actor_state(actor_id)
            with st.lock:
                if rec is None or rec.state == DEAD:
                    dead_cause = (rec.death_cause if rec
                                  else "unknown actor")
                else:
                    spec._direct_caller = caller
                    self._stamp_order(st, spec)
                    st.direct_inflight[spec.task_id] = spec
                    dead_cause = None
            if dead_cause is not None:
                # the caller's direct conn may be wedged on a dead
                # host; its fallback get() resolves this error
                self._store_error(spec.return_ids, TaskError(
                    ActorDiedError(actor_id,
                                   f"Actor {actor_id} is dead: "
                                   f"{dead_cause}"),
                    task_name=spec.name))
                continue
            for oid in spec.pinned_refs:
                self.controller.pin(oid)
        for ent in msg.get("dones", ()):
            self._direct_stats["delta_dones"] += 1
            self._apply_direct_done_entry(ent)

    def _apply_direct_done_entry(self, ent: dict) -> None:
        actor_id = ent["actor_id"]
        task_id = ent["task_id"]
        st = self._actor_states.get(actor_id)
        if st is None:
            return
        with st.lock:
            spec = st.direct_inflight.pop(task_id, None)
        if spec is None:
            with self._fence_lock:
                self._fence_stats["stale_attempt_drops"] += 1
            return                    # recovery already owned it
        if ent.get("retract"):
            # the caller's direct send never left its process: just
            # undo the add's pins (the caller re-submits head-routed)
            self._unpin(spec.pinned_refs)
            return
        if ent.get("failed"):
            # budget gated, not consumed — the _direct_fail rule: the
            # head-routed re-execution charges any subsequent loss
            started = bool(ent.get("started"))
            retry = (not started
                     or spec.retries_used < spec.max_retries)
            if retry:
                with st.lock:
                    self._requeue_in_order(st, spec)
                self._flush_actor_queue(actor_id)
            else:
                self._store_error(spec.return_ids, TaskError(
                    ActorError(actor_id,
                               "direct actor call failed (worker "
                               "died or endpoint fenced); no retries "
                               "left"),
                    task_name=spec.name))
                self._unpin(spec.pinned_refs)
                self.controller.record_task_event(
                    task_id, spec.name, "FAILED",
                    error="direct call failed")
            return
        for stored in ent.get("inline", ()):
            # owner-side seal of the caller's inline-replied results:
            # third parties resolve here exactly as on the head-routed
            # path — the bytes just arrived coalesced instead of per
            # call
            self._seal_contained(stored.object_id, stored.contained_ids)
            self.store.put_stored(stored)
            if self.controller.unreferenced(stored.object_id):
                self._delete_everywhere(stored.object_id)
        for oid, nbytes, host_nid, contained in ent.get("located", ()):
            self._seal_contained(oid, contained)
            if host_nid:
                self.controller.add_location(oid, host_nid, nbytes)
            self.waiters.notify(oid)
        self._unpin(spec.pinned_refs)
        located = ent.get("located") or ()
        _mp.observe_task_done(
            spec, (located[0][2] if located and located[0][2]
                   else self.head_node_id))
        state = "FAILED" if ent.get("error") else "FINISHED"
        self.controller.record_task_event(task_id, spec.name, state)

    def _drop_direct_calls_of_caller(self, worker_id: str) -> None:
        """A remote caller worker died: its mirrored direct calls can
        never send their done entries — release their pins and drop
        them (nobody is left to consume the results; the conservative
        direction, like a SIGKILLed borrower's refs)."""
        if not worker_id:
            return
        with self._actor_lock:
            states = list(self._actor_states.values())
        for st in states:
            with st.lock:
                dead = [t for t, s in st.direct_inflight.items()
                        if getattr(s, "_direct_caller", None)
                        == worker_id]
                specs = [st.direct_inflight.pop(t) for t in dead]
            for spec in specs:
                self._unpin(spec.pinned_refs)

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        rec = self.controller.get_actor(actor_id)
        if rec is None:
            return
        if no_restart:
            rec.spec.max_restarts = 0
        wid = rec.worker_id
        if wid is not None:
            sched = self._scheduler_for_worker(wid)
            if sched is not None:
                sched.kill_worker(wid)

    def cancel_task(self, object_id: str, force: bool = False) -> None:
        """Cancel a task by its return ref (reference core_worker
        CancelTask): queued tasks are removed; RUNNING tasks get
        TaskCancelledError raised in their executor thread, or their
        worker killed outright with force=True. Either way the task is
        marked non-retriable first so worker-death recovery doesn't
        resurrect it."""
        # Return ids are "<task_id>r<i>" and task ids are hex, so 'r' splits.
        task_id = object_id.split("r", 1)[0]
        for node in self.cluster.alive_nodes():
            spec = node.scheduler.cancel_pending(task_id)
            if spec is not None:
                err = TaskCancelledError(task_id)
                self._store_error(spec.return_ids, TaskError(
                    err, task_name=spec.name))
                self._unpin(spec.pinned_refs)
                self.controller.record_task_event(task_id, spec.name,
                                                  "CANCELLED")
                return
        # parked as infeasible (autoscaler may be provisioning)?
        spec = self.cluster.cancel_parked(task_id)
        if spec is not None:
            self._store_error(spec.return_ids, TaskError(
                TaskCancelledError(task_id), task_name=spec.name))
            self._unpin(spec.pinned_refs)
            self.controller.record_task_event(task_id, spec.name,
                                              "CANCELLED")
            return
        # not queued: running somewhere?
        for node in self.cluster.alive_nodes():
            hit = node.scheduler.worker_running_task(task_id)
            if hit is None:
                continue
            worker_id, spec = hit
            spec.cancelled = True        # no retry on worker death
            self.controller.record_task_event(task_id, spec.name,
                                              "CANCELLING")
            if force:
                node.scheduler.kill_worker(worker_id)
            else:
                node.scheduler.cancel_running(worker_id, task_id)
            return

    def get_actor_handle(self, name: str, namespace: str = "default"):
        actor_id = self.controller.get_named_actor(name, namespace)
        if actor_id is None:
            raise ValueError(f"No actor named {name!r} in namespace "
                             f"{namespace!r}")
        rec = self.controller.get_actor(actor_id)
        from ray_tpu_torch.actor import ActorHandle
        import pickle as _p
        cls = _p.loads(self.controller.get_function(rec.spec.class_id))
        return ActorHandle._from_class(actor_id, cls,
                                       rec.spec.max_task_retries)

    # ---- state / introspection ----
    def kv_op(self, op: str, key: str, value: Any = None,
              namespace: str = "default", **kw) -> Any:
        """Driver-side KV access (workers reach the same store over the
        KV_OP wire message)."""
        return self._kv_dispatch({"op": op, "key": key, "value": value,
                                  "namespace": namespace, **kw})

    def state_op(self, op: str, **kwargs) -> Any:
        if op == "list_actors":
            return self.controller.list_actors()
        if op == "list_tasks":
            return self.controller.list_task_events(
                kwargs.get("limit", 1000))
        if op == "summarize_tasks":
            return self.controller.summarize_tasks()
        if op == "list_placement_groups":
            return self.cluster.pg_table()
        if op == "list_nodes":
            # the head doesn't heartbeat to itself: sample it live
            self.controller.update_host_stats(
                self.head_node_id, self.scheduler.host_stats())
            return self.controller.list_nodes()
        if op == "list_workers":
            out = []
            for n in self.cluster.alive_nodes():
                for row in n.scheduler.workers_snapshot():
                    out.append({"node_id": n.node_id, **row})
            return out
        if op == "usage_stats":
            nodes = self.controller.list_nodes()
            return {
                "uptime_s": round(time.time() - self._started_at, 1),
                "nodes_alive": sum(1 for n in nodes if n["alive"]),
                "nodes_dead": sum(1 for n in nodes if not n["alive"]),
                "total_resources": self.cluster.total_resources(),
                "available_resources":
                    self.cluster.available_resources(),
                "workers": sum(len(n.scheduler.workers_snapshot())
                               for n in self.cluster.alive_nodes()),
                "tasks": self.controller.summarize_tasks(),
                "actors": _summarize_by_state(
                    self.controller.list_actors()),
                "object_store": self.store.stats(),
            }
        if op == "cluster_resources":
            return self.cluster.total_resources()
        if op == "available_resources":
            return self.cluster.available_resources()
        if op == "scheduler_stats":
            return self.scheduler.stats()
        if op == "wire_stats":
            # head-process frame counters + which wire engine is live
            # (native read pump / writev / codec vs pure Python) — the
            # r7 frame engine's observability hook
            from ray_tpu_torch import native
            return {**protocol.WIRE_STATS,
                    "native_frame_engine": native.frame_engine_enabled(),
                    "native_available": native.available()}
        if op == "cluster_stats":
            return self.cluster.stats()
        if op == "object_store_stats":
            return self.store.stats()
        if op == "object_plane_stats":
            return self._object_plane_stats()
        if op == "broadcast_object":
            return self.broadcast_object(kwargs["object_id"],
                                         fanout=kwargs.get("fanout"),
                                         timeout=kwargs.get("timeout"))
        if op == "trace_dump":
            return self._trace_dump(
                timeout=kwargs.get("timeout", 5.0))
        if op == "trace_stats":
            return self._trace_stats()
        if op == "metrics_dump":
            # cluster-merged registry snapshot (node/worker-labeled
            # series; the dashboard renders exposition text from it)
            return self.metrics.collect(
                timeout=kwargs.get("timeout", 3.0))
        if op == "metrics_summary":
            return self.metrics.summary(
                timeout=kwargs.get("timeout", 3.0))
        if op == "metrics_stats":
            return {"enabled": _mp.enabled(), **self.metrics.stats()}
        if op == "head_shard_stats":
            # r16 striped-table + decref-delta observability
            return {"shards": self.controller.shard_stats(),
                    "decref_delta": dict(self._decref_delta_stats)}
        if op == "liveness_stats":
            # r17 membership observability: per-node liveness state +
            # heartbeat age, incarnation table, fence/suspicion
            # counters
            return {
                **self.cluster.liveness_stats(),
                "incarnations": self.controller.incarnations(),
                "fence": dict(self._fence_stats),
            }
        if op == "direct_actor_stats":
            # r18 direct actor plane observability: head-side caller/
            # host counters, pending head-hosted direct calls, and
            # each agent's heartbeat-carried host counters
            return {
                "head": dict(self._direct_stats),
                "pending": len(self._direct_pending),
                "nodes": {
                    n.node_id: dict(getattr(n.scheduler,
                                            "direct_stats", None)
                                    or {})
                    for n in self.cluster.alive_nodes()},
            }
        if op == "head_ha_stats":
            # r15 head-HA observability: WAL bytes/records/fsync
            # latencies, snapshot age, recovery + replay-dedup counts
            if self._ha is not None:
                return self._ha.stats()
            return {"enabled": False,
                    "snapshot_path": self._snapshot_path}
        if op == "waiter_stats":
            return self.waiters.stats()
        if op == "pubsub_poll":
            return self.controller.pubsub.poll(
                kwargs["channel"], kwargs.get("cursor", 0),
                kwargs.get("timeout"))
        if op == "pubsub_publish":
            return self.controller.pubsub.publish(
                kwargs["channel"], kwargs["message"])
        if op == "record_task_events":
            self.controller.record_task_events(kwargs["events"])
            return True
        if op == "cancel_task":
            self.cancel_task(kwargs["object_id"],
                             kwargs.get("force", False))
            return True
        if op == "kill_actor":
            self.kill_actor(kwargs["actor_id"],
                            kwargs.get("no_restart", True))
            return True
        # a worker's placement groups (`util/placement_group.py`; a
        # serving replica places its tp ranks in one)
        if op == "create_placement_group":
            rec = self.cluster.create_pg(kwargs["bundles"],
                                         kwargs["strategy"],
                                         name=kwargs.get("name", ""))
            return {"id": rec.pg_id, "bundles": rec.bundles}
        if op == "wait_placement_group":
            # a short wait a call: this connection's reader thread runs it
            return self.cluster.wait_pg(kwargs["pg_id"], 0.1)
        if op == "remove_placement_group":
            self.cluster.remove_pg(kwargs["pg_id"])
            return True
        raise ValueError(f"unknown state op {op}")

    def node_resources(self) -> dict:
        return dict(self.scheduler.total)

    # ---- lifecycle ----
    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        _mp.set_sampler("head", None)
        # each step is independent: a wedged component must not block
        # the ones after it (especially the final shm sweep)
        for step in ((lambda: (protocol._CHAOS_NET.clear()
                               if protocol._CHAOS_NET is not None
                               else None)),
                     (lambda: (self._ha.close()
                               if self._ha is not None else None)),
                     self._close_direct_conns,
                     self.cluster.shutdown, self.waiters.shutdown,
                     self.controller.pubsub.close,
                     lambda: self._restore_pool.shutdown(wait=False),
                     self._listener.close,
                     lambda: (self._poller.close()
                              if self._poller is not None else None),
                     self.store.shutdown,
                     self._sweep_orphan_segments):
            try:
                step()
            except Exception:
                log.exception("shutdown step failed")

    def _close_direct_conns(self) -> None:
        with self._direct_lock:
            conns = list(self._direct_conns.values())
            self._direct_conns.clear()
        for c in conns:
            try:
                c.close()
            except Exception:
                pass

    def _sweep_orphan_segments(self) -> None:
        """Final backstop against shm leaks: every worker/agent this
        runtime spawned is stopped by now, so any segment tagged with
        OUR session that the store didn't reclaim is an orphan from a
        killed producer (the per-death reap covers the common paths;
        this catches the rest). Only the session-tag OWNER sweeps: a
        driver started inside a job/worker of a parent session inherits
        the tag, and sweeping there would delete the parent's live
        segments."""
        from ray_tpu_torch._private.specs import SESSION_TAG_INHERITED
        if SESSION_TAG_INHERITED:
            return
        from ray_tpu_torch._private.object_store import sweep_session_segments
        sweep_session_segments()


# ================= module-level init/shutdown =================
def init(num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
         resources: Optional[dict] = None, max_workers: Optional[int] = None,
         namespace: str = "default",
         ignore_reinit_error: bool = False,
         bind_host: Optional[str] = None,
         port: Optional[int] = None,
         address: Optional[str] = None,
         labels: Optional[dict] = None) -> Any:
    """Start the head runtime. ``num_gpus`` (default: the CUDA devices
    this process would see, `detect_num_gpus`) becomes the head node's
    ``GPU`` resource. With bind_host="0.0.0.0" (or env
    RAY_TPU_BIND_HOST) the listener accepts remote node agents;
    rt.address carries the (host, port) to hand to agents
    (``python -m ray_tpu_torch._private.node_agent``). With
    address="host:port" this process instead CONNECTS to an existing head
    as a remote driver (the Ray Client analogue,
    ray_tpu_torch.util.client)."""
    existing = _context.maybe_ctx()
    if existing is not None:
        if ignore_reinit_error:
            return existing  # type: ignore[return-value]
        if existing.is_driver:
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True to allow this.")
        return existing  # inside a worker: init is a no-op, like ray.init
    if address is not None:
        incompatible = {k: v for k, v in {
            "num_cpus": num_cpus, "num_gpus": num_gpus,
            "resources": resources, "max_workers": max_workers,
            "bind_host": bind_host, "port": port,
            "labels": labels}.items()
            if v is not None}
        if namespace != "default":
            incompatible["namespace"] = namespace
        if incompatible:
            raise ValueError(
                f"init(address=...) connects to an EXISTING head; "
                f"{sorted(incompatible)} only apply when starting one")
        from ray_tpu_torch.util.client import connect
        return connect(address)
    rt = Runtime(num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
                 max_workers=max_workers, namespace=namespace,
                 bind_host=bind_host, port=port, labels=labels)
    _context.set_ctx(rt)
    return rt


def shutdown() -> None:
    ctx = _context.maybe_ctx()
    if ctx is None:
        return
    if isinstance(ctx, Runtime):
        ctx.shutdown()
        _context.set_ctx(None)
        return
    # remote-driver client: disconnect (the head keeps running)
    if hasattr(ctx, "disconnect"):
        ctx.disconnect()
