"""Controller: the centralized control plane (GCS equivalent).

Parity map to the reference GCS (src/ray/gcs/gcs_server/gcs_server.h:221-295):
- KV / function store   -> GcsInternalKVManager / GcsFunctionManager
- actor directory       -> GcsActorManager (incl. max_restarts bookkeeping,
                           gcs_actor_manager.h:89-91)
- named actors          -> GcsActorManager named-actor index
- placement groups      -> GcsPlacementGroupManager (bundle reservation)
- node table            -> GcsNodeManager
- task events           -> GcsTaskManager (bounded in-memory history)
- refcounts             -> centralized stand-in for the distributed
                           reference counter (core_worker/reference_count.cc)

All state is in-memory in the driver process; the multi-node story keeps
this process as head node (the reference's head-node GCS is the same
topology). Head fault tolerance: ``snapshot_state()`` serializes every
table and ``restore_state()`` rehydrates a restarted head from it
(reference gcs/gcs_server/gcs_init_data.cc loading from
gcs/store_client/redis_store_client.h storage).

r16 hot-table striping: the three tables every submit/done/decref
touches — the ref/pin table, the live-task spec mirror (+ lineage),
and the object directory — no longer live under ``controller._lock``.
They are striped shards with per-shard plain locks (striped.py), so
the driver submit thread, the poller's completion handling, and the
decref flusher stop convoying through one reentrant lock at 100k-task
scale. ``_lock`` still guards the cold tables (KV, actors, nodes,
PGs, task events). WAL composition: sharded mutations complete BEFORE
their record is appended, and ``snapshot_state`` captures the WAL
frontier BEFORE capturing any sharded table — see striped.py for why
that preserves the r15 exact-frontier recovery invariant.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch._private import striped
from ray_tpu_torch._private.head_ha import TERMINAL_TASK_STATES
from ray_tpu_torch._private.specs import ActorSpec

# Actor lifecycle states (reference rpc::ActorTableData states).
PENDING = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


@dataclass
class ActorRecord:
    spec: ActorSpec
    state: str = PENDING
    worker_id: Optional[str] = None
    node_id: Optional[str] = None
    num_restarts: int = 0
    death_cause: str = ""
    created_at: float = field(default_factory=time.time)


@dataclass
class NodeTableRecord:
    """GcsNodeManager node-table entry (gcs_node_manager.h:62)."""
    node_id: str
    resources: dict
    is_head: bool = False
    alive: bool = True
    death_cause: str = ""
    labels: dict = field(default_factory=dict)
    registered_at: float = field(default_factory=time.time)
    # last per-node reporter sample (load, memory, worker RSS) carried
    # on heartbeats — reference dashboard/modules/reporter agent
    host_stats: dict = field(default_factory=dict)


class Controller:
    def __init__(self, task_event_capacity: Optional[int] = None):
        from ray_tpu_torch._private.config import CONFIG as _CFG
        if task_event_capacity is None:
            task_event_capacity = _CFG.task_event_history
        from ray_tpu_torch._private.debug_sync import make_lock
        self._lock = make_lock("controller", reentrant=True)
        self._kv: dict[tuple[str, str], Any] = {}
        self._actors: dict[str, ActorRecord] = {}
        self._named_actors: dict[tuple[str, str], str] = {}
        # Striped ref/pin table (r16): one [refcount, pins] entry per
        # object id, per-stripe locks, entries evicted at zero/zero.
        # The WAL hook runs INSIDE the stripe lock (absolute values
        # must log in mutation order — striped.py docstring).
        self._refs = striped.RefTable(log=self._log_ref_locked)
        self._pgs: dict[str, dict] = {}
        self._nodes: dict[str, NodeTableRecord] = {}
        # Cluster object directory: object_id -> {node_id} holding a
        # copy (reference ownership_based_object_directory.cc role; the
        # head IS the owner of record for every object). Extracted to
        # its own subsystem so getters, the scheduler locality hint,
        # and the broadcast coordinator share one location service.
        from ray_tpu_torch._private.object_directory import ObjectDirectory
        self.directory = ObjectDirectory()
        # Lineage: return object_id -> producing TaskSpec, kept while
        # the object is referenced so a lost copy can be re-executed
        # (reference task_manager.h:269 ResubmitTask,
        # object_recovery_manager.h:41). Striped + FIFO-bounded: it is
        # the one hot table with no natural terminal event while refs
        # stay live, so a 100k drain would otherwise keep 100k specs
        # resident. Evicting an old entry only disables lost-copy
        # reconstruction for that object (reference lineage eviction
        # under max_lineage_bytes degrades the same way).
        self._lineage = striped.StripedMap(
            max_entries=_CFG.head_lineage_max)
        # Nested-ref ownership (reference reference_count.cc contained
        # refs): enclosing object id -> inner object ids it holds a
        # count on; released when the enclosing object is deleted.
        self._contained: dict[str, list[str]] = {}
        self._task_events: collections.deque = collections.deque(
            maxlen=task_event_capacity)
        # Live plain-task table (r15 head HA): task_id -> spec for every
        # submitted-not-terminal driver task. This is what a restarted
        # head consults to decide which specs are still owed an
        # execution (mirrored-to-an-agent specs wait for the rejoin
        # reconcile; the rest re-place immediately). Striped (r16):
        # submit inserts and terminal pops ride per-shard locks.
        self._live_tasks = striped.StripedMap()
        # Batched decref-delta watermarks (r16): node_id -> highest
        # applied delta seq. The dedup that extends the r15 rejoin
        # replay rules to NODE_DECREF_DELTA frames: a replayed delta at
        # or below the watermark was already applied by this head (or
        # survives in the snapshot/WAL refs records) and is skipped.
        self._decref_seqs: dict[str, int] = {}
        # Node incarnations (r17 partition-tolerant membership):
        # node_id -> monotonic epoch, minted at every registration and
        # bumped at every death declaration. WAL-logged and
        # snapshotted, so incarnations stay monotonic across head
        # restarts — a zombie from before ANY restart still fences.
        # The head stamps the registration's incarnation on the
        # agent's connection; frames from a connection whose
        # incarnation trails this table are dropped and answered with
        # NODE_FENCED (reference: GCS rejects RPCs from de-registered
        # raylets the same way).
        self._incarnations: dict[str, int] = {}
        # Head-HA logger (r15): set by the runtime once recovery is
        # done; while None (or during replay) the _walog hooks no-op.
        self.ha = None
        from ray_tpu_torch._private.pubsub import Publisher
        self.pubsub = Publisher()
        self._job_start = time.time()

    # ---- head-HA write-ahead logging (r15) ----
    def _walog(self, rtype: str, data: Any) -> None:
        """Append one WAL record. For ``_lock``-guarded tables this is
        called inside the locked region that performed the mutation
        (mutate+log atomic w.r.t. the frontier capture, which shares
        ``_lock``). For the striped tables the call site sequences the
        append AFTER the mutation instead; snapshot_state captures the
        frontier BEFORE the striped tables, which preserves the same
        replay invariant (striped.py docstring)."""
        ha = self.ha
        if ha is not None:
            ha.log(rtype, data)

    def _log_ref_locked(self, object_id: str, refcount: int,
                        pins: int) -> None:
        """RefTable WAL hook: absolute refcount+pin record (set
        semantics — replay-safe under duplication), coalesced WAL-side
        per flush window. Runs with the object's stripe lock held."""
        ha = self.ha
        if ha is not None:
            ha.log_ref(object_id, refcount, pins)

    # ---- KV (GcsInternalKVManager parity) ----
    def kv_put(self, key: str, value: Any, namespace: str = "default",
               overwrite: bool = True) -> bool:
        with self._lock:
            k = (namespace, key)
            if not overwrite and k in self._kv:
                return False
            self._kv[k] = value
            self._walog("kv", (namespace, key, value))
            return True

    def kv_get(self, key: str, namespace: str = "default") -> Any:
        with self._lock:
            return self._kv.get((namespace, key))

    def kv_del(self, key: str, namespace: str = "default") -> bool:
        with self._lock:
            hit = self._kv.pop((namespace, key), None) is not None
            if hit:
                self._walog("kv_del", (namespace, key))
            return hit

    def kv_exists(self, key: str, namespace: str = "default") -> bool:
        with self._lock:
            return (namespace, key) in self._kv

    def kv_keys(self, prefix: str = "", namespace: str = "default") -> list[str]:
        with self._lock:
            return [k for (ns, k) in self._kv
                    if ns == namespace and k.startswith(prefix)]

    # ---- function store ----
    def put_function(self, func_id: str, data: bytes) -> None:
        self.kv_put(func_id, data, namespace="_functions", overwrite=False)

    def get_function(self, func_id: str) -> Optional[bytes]:
        return self.kv_get(func_id, namespace="_functions")

    # ---- refcounts (striped RefTable; per-shard locks) ----
    def addref(self, object_id: str, n: int = 1) -> None:
        self._refs.addref(object_id, n)

    def decref(self, object_id: str) -> bool:
        """Returns True when the object is now unreferenced and unpinned."""
        return self._refs.decref(object_id)

    def apply_decref_delta(self, node_id: str, seq: int,
                           counts: dict) -> Optional[list[str]]:
        """Batched decref delta from a delegated agent (r16): apply
        ``{oid: n}`` per-shard and return the ids now deletable, or
        None when the delta is a replayed duplicate (its seq is at or
        below the node's watermark). The watermark advances — and WAL-
        logs — BEFORE the counts apply: a crash in between loses the
        releases (objects leak until shutdown, the safe direction)
        instead of double-applying them on replay (premature free)."""
        if seq:
            with self._lock:
                if seq <= self._decref_seqs.get(node_id, 0):
                    return None
                self._decref_seqs[node_id] = seq
                self._walog("dref_seq", (node_id, seq))
        return self._refs.apply_deltas(counts)

    def reset_decref_seq(self, node_id: str) -> None:
        """A FRESH (non-rejoin) agent registered under this node id:
        its delta counter restarts, so the watermark must too."""
        with self._lock:
            if self._decref_seqs.pop(node_id, None) is not None:
                self._walog("dref_seq", (node_id, 0))

    def pin(self, object_id: str) -> None:
        self._refs.pin(object_id)

    def unpin(self, object_id: str) -> bool:
        """Returns True when the object is now unreferenced and unpinned."""
        return self._refs.unpin(object_id)

    def refcount(self, object_id: str) -> int:
        return self._refs.refcount(object_id)

    def pinned_ids(self) -> list[str]:
        """Objects pinned by in-flight work — the store's spill policy
        must not touch these (they may be mid-transfer as task args)."""
        return self._refs.pinned_ids()

    def unreferenced(self, object_id: str) -> bool:
        return self._refs.unreferenced(object_id)

    def ref_tables(self) -> tuple[dict, dict]:
        """(refcounts, pins) merged one-dict views (tests, snapshots)."""
        return self._refs.snapshot()

    # ---- object directory (delegates to the ObjectDirectory
    # subsystem; these remain the control-plane entry points) ----
    def add_location(self, object_id: str, node_id: str,
                     nbytes: int = 0, partial: bool = False) -> None:
        self.directory.add(object_id, node_id, nbytes, partial=partial)
        if not partial:
            # partial holders (r12 cut-through) are advisory in-flight
            # state: meaningless to a restarted head, never logged
            self._walog("dir+", (object_id, node_id, nbytes))

    def remove_location(self, object_id: str,
                        node_id: Optional[str] = None) -> None:
        self.directory.remove(object_id, node_id)
        self._walog("dir-", (object_id, node_id))

    def locations(self, object_id: str) -> list[str]:
        return self.directory.locations(object_id)

    def has_location(self, object_id: str) -> bool:
        return self.directory.has(object_id)

    def purge_node_locations(self, node_id: str) -> list[str]:
        """Drop `node_id` from every directory entry; returns object ids
        that now have NO copy anywhere (lineage-recovery candidates)."""
        self._walog("dir_purge", node_id)
        return self.directory.purge_node(node_id)

    # ---- nested-ref ownership ----
    def register_contained(self, object_id: str,
                           ids: list[str]) -> list[str]:
        """The sealed object `object_id` pickled refs to `ids` inside
        it: hold a count on each until it is deleted. A reseal with
        DIFFERENT contents (lineage resubmission creates fresh inner
        ids) refreshes the registration; the previously-held ids are
        RETURNED and the caller must decref them through the full
        deletion path."""
        new = list(ids)
        with self._lock:
            old = self._contained.get(object_id)
            if old == new or (old is None and not new):
                return []
            # inner-ref counts FIRST (each logs its absolute value
            # inside its stripe lock, taken UNDER _lock — the
            # controller-lock -> stripe-lock order apply_decref_delta
            # also uses): a crash between these appends and the
            # contained record below leaks conservatively, while the
            # reverse order would let replay decref counts that were
            # never incremented — a premature free
            for cid in new:
                self._refs.addref(cid)
            if new:
                self._contained[object_id] = new
            else:
                self._contained.pop(object_id, None)
            self._walog("contained", (object_id, new))
            return list(old or ())

    def pop_contained(self, object_id: str) -> list[str]:
        with self._lock:
            out = self._contained.pop(object_id, [])
            if out:
                self._walog("contained", (object_id, []))
            return out

    # ---- lineage (ResubmitTask parity) ----
    def record_lineage(self, spec: Any) -> None:
        for oid in getattr(spec, "return_ids", ()):
            self._lineage.put(oid, spec)

    # ---- live-task accounting (r15 head HA) ----
    def task_submitted(self, spec: Any) -> None:
        """Record everything a restarted head needs to re-own this
        task: lineage for its return objects, the live-task entry that
        marks it submitted-not-terminal, and ONE WAL record carrying
        the spec (replay rebuilds both tables from it). Mutations
        complete before the record is appended — the striped-table WAL
        invariant (striped.py)."""
        for oid in getattr(spec, "return_ids", ()):
            self._lineage.put(oid, spec)
        tid = getattr(spec, "task_id", None)
        if tid is not None:
            self._live_tasks.put(tid, spec)
        self._walog("task", spec)

    def live_task(self, task_id: str) -> Any:
        return self._live_tasks.get(task_id)

    def live_task_ids(self) -> list[str]:
        return self._live_tasks.keys()

    def lineage_for(self, object_id: str) -> Any:
        return self._lineage.get(object_id)

    def drop_lineage(self, object_id: str) -> None:
        self._lineage.pop(object_id)

    # ---- actors ----
    def register_actor(self, spec: ActorSpec) -> ActorRecord:
        with self._lock:
            if spec.name is not None:
                key = (spec.namespace, spec.name)
                if key in self._named_actors:
                    raise ValueError(
                        f"Actor name {spec.name!r} already taken in "
                        f"namespace {spec.namespace!r}")
                self._named_actors[key] = spec.actor_id
            rec = ActorRecord(spec=spec)
            self._actors[spec.actor_id] = rec
            self._walog("actor", spec)
            return rec

    def get_actor(self, actor_id: str) -> Optional[ActorRecord]:
        with self._lock:
            return self._actors.get(actor_id)

    def get_named_actor(self, name: str,
                        namespace: str = "default") -> Optional[str]:
        with self._lock:
            return self._named_actors.get((namespace, name))

    def set_actor_state(self, actor_id: str, state: str,
                        worker_id: Optional[str] = None,
                        death_cause: str = "",
                        node_id: Optional[str] = None) -> None:
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                return
            rec.state = state
            if worker_id is not None:
                rec.worker_id = worker_id
            if node_id is not None:
                rec.node_id = node_id
            if death_cause:
                rec.death_cause = death_cause
            if state == DEAD and rec.spec.name is not None:
                self._named_actors.pop(
                    (rec.spec.namespace, rec.spec.name), None)
            self._walog("actor_state",
                        (actor_id, state, rec.worker_id, rec.node_id,
                         rec.death_cause, rec.num_restarts))
        from ray_tpu_torch._private.pubsub import ACTOR_CHANNEL
        self.pubsub.publish(ACTOR_CHANNEL, {
            "actor_id": actor_id, "state": state,
            "death_cause": death_cause})

    def list_actors(self) -> list[dict]:
        with self._lock:
            return [{
                "actor_id": aid, "state": r.state, "name": r.spec.name,
                "class_id": r.spec.class_id, "worker_id": r.worker_id,
                "num_restarts": r.num_restarts,
                "max_restarts": r.spec.max_restarts,
                "death_cause": r.death_cause,
                "placement_group_id": r.spec.placement_group_id,
                "placement_group_bundle_index":
                    r.spec.placement_group_bundle_index,
            } for aid, r in self._actors.items()]

    # ---- placement groups (view pushed by the ClusterTaskManager) ----
    def register_pg_view(self, entry: dict) -> None:
        with self._lock:
            self._pgs[entry["placement_group_id"]] = dict(entry)
            self._walog("pg", dict(entry))

    def list_pgs(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._pgs.values()]

    # ---- node table (GcsNodeManager parity) ----
    def publish_node_event(self, node_id: str, state: str,
                           cause: str = "") -> None:
        from ray_tpu_torch._private.pubsub import NODE_CHANNEL
        self.pubsub.publish(NODE_CHANNEL, {
            "node_id": node_id, "state": state, "cause": cause})

    def register_node(self, node_id: str, resources: dict,
                      is_head: bool = False,
                      labels: Optional[dict] = None) -> None:
        with self._lock:
            self._nodes[node_id] = NodeTableRecord(
                node_id=node_id, resources=dict(resources),
                is_head=is_head, labels=dict(labels or {}))
            if not is_head:
                # head records are dropped at restore (the restarted
                # head registers itself fresh): never logged
                self._walog("node", (node_id, dict(resources),
                                     dict(labels or {})))

    def set_node_state(self, node_id: str, alive: bool,
                       cause: str = "") -> None:
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is not None:
                rec.alive = alive
                if cause:
                    rec.death_cause = cause
                if not rec.is_head:
                    self._walog("node_state", (node_id, alive, cause))

    # ---- node incarnations (r17) ----
    def mint_incarnation(self, node_id: str) -> int:
        """Next incarnation for a (re)registering node. Monotonic per
        node_id across head restarts (WAL-logged, snapshotted)."""
        with self._lock:
            inc = self._incarnations.get(node_id, 0) + 1
            self._incarnations[node_id] = inc
            self._walog("incarnation", (node_id, inc))
            return inc

    def bump_incarnation(self, node_id: str) -> int:
        """Invalidate the node's current incarnation (death
        declaration): any connection still carrying the old epoch is
        fenced from here on — the zombie window closes the moment the
        death recovery that re-places its work begins."""
        return self.mint_incarnation(node_id)

    def node_incarnation(self, node_id: str) -> Optional[int]:
        # LOCK-FREE by design: called on every state-bearing agent
        # frame (the fence admission check) — a GIL-atomic dict read
        # of an int that only ever rises. Worst case a frame racing a
        # death bump is admitted one beat early, which the death
        # recovery's mirror drain already tolerates; taking the global
        # controller lock here would re-serialize the hot dispatch
        # path the r16 striping work got off it.
        return self._incarnations.get(node_id)

    def incarnations(self) -> dict:
        with self._lock:
            return dict(self._incarnations)

    def update_host_stats(self, node_id: str, stats: dict) -> None:
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is not None:
                rec.host_stats = dict(stats)

    def list_nodes(self) -> list[dict]:
        with self._lock:
            return [{
                "node_id": r.node_id, "alive": r.alive,
                "is_head": r.is_head, "resources": dict(r.resources),
                "death_cause": r.death_cause, "labels": dict(r.labels),
                "host_stats": dict(r.host_stats),
            } for r in self._nodes.values()]

    def actors_on_node(self, node_id: str) -> list[str]:
        """Non-dead actors whose last known placement is `node_id`."""
        with self._lock:
            return [aid for aid, r in self._actors.items()
                    if r.node_id == node_id and r.state != DEAD]

    # ---- persistence (GCS storage parity) ----
    # Cold tables captured under _lock; the striped tables keep their
    # legacy blob keys but are captured shard-aware (after the
    # frontier) — the blob SHAPE is unchanged across r15 <-> r16.
    _SNAPSHOT_TABLES = ("_kv", "_actors", "_named_actors", "_pgs",
                        "_nodes", "_contained", "_decref_seqs",
                        "_incarnations")
    _STRIPED_TABLES = ("_refcounts", "_pins", "_lineage", "_live_tasks")

    def snapshot_state(self, extra_fn: Optional[Any] = None) -> bytes:
        """Snapshot every table into one blob (reference GCS tables are
        flushed to the storage backend). Only shallow table copies
        happen under locks; the pickle — the expensive part — runs
        outside. With the r15 WAL attached, the blob embeds the WAL
        sequence frontier it covers. Capture order is the r16
        invariant: frontier FIRST (under ``_lock``, atomic with the
        cold-table capture whose mutate+log pairs share that lock),
        striped tables and the directory AFTER — a record at or below
        the frontier is then provably visible in the captured shard
        (striped.py docstring). ``extra_fn`` supplies runtime-owned
        tables (per-node spec mirrors + lease ledgers) and likewise
        runs after the frontier capture: a mirror add logged at
        seq <= frontier is guaranteed visible in the captured mirror,
        while one logged later replays from the WAL."""
        import pickle

        import cloudpickle
        with self._lock:
            state = {name: dict(getattr(self, name))
                     for name in self._SNAPSHOT_TABLES}
            state["_task_events"] = list(self._task_events)
            if self.ha is not None:
                state["_wal_seq"] = self.ha.wal_seq()
        # striped tables: captured per-shard AFTER the frontier, merged
        # into the legacy one-dict blob keys
        (state["_refcounts"],
         state["_pins"]) = self._refs.snapshot()
        state["_lineage"] = self._lineage.snapshot()
        state["_live_tasks"] = self._live_tasks.snapshot()
        # the directory snapshots under its own stripe locks (its table
        # keys keep the pre-extraction names for blob continuity)
        (state["_locations"],
         state["_location_nbytes"]) = self.directory.snapshot()
        if extra_fn is not None:
            state.update(extra_fn())
        # cloudpickle, not stdlib pickle: lineage/KV hold raw user task
        # args (lambdas, closures) that the wire layer supports — a
        # snapshot that crashes on them silently disables head FT
        return cloudpickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)

    def restore_state(self, blob: bytes) -> dict:
        """Rehydrate from a snapshot (reference gcs_init_data.cc). Node
        records for OLD head processes are dropped — the restarted head
        registers itself fresh; agent records are kept so the cluster
        can await their re-registration. Returns the raw state dict so
        the runtime can pick up its own tables (mirrors, WAL
        frontier)."""
        import pickle
        state = pickle.loads(blob)
        with self._lock:
            current = dict(self._nodes)          # the new head's record(s)
            for name in self._SNAPSHOT_TABLES:
                # _decref_seqs rides this loop too (it is in
                # _SNAPSHOT_TABLES; r15-era blobs simply lack the key)
                setattr(self, name, state.get(name, {}))
            self._nodes = {nid: r for nid, r in self._nodes.items()
                           if not r.is_head}
            self._nodes.update(current)
            self._task_events.extend(state.get("_task_events", ()))
        self._refs.restore(state.get("_refcounts", {}),
                           state.get("_pins", {}))
        self._lineage.restore(state.get("_lineage", {}))
        self._live_tasks.restore(state.get("_live_tasks", {}))
        self.directory.restore(state.get("_locations", {}),
                               state.get("_location_nbytes", {}))
        return state

    def apply_wal_record(self, rtype: str, data: Any) -> None:
        """Replay one WAL record onto the tables (r15 recovery). Every
        branch is set-semantics: applying a record twice — the torn-
        compaction overlap, or a test replaying the tail again —
        converges to the same state. Striped-table branches go through
        the shard-aware entry points (r16)."""
        if rtype == "task":
            spec = data
            tid = getattr(spec, "task_id", None)
            if tid is not None:
                self._live_tasks.put(tid, spec)
            for oid in getattr(spec, "return_ids", ()):
                self._lineage.put(oid, spec)
        elif rtype == "task_done":
            self._live_tasks.pop(data)
        elif rtype == "refs":
            for oid, (ref, pin) in data.items():
                self._refs.set_absolute(oid, ref, pin)
        elif rtype == "dref_seq":
            node_id, seq = data
            with self._lock:
                if seq:
                    cur = self._decref_seqs.get(node_id, 0)
                    self._decref_seqs[node_id] = max(cur, int(seq))
                else:
                    self._decref_seqs.pop(node_id, None)
        elif rtype == "incarnation":
            node_id, inc = data
            with self._lock:
                cur = self._incarnations.get(node_id, 0)
                self._incarnations[node_id] = max(cur, int(inc))
        elif rtype == "kv":
            ns, key, value = data
            with self._lock:
                self._kv[(ns, key)] = value
        elif rtype == "kv_del":
            ns, key = data
            with self._lock:
                self._kv.pop((ns, key), None)
        elif rtype == "contained":
            oid, ids = data
            with self._lock:
                if ids:
                    self._contained[oid] = list(ids)
                else:
                    self._contained.pop(oid, None)
        elif rtype == "dir+":
            oid, node_id, nbytes = data
            self.directory.add(oid, node_id, nbytes)
        elif rtype == "dir-":
            oid, node_id = data
            self.directory.remove(oid, node_id)
        elif rtype == "dir_purge":
            self.directory.purge_node(data)
        elif rtype == "actor":
            spec = data
            with self._lock:
                rec = self._actors.get(spec.actor_id)
                if rec is None:
                    self._actors[spec.actor_id] = ActorRecord(spec=spec)
                    if spec.name is not None:
                        self._named_actors[(spec.namespace,
                                            spec.name)] = spec.actor_id
        elif rtype == "actor_state":
            (actor_id, state, worker_id, node_id,
             death_cause, num_restarts) = data
            with self._lock:
                rec = self._actors.get(actor_id)
                if rec is not None:
                    rec.state = state
                    rec.worker_id = worker_id
                    rec.node_id = node_id
                    rec.death_cause = death_cause
                    rec.num_restarts = num_restarts
                    if state == DEAD and rec.spec.name is not None:
                        self._named_actors.pop(
                            (rec.spec.namespace, rec.spec.name), None)
        elif rtype == "node":
            node_id, resources, labels = data
            with self._lock:
                if node_id not in self._nodes:
                    self._nodes[node_id] = NodeTableRecord(
                        node_id=node_id, resources=dict(resources),
                        is_head=False, labels=dict(labels))
        elif rtype == "node_state":
            node_id, alive, cause = data
            with self._lock:
                rec = self._nodes.get(node_id)
                if rec is not None and not rec.is_head:
                    rec.alive = alive
                    if cause:
                        rec.death_cause = cause
        elif rtype == "pg":
            with self._lock:
                self._pgs[data["placement_group_id"]] = dict(data)
        # unknown record types from a newer head are skipped silently:
        # the snapshot they compact into still restores

    # ---- task events (GcsTaskManager parity) ----
    def record_task_event(self, task_id: str, name: str, state: str,
                          worker_id: str = "", error: str = "") -> None:
        with self._lock:
            self._task_events.append({
                "task_id": task_id, "name": name, "state": state,
                "worker_id": worker_id, "error": error, "ts": time.time(),
            })
        if state in TERMINAL_TASK_STATES:
            # the task is off the head's books: a restarted head
            # must not re-own (and re-place) it — terminal specs evict
            # eagerly (stripe pop), then the pop is logged
            if self._live_tasks.pop(task_id) is not None:
                self._walog("task_done", task_id)

    def record_task_events(self, events: list[dict]) -> None:
        """Batched ingest from worker-side event buffers (reference
        GcsTaskManager AddTaskEventData): events carry their own
        worker-side ts/duration_s."""
        with self._lock:
            self._task_events.extend(events)

    def list_task_events(self, limit: int = 1000) -> list[dict]:
        with self._lock:
            out = list(self._task_events)
        return out[-limit:]

    def summarize_tasks(self) -> dict:
        with self._lock:
            latest: dict[str, dict] = {}
            for ev in self._task_events:
                latest[ev["task_id"]] = ev
        counts: dict[str, int] = collections.defaultdict(int)
        for ev in latest.values():
            counts[ev["state"]] += 1
        return dict(counts)

    # ---- shard observability (r16) ----
    def shard_stats(self) -> dict:
        """Per-table stripe occupancy/contention for /metrics and the
        head_shard gauges: proves the striping spreads load instead of
        asserting it."""
        return {
            "refs": self._refs.stats(),
            "live_tasks": self._live_tasks.stats(),
            "lineage": dict(self._lineage.stats(),
                            evicted=self._lineage.evicted),
            "directory": self.directory.shard_stats(),
        }
