"""Head-side handle for a remote node agent.

Duck-types the per-node ``Scheduler`` interface the ClusterTaskManager
and Runtime drive (enqueue / cancel / bundles / resource views /
actor-task push), but the real scheduler + worker pool live in the
remote ``node_agent`` process; this proxy forwards over the agent's
control connection and mirrors routed work so the head can recover it
if the agent dies (reference: the GCS's per-node bookkeeping in
gcs_node_manager.h:62 + gcs_actor_manager, which re-places work when a
raylet is lost).

Resource views (avail / pending demand) come from agent heartbeats —
the RaySyncer role (reference common/ray_syncer/ray_syncer.h:88):
scheduling reads a slightly stale snapshot, and the authoritative
check happens agent-side at dispatch.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.config import CONFIG as _CFG
from ray_tpu_torch._private.specs import ActorSpec, ActorTaskSpec, TaskSpec

_RPC_TIMEOUT = 30.0


class RemoteNodeHandle:
    def __init__(self, node_id: str, conn: protocol.Connection,
                 resources: dict[str, float],
                 advertise_addr: tuple[str, int],
                 wal_log=None):
        self.node_id = node_id
        # Head-HA WAL hook (r15): mirror adds + lease grants are
        # logged so a restarted head rehydrates this node's routed
        # work; None when head persistence is off.
        self._wal = wal_log
        self.conn = conn
        self.advertise_addr = advertise_addr
        self.total = dict(resources)
        self.avail = dict(resources)
        self._pending_demand: dict[str, float] = {}
        self._pending_shapes: list[dict[str, float]] = []
        # Optimistic demand claims (r20): avail/_pending_demand only
        # refresh on heartbeats, so two back-to-back submits both read
        # the pre-claim snapshot and the hybrid pack phase lands them
        # on the SAME node — fatal for an ActorSpec, which (unlike a
        # TaskSpec) can never spill off a full queue. Each enqueue
        # claims its need here until the agent's own books catch up;
        # entries expire after a few beat periods, so a delta beat
        # that never re-sends an unchanged key can't leak a claim.
        self._optimistic: dict[str, tuple[dict, float]] = {}
        self._idle = True
        self._lock = threading.Lock()
        # Mirror of work routed to this agent, keyed by task_id /
        # "actor:<id>"; value = (spec, dispatched: bool). drain_for_death
        # recovers from this when the agent vanishes.
        self._work: dict[str, tuple[Any, bool]] = {}
        # worker_id -> actor_id (or None) as reported by dispatch events.
        self._workers: dict[str, Optional[str]] = {}
        self.wire_stats: dict[str, int] = {}
        # object-plane counters (r8: transfers/serves/dedup/bytes) as
        # of the last heartbeat — aggregated by object_plane_stats
        self.object_plane: dict = {}
        # flight-recorder watermark as of the last heartbeat (r9
        # tracing plane: heartbeats carry ONLY the watermark; events
        # move via the trace_dump pull) — surfaced by trace_stats
        self.trace_watermark = 0
        self._dead = False
        # r17: the incarnation minted at this registration (set by
        # cluster.add_remote_node); surfaced by liveness_stats.
        self.incarnation = 0
        # Drain state (r14): head-side routing flag — the agent itself
        # keeps running so in-flight work finishes and completions
        # flow; reclaim of its queued backlog goes through the r10
        # NODE_LEASE_REVOKE machinery (steal_candidates/revoke_lease).
        self.draining = False
        # ---- delegated bulk-lease dispatch (r10) ----
        # Specs parked for the next NODE_LEASE_BATCH flush. They are
        # ALREADY mirrored in _work (death recovery / cancel see them
        # immediately); the buffer only batches the wire send.
        self._lease_buf: list = []
        self._lease_lock = threading.Lock()
        # Serializes the pop-build-send of a lease batch: the "flush
        # before cancel/revoke" guards must not return while another
        # thread holds a popped-but-unsent batch, or the cancel frame
        # would overtake its own task's lease on the wire.
        self._lease_send_lock = threading.Lock()
        self._lease_flusher = protocol.FlushLoop(
            self.flush_leases,
            lambda: _CFG.delegate_lease_delay_ms,
            f"rtpu-lease-{node_id}")
        # task_ids granted to the agent and not yet reported done —
        # the outstanding count the delegate_max_inflight budget caps
        self._leased: set[str] = set()
        self._leases_sent = 0
        self._tasks_leased = 0
        # agent-reported delegate counters (ride heartbeats)
        self.delegate_stats: dict = {}
        # agent-reported direct-actor host counters (r18, heartbeat-
        # carried): served / nacks / served_bytes
        self.direct_stats: dict = {}
        # ---- N10 heartbeat delta-sync ----
        self._hb_seq = -1
        self._hb_last_resync = 0.0

    # ------------------------------------------------------- heartbeat
    def on_heartbeat(self, msg: dict) -> None:
        """Apply a heartbeat — full snapshot or an N10 delta. Deltas
        (hb_delta=True, MINOR >= 3 agents) carry ONLY the keys that
        changed since the previous beat; absent keys mean "unchanged",
        so application is update-if-present. A seq gap (dropped/
        reordered beat) applies best-effort and asks the agent for a
        full snapshot via NODE_HB_RESYNC; pre-delta agents send every
        key every beat and take the same path as a full snapshot."""
        seq = msg.get("hb_seq")
        gap = False
        with self._lock:
            if seq is not None:
                if msg.get("hb_delta") and seq != self._hb_seq + 1:
                    gap = True
                self._hb_seq = int(seq)
            if "avail" in msg:
                self.avail = dict(msg["avail"])
            if "total" in msg:
                self.total = dict(msg["total"])
            if "pending_demand" in msg:
                self._pending_demand = dict(msg["pending_demand"])
            if "pending_shapes" in msg:
                self._pending_shapes = list(msg["pending_shapes"])
            if "is_idle" in msg:
                self._idle = bool(msg["is_idle"])
            if "workers" in msg:
                self._last_workers = list(msg["workers"])
            # agent-process frame counters (r7 telemetry; {} from
            # pre-r7 agents) — debug surface for per-node wire load
            if "wire" in msg:
                self.wire_stats = dict(msg["wire"])
            if "trace_watermark" in msg:
                self.trace_watermark = int(msg["trace_watermark"])
            if "delegate" in msg:
                self.delegate_stats = dict(msg["delegate"])
            if "direct" in msg:
                self.direct_stats = dict(msg["direct"])
            op = dict(msg.get("object_plane", {}))
            if op:
                # serves_per_object rides heartbeats only when it
                # changed agent-side: keep the last received table
                if ("serves_per_object" not in op
                        and "serves_per_object" in self.object_plane):
                    op["serves_per_object"] = (
                        self.object_plane["serves_per_object"])
                self.object_plane = op
        if gap:
            now = time.monotonic()
            if now - self._hb_last_resync > 1.0:   # one ask per gap
                self._hb_last_resync = now
                self._send({"type": protocol.NODE_HB_RESYNC})

    def workers_snapshot(self) -> list:
        """Worker table rows as of the last heartbeat."""
        with self._lock:
            return list(getattr(self, "_last_workers", []))

    def direct_port_of(self, worker_id: str):
        """The worker's r18 direct-serving port as of the last
        heartbeat (None until a beat carries the worker's row —
        callers fall back to agent-hosted direct serving meanwhile)."""
        with self._lock:
            for row in getattr(self, "_last_workers", ()):
                if row.get("worker_id") == worker_id:
                    return row.get("direct_port")
        return None

    # ------------------------------------------- scheduler duck-typing
    @staticmethod
    def need_of(spec) -> dict[str, float]:
        from ray_tpu_torch._private.scheduler import Scheduler
        return Scheduler.need_of(spec)

    def effective_avail(self) -> dict[str, float]:
        with self._lock:
            eff = dict(self.avail)
            for k, v in self._pending_demand.items():
                eff[k] = eff.get(k, 0.0) - v
            now = time.monotonic()
            for key in list(self._optimistic):
                need, deadline = self._optimistic[key]
                if deadline < now or key not in self._work:
                    del self._optimistic[key]
                    continue
                for k, v in need.items():
                    eff[k] = eff.get(k, 0.0) - v
            return eff

    def pending_shapes(self) -> list[dict[str, float]]:
        with self._lock:
            return list(self._pending_shapes)

    def utilization(self) -> float:
        eff = self.effective_avail()
        u = 0.0
        for k, tot in self.total.items():
            if tot > 0:
                u = max(u, 1.0 - eff.get(k, 0.0) / tot)
        return u

    def is_idle(self) -> bool:
        with self._lock:
            return self._idle and not self._work

    def owns_worker(self, worker_id: str) -> bool:
        with self._lock:
            return worker_id in self._workers

    def worker_for_actor(self, actor_id: str) -> Optional[str]:
        with self._lock:
            for wid, aid in self._workers.items():
                if aid == actor_id:
                    return wid
        return None

    # ------------------------------------------------------- submission
    def _key(self, spec) -> str:
        if isinstance(spec, ActorSpec):
            return "actor:" + spec.actor_id
        return spec.task_id

    def delegates(self) -> bool:
        """Delegated bulk-lease dispatch is on for this agent: enabled
        by config (RAY_TPU_DELEGATE) AND the agent demonstrated wire
        MINOR >= 3 (negotiated by observation, like BatchFrame)."""
        return bool(_CFG.delegate) and self.conn.peer_speaks_delegate()

    _OPTIMISTIC_TTL_S = 2.0          # = 4 agent heartbeat periods

    def enqueue(self, spec) -> None:
        key = self._key(spec)
        need = self.need_of(spec)
        with self._lock:
            self._work[key] = (spec, False)
            if any(need.values()):
                self._optimistic[key] = (
                    need, time.monotonic() + self._OPTIMISTIC_TTL_S)
            if self._wal is not None and isinstance(spec, TaskSpec):
                # the spec itself rides the task-submit record; this
                # marks WHERE it was routed (actor routing is derived
                # from the actor table at recovery instead)
                self._wal("madd", (self.node_id, spec.task_id))
        if isinstance(spec, TaskSpec) and self.delegates():
            self._park_lease(spec)
            return
        self._send({"type": protocol.NODE_ENQUEUE, "spec": spec})

    enqueue_front = enqueue

    # ---- bulk leases (r10) ----
    def _park_lease(self, spec: TaskSpec) -> None:
        """Park a spec for the next NODE_LEASE_BATCH: the first parked
        spec opens a delegate_lease_delay_ms collect window (shared
        FlushLoop pacer); hitting delegate_lease_batch flushes inline.
        Mirrors the wire-level coalescing queue's collect-then-flush
        shape one level up — whole specs instead of frames."""
        with self._lease_lock:
            self._lease_buf.append(spec)
            n = len(self._lease_buf)
        if n >= max(1, _CFG.delegate_lease_batch):
            self.flush_leases()
        else:
            self._lease_flusher.wake()

    def _budget_room(self) -> int:
        cap = _CFG.delegate_max_inflight
        if cap <= 0:
            return 1 << 30
        return max(0, cap - len(self._leased))

    def flush_leases(self) -> None:
        """Ship parked specs as ONE NODE_LEASE_BATCH (bounded by the
        outstanding-task budget; the remainder stays parked and
        re-flushes as done batches free room). Carries the head's
        resource-budget snapshot for the agent's lease ledger.

        The whole pop→build→send runs under _lease_send_lock: callers
        using this as an ordering barrier (cancel_pending /
        revoke_lease flush-first guards) must not observe an "empty"
        buffer while another thread still holds an unsent batch."""
        if self._dead:
            return                       # mirror already drained
        with self._lease_send_lock:
            self._flush_leases_locked()

    def _flush_leases_locked(self) -> None:
        with self._lease_lock:
            if not self._lease_buf:
                return
            room = self._budget_room()
            if room <= 0:
                return
            batch, self._lease_buf = (self._lease_buf[:room],
                                      self._lease_buf[room:])
            # drop specs cancel/death already removed from the mirror
            with self._lock:
                batch = [s for s in batch if s.task_id in self._work]
                self._leased.update(s.task_id for s in batch)
            if not batch:
                return
            lease_id = "ls_" + uuid.uuid4().hex[:12]
            self._leases_sent += 1
            self._tasks_leased += len(batch)
            if self._wal is not None:
                self._wal("lease",
                          (self.node_id, [s.task_id for s in batch]))
        if _tp.enabled():
            # one tiny "lease_batch" span per traced spec, spliced
            # between the driver's submit span and the agent-side
            # queue/lease spans (specs re-parent under it), so the
            # delegated hop reads off the timeline: submit ->
            # lease_batch -> queue -> lease -> exec -> done
            t_now = _tp.now()
            for s in batch:
                if getattr(s, "trace_id", 0):
                    sid = _tp.new_id()
                    _tp.record("head", "lease_batch", t_now, t_now,
                               s.trace_id, sid,
                               getattr(s, "parent_span", 0),
                               {"n": len(batch), "node": self.node_id})
                    s.parent_span = sid
        self._send({"type": protocol.NODE_LEASE_BATCH,
                    "lease_id": lease_id, "specs": batch,
                    "budget": self.effective_avail()})

    def kick_lease_flush(self) -> None:
        """Completions freed outstanding-budget room: retry the flush
        (no-op when nothing is parked)."""
        if self._lease_buf:
            self.flush_leases()

    def steal_candidates(self, limit: int = 64) -> list[str]:
        """Leased task_ids eligible for a rebalance revoke: plain
        tasks without node-affinity/PG constraints that haven't
        exhausted their spill budget (the same rules cluster.try_spill
        applies to local queues). The agent-side reclaim then filters
        to queued-NOT-started — running tasks always stay put."""
        out: list[str] = []
        with self._lock:
            for tid in self._leased:
                entry = self._work.get(tid)
                if entry is None:
                    continue
                spec = entry[0]
                if (getattr(spec, "node_id", None)
                        or getattr(spec, "placement_group_id", None)
                        or getattr(spec, "_spill_count", 0) >= 3):
                    continue
                out.append(tid)
                if len(out) >= limit:
                    break
        return out

    def queued_task_ids(self, limit: int = 4096) -> list[str]:
        """Drain-reclaim candidates (r14): every mirrored plain
        TaskSpec without affinity/PG constraints — the superset of
        ``steal_candidates`` that also covers specs PUSHED per-task
        when delegation is off (they sit in ``_work`` too, and the
        agent handles NODE_LEASE_REVOKE regardless of lease mode).
        No spill-budget filter: the node is dying, moving is
        mandatory. The agent-side reclaim still keeps anything
        already started."""
        out: list[str] = []
        with self._lock:
            for tid, entry in self._work.items():
                spec = entry[0]
                if not isinstance(spec, TaskSpec):
                    continue
                if (getattr(spec, "node_id", None)
                        or getattr(spec, "placement_group_id", None)):
                    continue
                out.append(tid)
                if len(out) >= limit:
                    break
        return out

    def revoke_lease(self, task_ids: list[str]) -> None:
        """Ask the agent to reclaim queued-not-started tasks (lease
        revoke / steal). Fire-and-forget BY DESIGN: the hand-back is
        the agent's ``lease_reclaimed`` NODE EVENT — buffered across
        head outages agent-side and deduped head-side by the mirror
        pop — so a slow or dropped reply can never strand work that
        already left the agent's queue (a request/reply here did
        exactly that on timeout). Tasks the agent already started stay
        leased there and complete normally."""
        self.flush_leases()      # revoke must not overtake its lease
        self._send({"type": protocol.NODE_LEASE_REVOKE,
                    "task_ids": list(task_ids)})

    def cancel_pending(self, task_id: str) -> Optional[TaskSpec]:
        with self._lock:
            entry = self._work.get(task_id)
        if entry is None or entry[1]:
            return None                    # unknown or already running
        # A spec still parked in the lease buffer (budget-saturated
        # flush left it behind) cancels locally — the agent has never
        # seen it, so the RPC below would miss and the task would
        # lease out and run later despite the cancel. Under the send
        # lock: no concurrent popped-but-unsent batch can hold it.
        with self._lease_send_lock:
            with self._lease_lock:
                for i, s in enumerate(self._lease_buf):
                    if s.task_id == task_id:
                        del self._lease_buf[i]
                        with self._lock:
                            entry = self._work.pop(task_id, None)
                        return entry[0] if entry else None
        self.flush_leases()  # the cancel must not overtake its lease
        try:
            rep = self.conn.request({"type": protocol.NODE_CANCEL_PENDING,
                                     "task_id": task_id},
                                    timeout=_RPC_TIMEOUT)
        except (protocol.ConnectionClosed, TimeoutError):
            return None
        if rep.get("found"):
            with self._lock:
                entry = self._work.pop(task_id, None)
                self._leased.discard(task_id)
            return entry[0] if entry else None
        return None

    def worker_running_task(self, task_id: str):
        with self._lock:
            entry = self._work.get(task_id)
            if entry is None:
                return None
            spec = entry[0]
            wid = getattr(spec, "_worker_id", None) if entry[1] else None
            delegated = task_id in self._leased
        if wid is not None:
            return (wid, spec)
        if not delegated:
            return None
        # Delegated mode suppresses per-task dispatch events, so the
        # mirror can't know the worker: ask the agent (cancel path
        # only — runs on a driver thread, never a reader).
        try:
            rep = self.conn.request({"type": protocol.NODE_FIND_TASK,
                                     "task_id": task_id},
                                    timeout=_RPC_TIMEOUT)
        except (protocol.ConnectionClosed, TimeoutError):
            return None
        if rep.get("state") == "running" and rep.get("worker_id"):
            return (rep["worker_id"], spec)
        return None

    def cancel_running(self, worker_id: str, task_id: str) -> bool:
        return self._send({"type": protocol.NODE_CANCEL_RUNNING,
                           "worker_id": worker_id, "task_id": task_id})

    def set_draining(self, flag: bool = True) -> None:
        """Head-side drain flag (see __init__); no wire round trip —
        drain is a routing decision the head alone enforces."""
        self.draining = bool(flag)

    def kill_worker(self, worker_id: str) -> None:
        self._send({"type": protocol.NODE_KILL_WORKER,
                    "worker_id": worker_id})

    def send_actor_task(self, actor_worker_id: str,
                        spec: ActorTaskSpec) -> bool:
        """Fire-and-forget push (NO blocking reply: this is called from
        the agent connection's own reader thread when an actor goes
        ALIVE, and a request would deadlock against ourselves). If the
        agent can't deliver (worker gone) it sends an
        actor_task_undeliverable event and the head requeues."""
        return self._send({"type": protocol.NODE_SEND_ACTOR_TASK,
                           "worker_id": actor_worker_id, "spec": spec})

    # -------------------------------------------------------- bundles
    def reserve_bundle(self, pg_id: str, index: int,
                       resources: dict[str, float]) -> bool:
        try:
            rep = self.conn.request(
                {"type": protocol.NODE_RESERVE_BUNDLE, "pg_id": pg_id,
                 "index": index, "resources": resources},
                timeout=_RPC_TIMEOUT)
        except (protocol.ConnectionClosed, TimeoutError):
            return False
        if rep.get("ok"):
            # keep the cached view honest until the next heartbeat
            with self._lock:
                for k, v in resources.items():
                    self.avail[k] = self.avail.get(k, 0.0) - v
            return True
        return False

    def release_bundle(self, pg_id: str, index: int) -> None:
        self._send({"type": protocol.NODE_RELEASE_BUNDLE,
                    "pg_id": pg_id, "index": index})

    # ------------------------------------------------- event ingestion
    def on_dispatched(self, key: str, worker_id: str,
                      actor_id: Optional[str] = None) -> None:
        with self._lock:
            entry = self._work.get(key)
            if entry is not None:
                spec = entry[0]
                try:
                    spec._worker_id = worker_id
                except AttributeError:
                    pass
                self._work[key] = (spec, True)
            self._workers[worker_id] = actor_id

    def on_finished(self, key: str):
        """Remove + return the mirrored spec (None if unknown)."""
        with self._lock:
            entry = self._work.pop(key, None)
            self._leased.discard(key)
        if self._lease_buf:
            self.kick_lease_flush()    # completion freed budget room
        return entry[0] if entry else None

    def track_live_actor(self, actor_id: str, spec) -> None:
        """Keep an ALIVE actor in the mirror so drain_for_death can
        restart it if this agent dies."""
        with self._lock:
            self._work["actor:" + actor_id] = (spec, True)

    def adopt_mirror(self, work: dict, leased) -> None:
        """Inherit mirrored work from a predecessor handle (r15): the
        rehydrated mirror of a pre-restart head, or the live mirror of
        the handle this re-registration replaces (a transient agent
        reconnect used to discard it — completions then popped
        nothing and accounting silently degraded)."""
        with self._lock:
            for key, entry in work.items():
                self._work.setdefault(key, entry)
            self._leased.update(leased)

    def on_worker_lost(self, worker_id: str) -> None:
        with self._lock:
            self._workers.pop(worker_id, None)

    # -------------------------------------------------------- lifecycle
    def start(self) -> None:                     # NodeRecord protocol
        pass

    def drain_for_death(self, close_conn: bool = True):
        """(queued specs, running TaskSpecs, actor ids) from the mirror.

        Delegated tasks (leased or still parked in the lease buffer)
        sit in the mirror with dispatched=False, so they all come back
        as "queued" and re-place through cluster.submit exactly once —
        the agent's workers died with it, so no completion can race a
        resubmission into a double execution.

        ``close_conn=False`` (r17, heartbeat-timeout deaths): the
        control connection is left OPEN. A node declared dead by
        staleness may be a partitioned zombie whose workers are still
        running — its post-heal frames must arrive (and be fenced by
        their stale incarnation, triggering the agent's reset +
        re-register) rather than vanish into a closed socket. The fd
        is released later by the agent's own close or process exit."""
        self._lease_flusher.stop()       # dead-before-wake, race-free
        with self._lease_lock:
            self._lease_buf.clear()
        with self._lock:
            self._dead = True
            self._leased.clear()
            work = list(self._work.values())
            self._work.clear()
            self._workers.clear()
        queued = [s for s, dispatched in work if not dispatched]
        running = [s for s, dispatched in work
                   if dispatched and isinstance(s, TaskSpec)]
        actor_ids = [s.actor_id for s, dispatched in work
                     if dispatched and isinstance(s, ActorSpec)]
        if close_conn:
            try:
                self.conn.close()
            except Exception:
                pass
        return queued, running, actor_ids

    def die_silently(self) -> None:
        """Test hook parity: drop the control connection without drain
        (the health monitor must notice)."""
        try:
            self.conn.close()
        except Exception:
            pass

    def shutdown(self) -> None:
        self._dead = True
        self._lease_flusher.stop()
        self._send({"type": protocol.NODE_SHUTDOWN})
        try:
            self.conn.close()
        except Exception:
            pass

    def stats(self) -> dict:
        with self._lock:
            return {
                "node_id": self.node_id, "remote": True,
                "total_resources": dict(self.total),
                "available_resources": dict(self.avail),
                "num_pending_tasks": len(self._pending_shapes),
                "mirrored_work": len(self._work),
                "delegated": self.delegates(),
                "leased_outstanding": len(self._leased),
                "lease_batches_sent": self._leases_sent,
                "tasks_leased": self._tasks_leased,
                "delegate_stats": dict(self.delegate_stats),
            }

    # --------------------------------------------------------- helpers
    def _send(self, msg: dict) -> bool:
        try:
            self.conn.send(msg)
            return True
        except protocol.ConnectionClosed:
            return False
