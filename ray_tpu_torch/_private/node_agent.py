"""Standalone node agent: joins a remote head over TCP.

A copy of `ray_tpu/_private/node_agent.py`. The node publishes a `GPU`
resource (`--num-gpus`, else `detect_num_gpus()`) where the JAX agent
publishes `TPU`, and its scheduler leases those cards by name (cards
0..n-1, as the agent's own `CUDA_VISIBLE_DEVICES` names them), pinning
each GPU lease's worker to its cards; its shm segments are the port's
`rtt_<tag>_...`.

The raylet-equivalent process (reference src/ray/raylet/main.cc): it
registers its resources with the head (reference
gcs/gcs_server/gcs_node_manager.h:62 HandleRegisterNode), runs the real
per-node ``Scheduler`` + worker pool locally, owns a local shm object
store, and serves chunked object pulls so a worker on another host can
read objects produced here (reference object_manager/object_manager.cc).

Topology:
- one control connection agent -> head (registration, heartbeats,
  routed specs, relayed worker control-plane traffic, task-done events);
- a local TCP listener for (a) this node's worker subprocesses and
  (b) object pulls from the head or peer agents;
- on-demand data connections to peer agents for cross-host gets.

Division of labor with the head: placement, actor bookkeeping,
refcounts, the object *directory*, and waiter parking are head-side;
dispatch, the resource ledger, worker lifecycles, and object *bytes*
are agent-side. Small task results are forwarded inline to the head
(owner-inline parity, reference core_worker.h AllocateReturnObject);
large ones stay local and register a location.

Run: ``python -m ray_tpu_torch._private.node_agent --head HOST:PORT
[--num-cpus N] [--num-gpus N] [--resources JSON] [--bind HOST]
[--advertise HOST]``
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from ray_tpu_torch._private import direct_actor as _da
from ray_tpu_torch._private import metrics_plane as _mp
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.config import CONFIG as _CFG
from ray_tpu_torch._private.object_store import (LocalStore, StoredObject,
                                           unlink_segment)
from ray_tpu_torch._private.object_transfer import (OBJECT_PLANE_STATS,
                                              PullServer, materialize)
from ray_tpu_torch._private.pull_manager import PullManager
from ray_tpu_torch._private.scheduler import Scheduler
from ray_tpu_torch._private.specs import ActorSpec

import logging

log = logging.getLogger(__name__)

HEARTBEAT_PERIOD_S = 0.5


class _AgentFacade:
    """The tiny runtime interface Scheduler drives; every callback
    becomes a NODE_EVENT to the head."""

    def __init__(self, agent: "NodeAgent"):
        self._agent = agent

    def on_task_dispatched(self, spec, worker_id: str) -> None:
        if spec.task_id in self._agent._lease_of:
            # delegated task (r10): the head is no longer a per-task
            # participant — it learns the terminal state from the
            # coalesced done batch; per-dispatch events are the frames
            # delegation exists to eliminate
            self._agent._delegate_stats["dispatch_events_suppressed"] \
                += 1
            return
        self._agent.send_event("task_dispatched", key=spec.task_id,
                               name=spec.name, worker_id=worker_id)

    def on_actor_dispatched(self, spec, worker_id: str) -> None:
        self._agent.send_event("actor_dispatched",
                               key="actor:" + spec.actor_id,
                               actor_id=spec.actor_id, worker_id=worker_id)

    def on_unplaceable(self, spec, reason: str) -> None:
        # a leased task that can never run here is off this agent's
        # book (the head fails/re-places it from the event) — consume
        # its lease or the ledger entry leaks for the agent's lifetime
        if getattr(spec, "task_id", None):
            self._agent._lease_done(spec.task_id)
        self._agent.send_event("unplaceable", spec=spec, reason=reason)


class NodeAgent:
    def __init__(self, head_addr: tuple[str, int],
                 resources: dict[str, float],
                 labels: Optional[dict] = None,
                 max_workers: Optional[int] = None,
                 bind_host: str = "0.0.0.0",
                 advertise_host: Optional[str] = None,
                 node_id: Optional[str] = None):
        self.head_addr = head_addr
        self.store = LocalStore()
        self._stop = threading.Event()
        # r10: shared epoll/select read loop for every connection this
        # agent owns (head control conn, local workers, peer pullers);
        # None (RAY_TPU_EPOLL=0) restores thread-per-connection.
        self._poller = protocol.make_poller()
        self._fetch_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="rtpu-agent-fetch")
        self._pull_server = PullServer(self.store,
                                       executor=self._fetch_pool)
        # peer agent data connections, keyed by (host, port)
        self._peers: dict[tuple[str, int], protocol.Connection] = {}
        self._peer_lock = threading.Lock()
        # Pull manager (reference pull_manager.cc): dedups concurrent
        # fetches of one object into one transfer, bounds in-flight
        # transfers/bytes, and sources chunks from ANY holder the
        # directory reports — completed pulls register this node as a
        # replica so it can serve its broadcast subtree / later readers.
        self._pull_mgr = PullManager(
            self.store, sources_fn=self._pull_sources,
            on_complete=self._on_pull_complete,
            on_source_failed=self._on_pull_source_failed,
            on_partial=self._on_pull_partial,
            on_partial_failed=self._on_pull_partial_failed)

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind_host, 0))
        self._listener.listen(128)
        port = self._listener.getsockname()[1]

        # Scheduler BEFORE registration: the instant the head learns of
        # this node it may route specs here, and the connection reader
        # must have a scheduler to hand them to. The agent mints its own
        # node id for the same reason.
        import uuid as _uuid
        self.node_id = node_id or ("node_" + _uuid.uuid4().hex[:8])
        _tp.set_role("agent", self.node_id)
        self.scheduler = Scheduler(
            _AgentFacade(self), dict(resources),
            ("127.0.0.1", port),   # workers are host-local: loopback
            max_workers, node_id=self.node_id, cluster=None)
        self.scheduler.start()

        # head-reconnect state (reference: raylets tolerate GCS downtime
        # and re-register on GCS restart)
        self._reconnect_lock = threading.Lock()
        self._reconnecting = False
        self._fencing = False          # r17 fence reset in progress
        self.incarnation = 0           # r17 epoch (set at register)
        self._pending_relays: list = []          # (conn, msg) to replay
        # state-bearing fire-and-forget messages (task completions,
        # object locations, worker deaths) that failed during a head
        # outage — replayed on rejoin so results produced while the head
        # was down are not silently lost
        import collections as _collections
        self._pending_sends: _collections.deque = _collections.deque(
            maxlen=10_000)
        self._dropped_sends = 0
        # ---- delegated bulk leases (r10) ----
        # task_id -> lease_id for every task granted via
        # NODE_LEASE_BATCH and not yet completed/reclaimed/lost; the
        # membership test is what suppresses per-task dispatch events.
        self._lease_of: dict[str, str] = {}
        # lease_id -> {"granted", "consumed", "budget"} — grant/consume
        # accounting; a lease is pruned once fully consumed.
        self._leases: dict[str, dict] = {}
        self._lease_lock = threading.Lock()
        self._delegate_stats = {
            "lease_batches": 0, "tasks_leased": 0, "tasks_done": 0,
            "done_batches": 0, "dispatch_events_suppressed": 0,
            "revoked": 0,
        }
        # completion coalescing: plain-task TASK_DONEs park here and
        # flush as ONE NODE_TASK_DONE_BATCH (count/window thresholds;
        # any other state-bearing send flushes the buffer first so
        # worker_lost / refcount ordering is preserved)
        self._done_buf: list = []
        self._done_lock = threading.Lock()
        # counts TASK_DONE handlers in flight between their ledger pops
        # (scheduler FIFO / lease table) and their done-buffer park:
        # the rejoin report waits for 0 so a completing task can never
        # be invisible to every scan at once (it would be re-placed
        # and run twice)
        self._done_guard = 0
        self._done_cv = threading.Condition(self._done_lock)
        self._done_flusher = protocol.FlushLoop(
            self._flush_done_buf,
            lambda: _CFG.delegate_done_delay_ms,
            "rtpu-agent-done-flush")
        # r15 head HA: ring of recently SENT completion entries. A
        # batch can be TCP-delivered yet never processed by a dying
        # head, so on rejoin the tail of this ring (entries younger
        # than the outage minus RAY_TPU_HEAD_DONE_REPLAY_WINDOW_S) is
        # replayed — the head dedups against its rehydrated mirror,
        # making a head restart exactly-once instead of lossy.
        self._done_sent: _collections.deque = _collections.deque(
            maxlen=4096)
        self._head_lost_at: Optional[float] = None
        # ---- batched decref deltas (r16) ----
        # Worker DECREF/DECREF_BATCH traffic coalesces here as
        # per-object release counts and flushes as seq-numbered
        # NODE_DECREF_DELTA frames (collect-then-flush, the done-batch
        # discipline) toward a MINOR >= 7 head; the sent ring backs
        # the rejoin replay (head dedups by the per-node seq
        # watermark — the r15 done-replay rule extended to decrefs).
        self._decref_lock = threading.Lock()
        self._decref_buf: dict[str, int] = {}
        self._decref_seq = 0
        # serializes seq-assignment + SEND as one unit: the pacer
        # thread and an inline threshold flush racing could otherwise
        # emit seq N+1 before seq N, and the head's watermark dedup
        # would then drop frame N's releases permanently (done batches
        # tolerate reordering because they dedup per task id, not per
        # frame seq). Ordering: _decref_send_lock before _decref_lock,
        # never inverse.
        self._decref_send_lock = threading.Lock()
        self._decref_sent: _collections.deque = _collections.deque(
            maxlen=256)
        self._decref_stats = {
            "delta_frames": 0, "delta_entries": 0, "releases": 0,
            "forwarded": 0,
        }
        self._decref_flusher = protocol.FlushLoop(
            self._flush_decref_buf,
            lambda: _CFG.decref_delta_delay_ms,
            "rtpu-agent-decref-flush")
        # ---- direct actor call plane (r18): host side ----
        # Calls a remote caller dialed onto this node's listener,
        # forwarded to the actor's worker and awaiting its TASK_DONE;
        # the reply returns inline on the caller's connection, the
        # head never sees a frame. Worker death NACKs every pending
        # entry (redirect-to-head, started=True).
        self._direct_pending = _da.PendingDirectCalls()
        self._direct_stats = {"served": 0, "nacks": 0,
                              "served_bytes": 0}
        # ---- N10 heartbeat delta-sync ----
        self._hb_seq = 0
        self._hb_last_norm: Optional[dict] = None
        self._hb_conn = None
        # set by the NODE_HB_RESYNC handler (head-conn reader thread),
        # consumed ONLY by the heartbeat thread — a plain _hb_last_norm
        # reset could be overwritten mid-_heartbeat_payload and the
        # requested full snapshot silently lost
        self._hb_force_full = False
        self._labels = dict(labels or {})
        self._max_workers = max_workers
        self._resources = dict(resources)

        # initial dial retries briefly: agents are routinely started
        # before (or concurrently with) the head (`ray start` order
        # independence)
        dial_deadline = time.monotonic() + max(
            10.0, _CFG.agent_reconnect_window_s)
        while True:
            try:
                self.head = protocol.connect(
                    head_addr, self._handle_head_msg,
                    self._on_head_closed, name="head",
                    poller=self._poller)
                break
            except OSError:
                if time.monotonic() > dial_deadline:
                    raise
                time.sleep(0.3)
        if advertise_host is None:
            # The address peers should dial = the local address of our
            # outbound connection to the head (gethostbyname(hostname)
            # returns 127.0.1.1 on stock Debian /etc/hosts — useless to
            # a remote peer).
            advertise_host = self.head._sock.getsockname()[0]
        self.advertise_addr = (advertise_host, port)
        rep = self.head.request(
            {"type": protocol.NODE_REGISTER, "resources": resources,
             "labels": dict(labels or {}), "node_id": self.node_id,
             "advertise_addr": self.advertise_addr,
             "max_workers": max_workers}, timeout=30.0)
        assert rep.get("node_id") == self.node_id
        # r17: the epoch the head minted for this registration. The
        # head checks it connection-side (no per-frame bytes); we keep
        # it for logging and the fence handler's sanity check.
        self.incarnation = int(rep.get("incarnation") or 0)

        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rtpu-agent-accept", daemon=True)
        self._accept_thread.start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="rtpu-agent-hb", daemon=True)
        self._hb_thread.start()
        # metrics plane (r11): refresh this agent's sampled gauges
        # (delegate ledger, pull-manager in-flight) at scrape time
        _mp.set_sampler("agent", self._sample_metrics)

    # ------------------------------------------------------ lifecycles
    def _on_head_closed(self, conn) -> None:
        # the head pulls over its control connection: reap any pull
        # sessions it abandoned before deciding what the outage means
        self._pull_server.on_conn_closed(conn)
        if self._stop.is_set():
            return
        if conn is not self.head:
            # a SUPERSEDED head connection died (fence reset / rejoin
            # already swapped in a fresh one): not an outage
            return
        if self._head_lost_at is None:
            self._head_lost_at = time.monotonic()
        window = _CFG.agent_reconnect_window_s
        if window <= 0:
            # Orphaned agent: the head is the only control plane — exit.
            sys.stderr.write("ray_tpu_torch node_agent: head connection lost; "
                             "shutting down\n")
            self.shutdown()
            return
        with self._reconnect_lock:
            if self._reconnecting:
                return
            self._reconnecting = True
        threading.Thread(target=self._reconnect_loop, args=(window,),
                         name="rtpu-agent-reconnect", daemon=True).start()

    def _reconnect_loop(self, window: float) -> None:
        """Redial the head with backoff until it answers or the window
        expires. On success: re-register with the SAME node id plus a
        rejoin report (live actors, held objects) so a restarted head's
        rehydrated tables re-attach to this node's surviving state."""
        sys.stderr.write(f"ray_tpu_torch node_agent {self.node_id}: head "
                         f"connection lost; reconnecting for up to "
                         f"{window:.0f}s\n")
        import random as _random
        deadline = time.monotonic() + window
        backoff = max(0.05, _CFG.reconnect_backoff_base_s)
        cap = max(backoff, _CFG.reconnect_backoff_cap_s)
        while not self._stop.is_set():
            if time.monotonic() > deadline:
                sys.stderr.write("ray_tpu_torch node_agent: head did not come "
                                 "back; shutting down\n")
                self.shutdown()
                return
            # jittered exponential backoff (r17): a pod of agents
            # losing one head must not redial in lockstep, and the
            # doubling keeps a long outage from burning CPU on
            # connect attempts
            self._stop.wait(backoff * _random.uniform(0.5, 1.5))
            backoff = min(backoff * 2.0, cap)
            try:
                conn = protocol.connect(self.head_addr,
                                        self._handle_head_msg,
                                        self._on_head_closed, name="head",
                                        poller=self._poller)
            except OSError:
                continue
            # Swap BEFORE registering: the head may route work here the
            # instant it processes the register, and completions must go
            # out on the new connection, not the dead one.
            self.head = conn
            replay = self._replay_done_entries()
            dreplay = self._replay_decref_entries()
            try:
                rep = conn.request(
                    {"type": protocol.NODE_REGISTER,
                     "resources": self._resources,
                     "labels": self._labels, "node_id": self.node_id,
                     "advertise_addr": self.advertise_addr,
                     "max_workers": self._max_workers,
                     "rejoin": True,
                     "live_actors": self.scheduler.live_actors(),
                     "objects": self.store.held_objects(),
                     # r15: every task id this agent still owes the
                     # head (queued, running, leased, or with a
                     # completion in flight) — a restarted head
                     # re-places ONLY mirrored tasks absent from this
                     # set (they never arrived here)
                     "inflight_tasks": self._inflight_task_ids(replay)},
                    timeout=30.0)
                if rep.get("node_id") != self.node_id:
                    raise RuntimeError("rejoin refused")
                # Replay possibly-unprocessed sent completions FIRST
                # (they predate everything in the outage buffer); the
                # head dedups re-processed entries by the mirror pop.
                if replay:
                    conn.send({"type": protocol.NODE_TASK_DONE_BATCH,
                               "node_id": self.node_id, "done": replay,
                               "replayed": True})
                # replayed decref deltas keep their original seqs: a
                # restarted head's rehydrated watermark (or the live
                # head that already processed them) dedups each frame
                for f in dreplay:
                    conn.send(dict(f, replayed=True))
            except BaseException:
                try:
                    conn.close()
                except Exception:
                    pass
                continue
            # Flush buffered state messages BEFORE opening the direct-
            # send path (_reconnecting=False): a fresh DECREF overtaking
            # a buffered ADDREF would let a refcount dip to zero under a
            # live borrow.
            flush_failed = False
            flushed = 0
            while True:
                with self._reconnect_lock:
                    if not self._pending_sends:
                        self._reconnecting = False
                        relays, self._pending_relays = (
                            self._pending_relays, [])
                        break
                    batch = list(self._pending_sends)
                    self._pending_sends.clear()
                sent = 0
                try:
                    for m in batch:
                        conn.send(m)
                        sent += 1
                except protocol.ConnectionClosed:
                    # head bounced again mid-flush: keep the unsent tail
                    # (order-preserving) and redial — still reconnecting
                    tail = batch[sent:]
                    with self._reconnect_lock:
                        space = (self._pending_sends.maxlen
                                 - len(self._pending_sends))
                        overflow = len(tail) - space
                        if overflow > 0:
                            # evict the NEWEST buffered messages (they
                            # sort after the tail anyway) — loudly, like
                            # _append_pending_send
                            self._dropped_sends += overflow
                            sys.stderr.write(
                                f"ray_tpu_torch node_agent {self.node_id}: "
                                f"head-outage buffer overflow during "
                                f"re-flush; dropped {overflow} newest "
                                f"state message(s)\n")
                            for _ in range(min(
                                    overflow,
                                    len(self._pending_sends))):
                                self._pending_sends.pop()
                        self._pending_sends.extendleft(reversed(tail))
                    flush_failed = True
                    break
                flushed += sent
            if flush_failed:
                continue
            sys.stderr.write(f"ray_tpu_torch node_agent {self.node_id}: "
                             f"rejoined head ({len(replay)} sent "
                             f"completions replayed, {flushed} events + "
                             f"{len(relays)} requests flushed)\n")
            self._head_lost_at = None
            # marker AFTER the buffered backlog (connection FIFO): the
            # head defers its mirror reconcile until this arrives, so
            # buffered completions pop their mirror entries before any
            # resubmit decision is made
            try:
                conn.send({"type": protocol.NODE_EVENT,
                           "kind": "rejoin_drained",
                           "node_id": self.node_id})
            except protocol.ConnectionClosed:
                pass
            for wconn, msg in relays:
                if not wconn.closed:
                    self._relay_to_head(wconn, msg)
            return

    def _replay_done_entries(self) -> list:
        """Sent completion entries from just before the outage (the
        at-risk tail: delivered-but-maybe-unprocessed)."""
        window = _CFG.head_done_replay_window_s
        lost_at = self._head_lost_at
        if window <= 0 or lost_at is None:
            return []
        cutoff = lost_at - window
        with self._done_lock:
            return [e for ts, e in self._done_sent if ts >= cutoff]

    def _inflight_task_ids(self, replay: list) -> list:
        """Every task id still on this agent's books at rejoin time:
        leased/queued/running tasks, completions parked in the batch
        window, completions buffered through the outage, and the
        replay tail. The rehydrated head keeps these mirrored; the
        rest of its mirror re-places."""
        # Scan in the direction tasks MOVE (FIFO/lease ledgers ->
        # guard region -> done buffer): a task popped from the ledgers
        # before the first scan has a guard-counted handler in flight,
        # and the guard-wait below guarantees its done entry is parked
        # before the buffer snapshot — so a completing task is always
        # visible to at least one scan. (Holding _done_lock across the
        # scheduler scan instead would ABBA against dispatch, which
        # sends events — and thus flushes the done buffer — under the
        # scheduler lock.)
        ids = set(self.scheduler.known_task_ids())
        with self._lease_lock:
            ids.update(self._lease_of)
        with self._done_lock:
            deadline = time.monotonic() + 2.0
            while self._done_guard and time.monotonic() < deadline:
                self._done_cv.wait(0.1)
            ids.update(e.get("task_id") for e in self._done_buf)
        ids.update(e.get("task_id") for e in replay)
        with self._reconnect_lock:
            pending = list(self._pending_sends)
        for m in pending:
            t = m.get("type")
            if t == protocol.NODE_TASK_DONE_BATCH:
                ids.update(e.get("task_id") for e in m.get("done", ()))
            elif t == protocol.NODE_TASK_DONE:
                ids.add(m.get("task_id"))
            elif t == protocol.NODE_EVENT \
                    and m.get("kind") == "lease_reclaimed":
                # reclaimed specs ride back as an event: the head
                # re-places them from it — not lost, not resubmittable
                ids.update(s.task_id for s in m.get("specs", ()))
        ids.discard(None)
        return list(ids)

    def _buffer_relay(self, conn, msg: dict, depth: int = 0) -> bool:
        """Queue a worker request for replay after the head comes back;
        False when reconnection is off/over (caller drops the relay).
        If the reconnect already finished (the failure came from the OLD
        connection's futures), retry once on the new connection; a
        second failure buffers unconditionally — retrying again would
        recurse unboundedly against a flapping head."""
        if _CFG.agent_reconnect_window_s <= 0 or self._stop.is_set():
            return False
        with self._reconnect_lock:
            if self._reconnecting or depth >= 1:
                if len(self._pending_relays) >= 10_000:
                    return False
                self._pending_relays.append((conn, msg))
                return True
        self._relay_to_head(conn, msg, _retry_depth=depth + 1)
        return True

    def _sample_metrics(self) -> None:
        """Metrics-plane sampler: mirror the delegate-lease ledger and
        pull-manager occupancy into gauges (scrape-time only)."""
        m = _mp._metrics()
        with self._lease_lock:
            st = dict(self._delegate_stats)
            outstanding = len(self._lease_of)
        m.delegate.set_many(
            [({"counter": k}, float(v)) for k, v in st.items()]
            + [({"counter": "outstanding"}, float(outstanding))])
        with self._decref_lock:
            dst = dict(self._decref_stats,
                       buffered=len(self._decref_buf))
        m.decref_delta.set_many(
            [({"counter": k}, float(v)) for k, v in dst.items()])
        pm = self._pull_mgr.stats()
        m.pull_inflight.set(pm["inflight"])
        m.pull_inflight_bytes.set(pm["inflight_bytes"])
        m.direct_actor.set_many(
            [({"party": "agent", "counter": k}, float(v))
             for k, v in self._direct_stats.items()]
            + [({"party": "agent", "counter": "pending"},
                float(len(self._direct_pending)))])

    def shutdown(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        _mp.set_sampler("agent", None)
        self._done_flusher.stop()
        self._decref_flusher.stop()
        try:
            # graceful drain: completions still parked in the batch
            # window must reach the head, or it re-executes finished
            # tasks after declaring this node dead
            self._flush_done_buf()
        except Exception:
            pass
        try:
            # parked releases too, or they leak for the session
            self._flush_decref_buf()
        except Exception:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self.scheduler.shutdown()
        if self._poller is not None:
            self._poller.close()
        self.store.shutdown()
        from ray_tpu_torch._private.specs import SESSION_TAG_INHERITED
        if not SESSION_TAG_INHERITED:
            # standalone agent (own session tag -> sole owner of its
            # segments on this host): reap orphans from killed workers.
            # An agent co-located with a head inherits the head's tag
            # and leaves the sweep to the head's shutdown.
            from ray_tpu_torch._private.object_store import (
                sweep_session_segments)
            sweep_session_segments()

    def wait_forever(self) -> None:
        while not self._stop.is_set():
            time.sleep(0.2)

    # ------------------------------------------------------- heartbeat
    def _hb_normalize(self, key: str, value):
        """Comparison view of a heartbeat key for the N10 delta: strip
        fields that tick every beat without carrying information
        (worker ages, sample timestamps, and the wire counters' own
        per-heartbeat send cost), so a steady-state node's beats
        degenerate to seq + heartbeat presence instead of re-shipping
        the full worker table and ledgers each time."""
        if key == "workers":
            return [{k: v for k, v in row.items() if k != "age_s"}
                    for row in value]
        if key == "host_stats":
            return {k: v for k, v in value.items() if k != "ts"}
        if key == "wire":
            # every heartbeat send bumps tx_frames/tx_msgs by one, so
            # the raw counters ALWAYS differ beat-to-beat and the dict
            # would ride every delta forever. Subtract the beat count:
            # on an idle node both tick in lockstep and the normalized
            # view is constant (any fixed offset cancels); real task/
            # object traffic still changes it and ships the key.
            out = dict(value)
            for k in ("tx_frames", "tx_msgs"):
                if k in out:
                    out[k] -= self._hb_seq
            return out
        return value

    def _heartbeat_payload(self, last_spo: dict) -> tuple[dict, dict]:
        """(payload, serves_per_object sent) for one beat: the full
        snapshot, or — toward a MINOR >= 3 head — a seq-numbered delta
        carrying only the keys whose normalized value changed since
        the last beat (N10: heartbeats carry resource DELTAS; full
        snapshot on reconnect, or when the head reports a seq gap via
        NODE_HB_RESYNC)."""
        spo = self._pull_server.serves_per_object()
        plane = {
            **OBJECT_PLANE_STATS,
            "sessions": self._pull_server.session_count(),
            **{"pull_" + k: v
               for k, v in self._pull_mgr.stats().items()},
        }
        if spo != last_spo:
            plane["serves_per_object"] = spo
        with self._lease_lock:
            delegate = dict(self._delegate_stats,
                            outstanding=len(self._lease_of),
                            open_leases=len(self._leases))
        snap = {
            # agent-process frame counters (r7 frame engine
            # telemetry): plain int dict, rides the structural
            # node plane like the rest of the heartbeat
            "wire": dict(protocol.WIRE_STATS),
            # object-plane counters (r8): transfers, bytes,
            # dedup hits, per-object serve counts — the head
            # aggregates these in object_plane_stats
            "object_plane": plane,
            # tracing plane (r9): watermark ONLY — events move
            # via the trace_dump pull, never on heartbeats
            "trace_watermark": _tp.recorder().watermark(),
            # delegated-lease accounting (r10)
            "delegate": delegate,
            # direct actor plane host counters (r18)
            "direct": dict(self._direct_stats),
            **self.scheduler.heartbeat_snapshot(),
        }
        head = self.head
        if head is not self._hb_conn:
            # fresh connection (initial or post-reconnect): the head's
            # handle has no prior state — full snapshot, reset the base
            self._hb_last_norm = None
            self._hb_conn = head
        if not head.peer_speaks_delegate():
            return snap, spo             # pre-delta head: full beats
        norm = {k: self._hb_normalize(k, v) for k, v in snap.items()}
        self._hb_seq += 1
        if self._hb_force_full:
            self._hb_force_full = False
            last = None                 # head asked for a resync
        else:
            last = self._hb_last_norm
        self._hb_last_norm = norm
        if last is None:
            return dict(snap, hb_seq=self._hb_seq), spo
        delta = {k: snap[k] for k in snap if norm[k] != last.get(k)}
        delta["hb_seq"] = self._hb_seq
        delta["hb_delta"] = True
        return delta, spo

    def _heartbeat_loop(self) -> None:
        last_spo: dict = {}
        while not self._stop.is_set():
            # During a head outage the reconnect loop owns the socket:
            # skip the beat entirely (r17) instead of building a
            # payload and hammering the dead connection every 0.5 s —
            # the rejoin's register + outage-buffer flush is what
            # matters, and the post-swap connection check below resets
            # the delta base for a full first beat anyway.
            with self._reconnect_lock:
                reconnecting = self._reconnecting
            if reconnecting or self._fencing:
                self._stop.wait(HEARTBEAT_PERIOD_S)
                continue
            try:
                # per-object serve counts ride the heartbeat only when
                # they CHANGED (the head merges, keeping its last copy):
                # a steady-state cluster must not pay for a 128-entry
                # debug table twice a second per node
                payload, spo = self._heartbeat_payload(last_spo)
                self.head.send({
                    "type": protocol.NODE_HEARTBEAT,
                    "node_id": self.node_id,
                    **payload,
                })
                last_spo = spo          # only after a successful send
            except protocol.ConnectionClosed:
                # head outage: keep the thread alive — self.head is
                # swapped for a fresh connection on successful rejoin
                pass
            except Exception:
                # never let a transient snapshot/serialize error kill the
                # heartbeat thread — a silent exit here reads as node
                # death at the head
                log.exception("heartbeat send failed; retrying")
            self._stop.wait(HEARTBEAT_PERIOD_S)

    def _send_to_head(self, msg: dict, _flush_done: bool = True) -> None:
        """Fire-and-forget send that buffers during a head outage (the
        reconnect flush replays it) instead of dropping state. The
        reconnecting check comes BEFORE the direct send: once the new
        connection is live but the buffer has not drained, a direct send
        would overtake buffered messages (a fresh DECREF beating a
        buffered ADDREF lets a refcount dip to zero under a live
        borrow). Any state-bearing send drains the parked completion
        batch FIRST (same rule as the wire coalescer's eager-send
        drain): a worker_lost event must never overtake the done
        entries of tasks that worker already finished — the head would
        resubmit finished work."""
        if _flush_done and self._done_buf:
            self._flush_done_buf()
        for _attempt in range(2):
            if _CFG.agent_reconnect_window_s > 0:
                with self._reconnect_lock:
                    if self._reconnecting:
                        self._append_pending_send(msg)
                        return
            try:
                self.head.send(msg)
                return
            except protocol.ConnectionClosed:
                if (_CFG.agent_reconnect_window_s <= 0
                        or self._stop.is_set()):
                    return
                # loop: either the outage was just detected (branch
                # above buffers next pass) or the reconnect finished
                # between our read of self.head and the failed send —
                # retry once on the fresh connection
        with self._reconnect_lock:
            self._append_pending_send(msg)

    def _append_pending_send(self, msg: dict) -> None:
        """Append under _reconnect_lock; a full buffer evicts the
        OLDEST message — make that loss loud, it can strand a caller."""
        if len(self._pending_sends) == self._pending_sends.maxlen:
            self._dropped_sends += 1
            if self._dropped_sends == 1 or self._dropped_sends % 1000 == 0:
                sys.stderr.write(
                    f"ray_tpu_torch node_agent {self.node_id}: head-outage "
                    f"buffer full; dropped {self._dropped_sends} oldest "
                    f"state message(s) — task completions/refcounts may "
                    f"be lost\n")
        self._pending_sends.append(msg)

    def send_event(self, kind: str, **fields) -> None:
        self._send_to_head({"type": protocol.NODE_EVENT, "kind": kind,
                            "node_id": self.node_id, **fields})

    # ----------------------------------------------- head-sent messages
    def _handle_head_msg(self, conn: protocol.Connection,
                         msg: dict) -> None:
        mtype = msg["type"]
        if mtype == protocol.NODE_ENQUEUE:
            self.scheduler.enqueue(msg["spec"])
        elif mtype == protocol.NODE_LEASE_BATCH:
            self._on_lease_batch(msg)
        elif mtype == protocol.NODE_LEASE_REVOKE:
            self._on_lease_revoke(conn, msg)
        elif mtype == protocol.NODE_FIND_TASK:
            hit = self.scheduler.find_task(msg["task_id"])
            conn.reply(msg, state=hit[0] if hit else None,
                       worker_id=hit[1] if hit else None)
        elif mtype == protocol.NODE_HB_RESYNC:
            # head saw a heartbeat seq gap: next beat ships the full
            # snapshot (flag, not a base reset: the heartbeat thread
            # may be mid-payload and would overwrite a cleared base)
            self._hb_force_full = True
        elif mtype == protocol.NODE_CANCEL_PENDING:
            spec = self.scheduler.cancel_pending(msg["task_id"])
            if spec is not None:
                self._lease_done(spec.task_id)
            conn.reply(msg, found=spec is not None)
        elif mtype == protocol.NODE_CANCEL_RUNNING:
            self.scheduler.cancel_running(msg["worker_id"], msg["task_id"])
        elif mtype == protocol.NODE_KILL_WORKER:
            self.scheduler.kill_worker(msg["worker_id"])
        elif mtype == protocol.NODE_SEND_ACTOR_TASK:
            ok = self.scheduler.send_actor_task(msg["worker_id"],
                                                msg["spec"])
            if not ok:
                self.send_event("actor_task_undeliverable",
                                actor_id=msg["spec"].actor_id,
                                spec=msg["spec"])
        elif mtype == protocol.NODE_RESERVE_BUNDLE:
            ok = self.scheduler.reserve_bundle(
                msg["pg_id"], msg["index"], msg["resources"])
            conn.reply(msg, ok=ok)
        elif mtype == protocol.NODE_RELEASE_BUNDLE:
            self.scheduler.release_bundle(msg["pg_id"], msg["index"])
        elif mtype == protocol.NODE_DELETE_OBJECT:
            self.store.delete(msg["object_id"])
        elif mtype == protocol.PULL_OBJECT:
            self._pull_server.handle_pull(conn, msg)
        elif mtype == protocol.PULL_CHUNK:
            self._pull_server.handle_chunk(conn, msg)
        elif mtype == protocol.BCAST_PLAN:
            OBJECT_PLANE_STATS["bcast_plans"] += 1
            self._fetch_pool.submit(self._run_bcast_plan, msg)
        elif mtype == protocol.TRACE_DUMP:
            # collection fans out to this node's workers: run on a
            # dedicated thread — never on the head connection's reader
            # (it must keep reading the worker replies), and never on
            # the fetch pool (its threads block up to bcast_timeout_s
            # in object pulls — exactly when timelines get requested)
            threading.Thread(target=self._trace_dump_reply,
                             args=(conn, msg),
                             name="rtpu-agent-trace-dump",
                             daemon=True).start()
        elif mtype == protocol.METRICS_DUMP:
            # same off-loop rule as TRACE_DUMP: the fan-out to this
            # node's workers blocks on replies that arrive on the
            # shared poller thread
            threading.Thread(target=self._metrics_dump_reply,
                             args=(conn, msg),
                             name="rtpu-agent-metrics-dump",
                             daemon=True).start()
        elif mtype == protocol.NODE_FENCED:
            # off the reader thread: the reset kills workers, redials
            # the head, and blocks in a register request — none of
            # which may run on the shared poller loop
            threading.Thread(target=self._on_fenced, args=(msg,),
                             name="rtpu-agent-fenced",
                             daemon=True).start()
        elif mtype == protocol.NODE_SHUTDOWN:
            self.shutdown()
        elif mtype == protocol.PING:
            conn.reply(msg, ok=True)

    # ------------------------------------- incarnation fencing (r17)
    def _on_fenced(self, msg: dict) -> None:
        """The head declared this node dead while it was alive (we
        were partitioned / stalled past the death timeout) and has
        re-placed everything we owed it. Our in-flight work, parked
        completions, and buffered releases now belong to a SUPERSEDED
        incarnation — finishing or flushing any of it would double-
        count against the re-placed winners (the head would fence the
        frames anyway). Reset: kill the workers, clear every ledger,
        re-register fresh."""
        with self._reconnect_lock:
            if self._fencing or self._stop.is_set():
                return
            self._fencing = True
        sys.stderr.write(
            f"ray_tpu_torch node_agent {self.node_id}: FENCED by head "
            f"(stale incarnation {self.incarnation}; current "
            f"{msg.get('incarnation')}) — killing workers, clearing "
            f"ledgers, re-registering fresh\n")
        try:
            self._fence_reset()
        finally:
            with self._reconnect_lock:
                self._fencing = False

    def _fence_reset(self) -> None:
        # 1. workers + local scheduling state (the dispatch loop keeps
        #    running; fresh workers spawn for post-rejoin work)
        self.scheduler.reset_for_fence()
        # 2. every agent-side ledger and replay ring: nothing from the
        #    fenced incarnation may ever be (re)sent
        with self._lease_lock:
            self._lease_of.clear()
            self._leases.clear()
        with self._done_lock:
            self._done_buf.clear()
            self._done_sent.clear()
        with self._decref_send_lock:
            with self._decref_lock:
                self._decref_buf.clear()
                self._decref_sent.clear()
                self._decref_seq = 0   # fresh register resets the
                                       # head's watermark to match
        with self._reconnect_lock:
            self._pending_sends.clear()
            self._pending_relays = []
            self._reconnecting = False
        self._head_lost_at = None
        # 3. fresh connection + FRESH (non-rejoin) registration: the
        #    old epoch's state is gone by design, so there is nothing
        #    to replay — rejoin semantics would re-attach exactly the
        #    zombie state the fence exists to discard
        old = self.head
        deadline = time.monotonic() + max(
            10.0, _CFG.agent_reconnect_window_s)
        conn = None
        while not self._stop.is_set():
            try:
                conn = protocol.connect(
                    self.head_addr, self._handle_head_msg,
                    self._on_head_closed, name="head",
                    poller=self._poller)
                break
            except OSError:
                if time.monotonic() > deadline:
                    self.shutdown()
                    return
                self._stop.wait(0.3)
        if conn is None:
            return
        self.head = conn               # swap BEFORE closing the old
        try:
            old.close()
        except Exception:
            pass
        try:
            rep = conn.request(
                {"type": protocol.NODE_REGISTER,
                 "resources": self._resources, "labels": self._labels,
                 "node_id": self.node_id,
                 "advertise_addr": self.advertise_addr,
                 "max_workers": self._max_workers}, timeout=30.0)
            if rep.get("node_id") != self.node_id:
                raise RuntimeError("re-register refused")
            self.incarnation = int(rep.get("incarnation") or 0)
        except BaseException:
            # register failed (head flapping): close the fresh conn —
            # its on_close fires the ordinary reconnect machinery,
            # which rejoins against our (now empty) state
            try:
                conn.close()
            except Exception:
                pass
            return
        # 4. re-advertise object copies that survived the fence (real
        #    bytes in our store; the death recovery purged their
        #    locations) so getters and lineage stop regenerating them
        for oid, nbytes in self.store.held_objects():
            self.send_event("object_at", object_id=oid, nbytes=nbytes,
                            addref=False)
        sys.stderr.write(
            f"ray_tpu_torch node_agent {self.node_id}: re-registered fresh "
            f"as incarnation {self.incarnation}\n")

    # ------------------------------------------ delegated leases (r10)
    def _on_lease_batch(self, msg: dict) -> None:
        """A bulk task lease from the head: record the grant, then
        queue every spec under ONE scheduler lock round-trip. From
        here on this agent schedules the batch against its own worker
        pool; the head hears back only through the coalesced done
        batches (and worker_lost/unplaceable events)."""
        specs = msg["specs"]
        lease_id = msg.get("lease_id", "")
        with self._lease_lock:
            self._leases[lease_id] = {
                "granted": len(specs), "consumed": 0,
                "budget": dict(msg.get("budget") or {})}
            for s in specs:
                self._lease_of[s.task_id] = lease_id
            self._delegate_stats["lease_batches"] += 1
            self._delegate_stats["tasks_leased"] += len(specs)
        self.scheduler.enqueue_many(specs)

    def _lease_done(self, task_id: str) -> Optional[str]:
        """Consume a task from its lease (completion, revoke, loss);
        prunes the lease once fully consumed. Returns the lease id if
        the task was delegated."""
        with self._lease_lock:
            lease_id = self._lease_of.pop(task_id, None)
            if lease_id is None:
                return None
            led = self._leases.get(lease_id)
            if led is not None:
                led["consumed"] += 1
                if led["consumed"] >= led["granted"]:
                    self._leases.pop(lease_id, None)
            return lease_id

    def _on_lease_revoke(self, conn: protocol.Connection,
                         msg: dict) -> None:
        """Reclaim queued-not-started tasks for the head (revoke /
        steal). The scheduler pulls pending-queue entries out
        synchronously and probes worker FIFOs through the r6
        UNQUEUE_TASK tombstone machinery; anything already started
        stays here and completes through the normal done path.

        The hand-back is a fire-and-forget ``lease_reclaimed`` NODE
        EVENT through _send_to_head — NOT a request reply — so it is
        buffered across head outages and replayed on rejoin: once the
        specs leave this agent's queue, a slow or dropped reply can
        never strand them (the head re-places from the event)."""
        def _handback(specs: list) -> None:
            if not specs:
                return

            def _send() -> None:
                for s in specs:
                    self._lease_done(s.task_id)
                with self._lease_lock:
                    self._delegate_stats["revoked"] += len(specs)
                self.send_event("lease_reclaimed", specs=specs)

            # off the caller's thread: _handback fires on the head/
            # worker connection reader (with the r10 poller, THE loop
            # thread), and send_event is a blocking head send — a
            # backpressured head must stall this hand-back, never the
            # agent's entire read loop
            threading.Thread(target=_send, name="rtpu-agent-reclaim",
                             daemon=True).start()

        self.scheduler.reclaim_tasks(list(msg.get("task_ids", ())),
                                     _handback)

    # --------------------------------- coalesced completions (r10)
    def _delegates_to_head(self) -> bool:
        return bool(_CFG.delegate) and self.head.peer_speaks_delegate()

    def _park_done(self, entry: dict) -> None:
        """Queue one plain-task completion for the next
        NODE_TASK_DONE_BATCH (collect-then-flush via the shared
        FlushLoop pacer: first entry opens a delegate_done_delay_ms
        window, delegate_done_batch entries flush inline)."""
        with self._done_lock:
            self._done_buf.append(entry)
            n = len(self._done_buf)
        if n >= max(1, _CFG.delegate_done_batch):
            self._flush_done_buf()
        else:
            self._done_flusher.wake()

    def _flush_done_buf(self) -> None:
        with self._done_lock:
            if not self._done_buf:
                return
            batch, self._done_buf = self._done_buf, []
            self._delegate_stats["done_batches"] += 1
            # retain what we are about to SEND (r15): the rejoin replay
            # re-ships the pre-outage tail of this ring, covering the
            # delivered-but-never-processed window of a dying head
            now = time.monotonic()
            self._done_sent.extend((now, e) for e in batch)
        self._send_to_head({"type": protocol.NODE_TASK_DONE_BATCH,
                            "node_id": self.node_id, "done": batch},
                           _flush_done=False)

    # ------------------------------- batched decref deltas (r16)
    def _delta_decrefs_to_head(self) -> bool:
        return (bool(_CFG.decref_delta)
                and self.head.peer_speaks_decref_delta())

    def _on_worker_decref(self, msg: dict) -> None:
        """A worker released references: coalesce into the per-object
        delta buffer (one NODE_DECREF_DELTA frame per flush window
        instead of forwarding every DECREF_BATCH), falling back to
        plain forwarding toward a pre-MINOR-7 head or with
        RAY_TPU_DECREF_DELTA=0."""
        if not self._delta_decrefs_to_head():
            self._decref_stats["forwarded"] += 1
            self._send_to_head(dict(msg))
            return
        ids = (msg.get("object_ids") if msg["type"]
               == protocol.DECREF_BATCH else [msg["object_id"]])
        with self._decref_lock:
            buf = self._decref_buf
            for oid in ids:
                buf[oid] = buf.get(oid, 0) + 1
            self._decref_stats["releases"] += len(ids)
            n = len(buf)
        if n >= max(1, _CFG.decref_delta_max):
            self._flush_decref_buf()
        else:
            self._decref_flusher.wake()

    def _flush_decref_buf(self) -> None:
        """Drain the delta buffer as one-or-more NODE_DECREF_DELTA
        frames (<= 64 entries each — the wire's structural dict
        bound). Frames are seq-numbered under the buffer lock and
        retained in the sent ring for the rejoin replay; a head
        outage parks them in the ordinary outage buffer, so ordering
        and replay both ride the existing machinery."""
        with self._decref_send_lock:
            while True:
                with self._decref_lock:
                    if not self._decref_buf:
                        return
                    buf = self._decref_buf
                    if len(buf) <= 64:
                        counts, self._decref_buf = buf, {}
                    else:
                        counts = {}
                        for oid in list(buf)[:64]:
                            counts[oid] = buf.pop(oid)
                    self._decref_seq += 1
                    frame = {"type": protocol.NODE_DECREF_DELTA,
                             "node_id": self.node_id,
                             "seq": self._decref_seq, "counts": counts}
                    self._decref_stats["delta_frames"] += 1
                    self._decref_stats["delta_entries"] += len(counts)
                    self._decref_sent.append((time.monotonic(), frame))
                # still under the SEND lock: frames leave in seq order
                self._send_to_head(frame, _flush_done=False)

    def _replay_decref_entries(self) -> list:
        """Sent delta frames from just before the outage (the at-risk
        delivered-but-maybe-unprocessed tail, the done-entry replay
        rule): the head drops any frame at or below its per-node seq
        watermark, so over-replaying is free."""
        window = _CFG.head_done_replay_window_s
        lost_at = self._head_lost_at
        if window <= 0 or lost_at is None:
            return []
        cutoff = lost_at - window
        with self._decref_lock:
            return [f for ts, f in self._decref_sent if ts >= cutoff]

    def _trace_dump_reply(self, conn: protocol.Connection,
                          msg: dict) -> None:
        """Drain this node's recorders: the agent's own first (the
        head keys its clock alignment off it), then each local
        worker's, with worker clock offsets relative to THIS agent
        (the head adds its agent offset transitively)."""
        procs = [dict(_tp.dump(), offset_ns=0, node_id=self.node_id)]
        # parallel fan-out under one shared deadline inside the
        # head's collection budget (carried on the message; a margin
        # is reserved for the reply hop): a few wedged workers must
        # not push this node past the head's deadline and drop the
        # whole node (incl. healthy workers) from the dump
        budget = max(0.5, float(msg.get("timeout", 3.0)) - 1.0)
        for wid, t0, t1, rep in _tp.fanout_dumps(
                list(self.scheduler.worker_conns()), budget):
            d = rep.get("dump")
            if d:
                procs.append(dict(
                    d, node_id=self.node_id,
                    offset_ns=_tp.rtt_offset(t0, t1, d["now_ns"])))
        try:
            # fresh clock sample AFTER the worker drain: the head
            # derives this node's offset from it, and an entry-time
            # sample would be stale by however long the drain took
            conn.reply(msg, processes=procs, now_ns=_tp.now())
        except protocol.ConnectionClosed:
            pass

    def _metrics_dump_reply(self, conn: protocol.Connection,
                            msg: dict) -> None:
        """Drain this node's metrics registries: the agent's own plus
        each local worker's, under a budget inside the head's
        collection deadline (a wedged worker must not drop the whole
        node from the scrape)."""
        procs = [dict(_mp.local_dump(), worker="")]
        budget = max(0.5, float(msg.get("timeout", 3.0)) - 1.0)
        for wid, t0, t1, rep in _tp.fanout_dumps(
                list(self.scheduler.worker_conns()), budget,
                mtype=protocol.METRICS_DUMP):
            d = rep.get("dump")
            if d and d.get("metrics"):
                procs.append(dict(d, worker=wid))
        try:
            conn.reply(msg, processes=procs)
        except protocol.ConnectionClosed:
            pass

    def _run_bcast_plan(self, msg: dict) -> None:
        """Tree-broadcast leg: pull the object from the parent the head
        named (falling back to any directory holder), store it, and
        register — which unlocks this node's own subtree head-side."""
        oid = msg["object_id"]
        if self.store.contains(oid):
            # already hold a copy through another path: (re)register so
            # the coordinator sees this node complete
            self.send_event("object_at", object_id=oid,
                            nbytes=msg.get("nbytes", 0), addref=False)
            return
        # each tree hop is one span parented under the coordinator's
        # broadcast span (envelope-carried), so the cascade's depth
        # and stalls read straight off the timeline
        with _tp.span("bcast", "hop:" + oid[:12],
                      ctx=msg.get("_trace")):
            self._pull_mgr.pull(oid, prefer=msg.get("source"),
                                timeout=_CFG.bcast_timeout_s)

    # ------------------------------------------------ local connections
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = protocol.Connection(sock, self._handle_local_msg,
                                       self._on_local_closed,
                                       name="agent-local", server=True,
                                       poller=self._poller)
            conn.start()

    def _on_local_closed(self, conn: protocol.Connection) -> None:
        # peer/head pullers dial the local listener: reap the pull
        # sessions a dying puller left open (blob + object pin)
        self._pull_server.on_conn_closed(conn)
        wid = conn.meta.get("worker_id")
        if wid is None or self._stop.is_set():
            return
        tasks, actor_id = self.scheduler.on_worker_lost(wid)
        # r18: every direct call pending on the dead worker NACKs
        # redirect-to-head with started=True (ambiguous — the head's
        # retry budget decides requeue vs ActorDiedError)
        for _tid, dconn, rid in \
                self._direct_pending.pop_worker(wid):
            self._direct_stats["nacks"] += 1
            _da.nack(dconn, rid, "worker_died", True)
        if tasks:
            # the dead worker may have sealed result shm on THIS host
            # without delivering TASK_DONE — reap locally (the head's
            # reap only covers its own /dev/shm)
            from ray_tpu_torch._private.object_store import reap_object_segments
            for task in tasks:
                for oid in task.return_ids:
                    reap_object_segments(oid)
                # lease bookkeeping: the head will recover these via
                # the worker_lost event; they are off this agent's book
                self._lease_done(task.task_id)
        # send_event drains the parked done batch first (ordering:
        # completions the dead worker DID deliver must reach the head
        # before the loss event, or they'd be resubmitted)
        self.send_event("worker_lost", worker_id=wid, tasks=tasks,
                        actor_id=actor_id)

    def _handle_local_msg(self, conn: protocol.Connection,
                          msg: dict) -> None:
        """Messages from this host's workers (and peer pullers)."""
        mtype = msg["type"]
        if mtype == protocol.REGISTER:
            self.scheduler.on_worker_registered(msg["worker_id"], conn)
            # surfaced via workers_snapshot rows in heartbeats
            conn.meta["wire_native"] = bool(
                msg.get("wire_native", False))
            # r18 worker-direct serving port — rides the heartbeat's
            # worker rows so the head can resolve this worker as an
            # actor endpoint
            conn.meta["direct_port"] = msg.get("direct_port")
        elif mtype == protocol.TASK_DONE:
            self._on_task_done(conn, msg)
        elif mtype == protocol.GET_OBJECT:
            self._on_get_object(conn, msg)
        elif mtype == protocol.PUT_OBJECT:
            stored: StoredObject = msg["stored"]
            self.store.put_stored(stored)
            self.send_event("object_at", object_id=stored.object_id,
                            nbytes=stored.nbytes, addref=True,
                            contained=list(stored.contained_ids))
            conn.reply(msg, ok=True,
                       pressure=self.store.over_capacity())
        elif mtype == protocol.PULL_OBJECT:
            self._pull_server.handle_pull(conn, msg)
        elif mtype == protocol.PULL_CHUNK:
            self._pull_server.handle_chunk(conn, msg)
        elif mtype == protocol.ACTOR_TASK_DIRECT:
            self._on_actor_task_direct(conn, msg)
        elif mtype == protocol.ACTOR_INFLIGHT_DELTA:
            # a local caller's coalesced direct-call mirror: straight
            # through to the head (the add entries carry pins — they
            # must not wait out another batching window here)
            self._send_to_head(dict(msg))
        elif mtype in (protocol.WAIT, protocol.SUBMIT,
                       protocol.SUBMIT_ACTOR, protocol.SUBMIT_ACTOR_TASK,
                       protocol.KV_OP, protocol.STATE_OP,
                       protocol.ACTOR_RESOLVE):
            self._relay_to_head(conn, msg)
        elif mtype == protocol.ADDREF:
            # addrefs go straight through: delaying a release is
            # always safe (the delta buffer), delaying a borrow
            # registration is not
            self._send_to_head(dict(msg))
        elif mtype in (protocol.DECREF, protocol.DECREF_BATCH):
            self._on_worker_decref(msg)
        elif mtype == protocol.PING:
            conn.reply(msg, ok=True)

    def _relay_to_head(self, conn: protocol.Connection, msg: dict,
                       _retry_depth: int = 0) -> None:
        """Forward a request to the head; pipe the reply back. The
        worker's rid is restored on the way back (the head sees our
        fresh rid)."""
        worker_rid = msg.get("rid")
        is_wait = msg["type"] == protocol.WAIT
        wid = conn.meta.get("worker_id") if is_wait else None
        if wid:
            # a blocked waiter releases its resources (the agent owns
            # the ledger; the head owns the parking)
            self.scheduler.worker_blocked(wid)
        try:
            fut = self.head.request_async(dict(msg))
        except protocol.ConnectionClosed:
            if wid:
                self.scheduler.worker_unblocked(wid)
            # head outage: park the request for replay after rejoin
            # (reference raylets queue GCS RPCs across GCS restarts)
            self._buffer_relay(conn, msg, depth=_retry_depth)
            return

        def on_reply(fut) -> None:      # runs on head-conn reader thread
            try:
                rep = fut.result(timeout=0)
            except protocol.ConnectionClosed:
                if wid:
                    self.scheduler.worker_unblocked(wid)
                if not self._buffer_relay(conn, msg, depth=_retry_depth):
                    try:
                        conn.reply({"rid": worker_rid}, timeout=True)
                    except protocol.ConnectionClosed:
                        pass
                return
            except BaseException:
                rep = {}
            if wid:
                self.scheduler.worker_unblocked(wid)
            out = {k: v for k, v in rep.items()
                   if k not in ("rid", "type")}
            try:
                conn.reply({"rid": worker_rid}, **out)
            except protocol.ConnectionClosed:
                pass

        fut.add_done_callback(on_reply)

    # ------------------------------- direct actor call hosting (r18)
    def _on_actor_task_direct(self, conn: protocol.Connection,
                              msg: dict) -> None:
        """A caller dialed this node directly for an actor hosted
        here. Validate the endpoint is still current — the actor's
        worker alive and bound, this node's incarnation unchanged
        (fences callers holding a pre-fence endpoint), and the head
        reachable (a head-disconnected host may be a partitioned
        zombie whose actor the head is about to restart elsewhere:
        new calls must go back through the head) — then forward to
        the worker and remember the caller for the inline reply."""
        spec = msg["spec"]
        wid = msg.get("worker_id", "")
        with self._reconnect_lock:
            disconnected = self._reconnecting or self._fencing
        reason = None
        if (not _CFG.direct_actor or self._stop.is_set()
                or disconnected):
            reason = "host_head_disconnected"
        elif (msg.get("node_incarnation") is not None
              and msg["node_incarnation"] != self.incarnation):
            reason = "stale_incarnation"
        elif self.scheduler.worker_for_actor(
                msg.get("actor_id", "")) != wid:
            reason = "stale_endpoint"
        if reason is None:
            self._direct_pending.add(spec.task_id, conn,
                                     msg.get("rid"), wid)
            if self.scheduler.send_actor_task(wid, spec):
                self._direct_stats["served"] += 1
                return
            self._direct_pending.pop(spec.task_id)
            reason = "send_failed"
        self._direct_stats["nacks"] += 1
        _da.nack(conn, msg.get("rid"), reason, False)

    def _reply_direct_done(self, ent: tuple, msg: dict) -> None:
        """Answer a pending direct call from its worker's TASK_DONE.
        Small results ride the reply inline and the caller owns
        landing them (the driver seals into the head store in-process;
        a worker caller ships them head-ward on its coalesced delta) —
        this node keeps nothing. Large results seal HERE and the
        reply's `located` entries are the directory hints the caller
        registers with the head, so the existing pull path serves any
        getter."""
        conn, rid, _wid = ent
        inline, located = [], []
        for stored in msg.get("results", ()):
            if (stored.nbytes <= _CFG.remote_inline_max_bytes
                    or stored.is_error):
                m = materialize(stored)
                inline.append(m)
                self._direct_stats["served_bytes"] += m.nbytes
                for name in stored.shm_names:
                    unlink_segment(name)
            else:
                self.store.put_stored(stored)
                located.append((stored.object_id, stored.nbytes,
                                self.node_id,
                                list(stored.contained_ids)))
        try:
            conn.reply({"rid": rid}, inline=inline, located=located,
                       error=bool(msg.get("error")),
                       error_repr=msg.get("error_repr"))
        except protocol.ConnectionClosed:
            # caller died mid-call: its delta can never land these
            # results head-ward — seal the materialized copies locally
            # and register locations so a third-party holder of the
            # return ref still resolves (head-routed parity)
            for m in inline:
                self.store.put_stored(m)
                self.send_event("object_at", object_id=m.object_id,
                                nbytes=m.nbytes, addref=False,
                                contained=list(m.contained_ids))

    # -------------------------------------------------- task completion
    def _on_task_done(self, conn: protocol.Connection, msg: dict) -> None:
        with self._done_lock:
            self._done_guard += 1
        try:
            self._on_task_done_inner(conn, msg)
        finally:
            with self._done_lock:
                self._done_guard -= 1
                self._done_cv.notify_all()

    def _on_task_done_inner(self, conn: protocol.Connection,
                            msg: dict) -> None:
        worker_id = conn.meta.get("worker_id", "")
        if msg.get("is_actor_task"):
            if msg.get("direct_located"):
                # r18 worker-direct large results: the worker already
                # answered its caller inline; these byte carriers just
                # need the node store + a directory hint — no done
                # routing, no scheduler bookkeeping
                for stored in msg.get("results", ()):
                    self.store.put_stored(stored)
                    self.send_event(
                        "object_at", object_id=stored.object_id,
                        nbytes=stored.nbytes, addref=False,
                        contained=list(stored.contained_ids))
                return
            # r18 direct plane: this completion belongs to a caller
            # dialed onto our listener — answer it inline on that
            # connection; the head hears nothing (the caller's
            # coalesced delta is its mirror).
            ent = self._direct_pending.pop(msg.get("task_id") or "")
            if ent is not None:
                self._reply_direct_done(ent, msg)
                return
        results: list[StoredObject] = msg.get("results", [])
        inline: list[StoredObject] = []
        located: list[tuple[str, int]] = []
        for stored in results:
            if stored.nbytes <= _CFG.remote_inline_max_bytes \
                    or stored.is_error:
                inline.append(materialize(stored))
                # inline copies are head-owned; drop local segments
                for name in stored.shm_names:
                    unlink_segment(name)
            else:
                self.store.put_stored(stored)
                located.append((stored.object_id, stored.nbytes,
                                list(stored.contained_ids)))
        # release the ledger before telling the head (the head may
        # immediately route the next task here)
        is_plain = not (msg.get("is_actor_create")
                        or msg.get("is_actor_task"))
        fin_spec = None
        if msg.get("is_actor_create"):
            self.scheduler.actor_ready(worker_id)
        elif msg.get("is_actor_task"):
            pass                       # actor keeps its resources
        else:
            fin_spec = self.scheduler.task_finished(
                worker_id, msg.get("task_id"),
                cuda_bound=msg.get("cuda_bound"))
        ctrl = {k: v for k, v in msg.items()
                if k not in ("results", "rid", "type")}
        entry = {"worker_id": worker_id, "inline": inline,
                 "located": located, **ctrl}
        if fin_spec is not None:
            # r17: echo the attempt this node executed — the head
            # drops terminal entries whose attempt trails the live
            # spec (first-terminal-wins across re-placements)
            entry["attempt"] = int(getattr(fin_spec, "attempt", 0))
        # consume the lease UNCONDITIONALLY for plain tasks — even
        # when the batch path below is momentarily off (e.g. a fresh
        # head reconnect whose wire version is still unobserved), the
        # ledger entry must not outlive the task
        delegated = (self._lease_done(msg.get("task_id", ""))
                     if is_plain else None)
        if delegated is not None and self._delegates_to_head():
            with self._lease_lock:
                self._delegate_stats["tasks_done"] += 1
            self._park_done(entry)     # rides the next done batch
            return
        self._send_to_head({"type": protocol.NODE_TASK_DONE,
                            "node_id": self.node_id, **entry})

    # ------------------------------------------------------ object gets
    def _on_get_object(self, conn: protocol.Connection, msg: dict) -> None:
        oid = msg["object_id"]
        stored = self.store.get_stored(oid, timeout=0, restore=False)
        if stored is not None:
            conn.reply(msg, stored=stored)
            return
        wid = conn.meta.get("worker_id")
        if wid:
            self.scheduler.worker_blocked(wid)
        self._fetch_pool.submit(self._fetch_and_reply, conn, msg, oid, wid)

    def _fetch_and_reply(self, conn, msg, oid: str,
                         wid: Optional[str]) -> None:
        try:
            stored = self._fetch(oid, msg.get("timeout"),
                                 trace=msg.get("_trace"))
            if stored is not None:
                conn.reply(msg, stored=stored)
            else:
                conn.reply(msg, stored=None, timeout=True)
        except protocol.ConnectionClosed:
            pass
        finally:
            if wid:
                self.scheduler.worker_unblocked(wid)

    def _fetch(self, oid: str, timeout: Optional[float],
               trace: Optional[tuple] = None) -> Optional[StoredObject]:
        """Local store (incl. spill restore), else head lookup, else
        pull-manager transfer from any holder. The head lookup BLOCKS
        head-side until the object exists somewhere or the timeout
        passes — the agent never polls; the actual transfer dedups,
        bounds, and multi-sources through the pull manager."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            stored = self.store.get_stored(oid, timeout=0)
            if stored is not None:
                return stored
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                rep = self.head.request(
                    {"type": protocol.OBJECT_LOOKUP, "object_id": oid,
                     "timeout": remaining},
                    timeout=None if remaining is None else remaining + 10)
            except (protocol.ConnectionClosed, TimeoutError):
                return None
            if rep.get("stored") is not None:
                return rep["stored"]
            if rep.get("head_pull"):
                prefer = {"head": True}
            else:
                loc = rep.get("location")
                if loc is None:
                    return None          # head-side timeout
                prefer = (loc if loc.get("node_id") != self.node_id
                          else None)
            stored = self._pull_mgr.pull(oid, prefer=prefer,
                                         timeout=remaining,
                                         trace_ctx=trace)
            if stored is not None:
                return stored
            # every source failed (holders died / evicted, or the only
            # registered copy is our own deleted-in-flight one): the
            # stale locations were dropped via on_source_failed —
            # re-enter the lookup until our deadline so lineage
            # resubmission has time to regenerate the object
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(0.1)

    # ---------------------------------------------- pull-manager hooks
    def _pull_sources(self, oid: str, prefer):
        """Source iterator for the pull manager: the preferred source
        first (broadcast parent / lookup hint), then every holder the
        directory reports (shuffled for load spread), then the head
        itself. Peer connections are dialed lazily per yield."""
        import random
        seen: set = set()
        my_addr = tuple(self.advertise_addr)

        def peer(loc):
            addr = (loc["host"], int(loc["port"]))
            if addr == my_addr:
                return None
            return self._peer_conn(addr)

        if prefer:
            if prefer.get("head"):
                seen.add("head")
                yield ("head", self.head)
            elif prefer.get("host") is not None:
                conn = peer(prefer)
                if conn is not None:
                    seen.add(prefer.get("node_id"))
                    yield (prefer.get("node_id") or
                           f"{prefer['host']}:{prefer['port']}", conn)
        try:
            rep = self.head.request(
                {"type": protocol.LOCATE_OBJECT, "object_id": oid},
                timeout=10.0)
        except (protocol.ConnectionClosed, TimeoutError):
            rep = {}
        locs = list(rep.get("locations") or ())
        random.shuffle(locs)
        # r17: suspect holders last (stable sort keeps the shuffle's
        # load spread within each group) — a gray-failing node must
        # not be the source a transfer gambles its deadline on
        locs.sort(key=lambda l: bool(l.get("suspect")))
        for loc in locs:
            nid = loc.get("node_id")
            if nid == self.node_id or nid in seen:
                continue
            conn = peer(loc)
            if conn is not None:
                seen.add(nid)
                yield (nid, conn)
        if rep.get("head_has") and "head" not in seen:
            yield ("head", self.head)

    def _on_pull_complete(self, oid: str, stored, source_id) -> None:
        """Replica registration: future readers may pull from us, the
        head's delete fan-out will reach this copy, and an active
        broadcast unlocks our subtree."""
        self._send_to_head({"type": protocol.OBJECT_ADDED,
                            "object_id": oid, "node_id": self.node_id,
                            "nbytes": stored.nbytes, "addref": False})

    def _on_pull_source_failed(self, oid: str, source_id) -> None:
        """Holder lost it (died / evicted): tell the directory so the
        stale location stops being handed out."""
        if source_id and source_id != "head":
            self._send_to_head({"type": protocol.OBJECT_REMOVED,
                                "object_id": oid,
                                "node_id": source_id})

    def _on_pull_partial(self, oid: str, nbytes: int) -> None:
        """Cut-through (r12): first chunk of a winning pull landed —
        register this node as a PARTIAL holder so the broadcast
        coordinator dispatches our subtree against the in-flight
        landing. Gated on the head demonstrating wire MINOR >= 5: an
        old head would record the partial entry as a FULL location and
        hand a half-landed copy to getters. Fire-and-forget WITHOUT
        the outage replay buffer — a partial add replayed after a head
        outage would be stale advisory state."""
        head = self.head
        if head is None or not head.peer_speaks_manifest():
            return
        try:
            head.send({"type": protocol.OBJECT_ADDED, "object_id": oid,
                       "node_id": self.node_id, "nbytes": nbytes,
                       "addref": False, "partial": True})
        except protocol.ConnectionClosed:
            pass

    def _on_pull_partial_failed(self, oid: str) -> None:
        """The transfer died after registering partial: retract the
        advisory location (children re-root via the directory)."""
        head = self.head
        if head is None or not head.peer_speaks_manifest():
            return
        try:
            head.send({"type": protocol.OBJECT_REMOVED, "object_id": oid,
                       "node_id": self.node_id})
        except protocol.ConnectionClosed:
            pass

    def _peer_conn(self, addr) -> Optional[protocol.Connection]:
        with self._peer_lock:
            conn = self._peers.get(addr)
            if conn is not None and not conn.closed:
                return conn
        try:
            conn = protocol.connect(tuple(addr), lambda c, m: None,
                                    name=f"peer-{addr[0]}:{addr[1]}",
                                    poller=self._poller)
        except OSError:
            return None
        with self._peer_lock:
            # two fetch threads may have dialed concurrently: keep the
            # winner already in the cache, close the loser
            existing = self._peers.get(tuple(addr))
            if existing is not None and not existing.closed:
                try:
                    conn.close()
                except Exception:
                    pass
                return existing
            self._peers[tuple(addr)] = conn
        return conn


def main(argv: Optional[list[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="ray_tpu_torch node agent")
    p.add_argument("--head", required=True,
                   help="head address HOST:PORT (from ray_tpu_torch.init on "
                        "the driver host)")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None,
                   help="the node's GPU resource (default: the cards "
                        "nvidia-smi lists, as many as "
                        "CUDA_VISIBLE_DEVICES leaves visible)")
    p.add_argument("--resources", type=str, default=None,
                   help="extra resources as JSON, e.g. '{\"accel\": 4}'")
    p.add_argument("--labels", type=str, default=None)
    p.add_argument("--max-workers", type=int, default=None)
    p.add_argument("--bind", type=str, default="0.0.0.0")
    p.add_argument("--advertise", type=str, default=None,
                   help="host peers should dial for object pulls "
                        "(default: autodetect; loopback when the head "
                        "is loopback)")
    p.add_argument("--node-id", type=str, default=None,
                   help="explicit node id (tests; default: generated)")
    args = p.parse_args(argv)

    host, port = args.head.rsplit(":", 1)
    from ray_tpu_torch._private.runtime import detect_num_gpus
    num_cpus = (args.num_cpus if args.num_cpus is not None
                else float(max(os.cpu_count() or 1, 4)))
    num_gpus = (args.num_gpus if args.num_gpus is not None
                else float(detect_num_gpus()))
    resources = {"CPU": float(num_cpus)}
    if num_gpus:
        resources["GPU"] = float(num_gpus)
    resources["memory"] = float(_CFG.node_memory_bytes)
    if args.resources:
        resources.update({k: float(v)
                          for k, v in json.loads(args.resources).items()})
    agent = NodeAgent(
        (host, int(port)), resources,
        labels=json.loads(args.labels) if args.labels else None,
        max_workers=args.max_workers, bind_host=args.bind,
        advertise_host=args.advertise, node_id=args.node_id)
    sys.stderr.write(f"ray_tpu_torch node_agent {agent.node_id} joined "
                     f"{args.head} (listening on "
                     f"{agent.advertise_addr[0]}:"
                     f"{agent.advertise_addr[1]})\n")
    try:
        agent.wait_forever()
    except KeyboardInterrupt:
        agent.shutdown()


if __name__ == "__main__":
    main()
