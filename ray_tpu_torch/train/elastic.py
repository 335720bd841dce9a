"""Elastic, preemption-tolerant data-parallel training (r14).

A copy of `ray_tpu/train/elastic.py` over `TorchTrainer`. The restore's
tar is `put` as `bytes`, which the object plane carries out of band (a
shm segment), so a checkpoint over `wire_max_frame_bytes` travels too.

A worker is a placement-group bundle (the JAX package's host): with
`gpus_per_worker=k` it runs k ranks, one a card, as `TorchTrainer`'s
group does. `num_workers`, `min_workers`, `max_workers`, the capacity
count and `final_world_size` count bundles; the process group, the
dataset split and the result rounds count ranks. So the group grows and
shrinks by whole bundles: a lost node takes its k ranks with it, and a
joining one brings k.

``fit_elastic`` composes the stack's existing fault-tolerance
primitives into one end-to-end path (ROADMAP open item 5): on node
loss OR gain mid-``fit()`` the worker group reshapes — the dp/fsdp
world shrinks to the surviving capacity or grows when a replacement
host joins, workers join a new ``torch.distributed`` process group
(each group is a fresh set of processes, so ``TorchBackend.on_start``
forms the group at the new size: nccl for workers that reserved a GPU,
gloo otherwise) — and state restores automatically from
``CheckpointManager.latest``, delivered to (re)joining workers through
the r8 broadcast tree instead of N head pulls.

Step accounting stays exact: a restored run re-reports the steps it
replays from the checkpoint; the driver dedups by step number so no
step lands in ``metrics_history`` twice, and dataset shards re-split
deterministically (``_dataset_shards`` is a pure function of the
dataset and world size) so the resumed stream covers each sample
exactly once for loops that index their shard by step.

Drain-before-kill (preemption notices): the autoscaler's
``on_preemption_notice`` drains the node (cluster routing skips it,
its queued backlog is reclaimed through the r10 lease-revoke
machinery) and publishes a DRAINING node event; this loop sees the
event, requests a checkpoint flush from every worker
(``train.should_checkpoint`` turns True), registers the flushed
checkpoint, and acknowledges the drain — only then is the node
released, so zero tasks are lost to lineage resubmit.

Detection is layered: announced preemptions arrive as DRAINING events;
unannounced deaths surface as ``ActorError`` from the existing
heartbeat/watchdog path (the health monitor marks the node dead, actor
recovery errors the worker's pending refs).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Set

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private import context as _context
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.pubsub import NODE_CHANNEL, StaleCursorError
from ray_tpu_torch._private.scheduler import fits
from ray_tpu_torch.exceptions import (ActorError, GetTimeoutError,
                                      ObjectLostError,
                                      PlacementGroupUnschedulableError,
                                      RayTpuError, WorkerDiedError)
from ray_tpu_torch.train.backend import Backend
from ray_tpu_torch.train.checkpoint import (Checkpoint, CheckpointManager,
                                            pack_dir)
from ray_tpu_torch.train.config import Result
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)

# Errors that mean "the group lost members / placement raced capacity"
# — reshape and restore, bounded by RAY_TPU_ELASTIC_MAX_RESHAPES, not
# by FailureConfig.max_failures (which keeps governing user-code
# errors, exactly like the non-elastic path).
_RESHAPE_ERRORS = (ActorError, WorkerDiedError, ObjectLostError)


def _is_reshape_error(e: BaseException) -> bool:
    """Worker/node loss, possibly wrapped: a dead actor's pending refs
    surface as TaskError(cause=ActorDiedError) at the get() site."""
    if isinstance(e, _RESHAPE_ERRORS):
        return True
    cause = getattr(e, "cause", None)
    return cause is not None and isinstance(cause, _RESHAPE_ERRORS)


def fit_elastic(trainer) -> Result:
    return _ElasticRun(trainer).fit()


class _ElasticRun:
    def __init__(self, trainer):
        self._trainer = trainer
        self._elastic = trainer._scaling.elastic
        self._run_config = trainer._run_config
        self._desired = int(trainer._scaling.num_workers)
        self._min_workers = int(self._elastic.min_workers)
        self._max_workers = int(self._elastic.max_workers
                                or self._desired)
        run_name = (self._run_config.name
                    or f"train_{int(time.time())}")
        storage = (self._run_config.storage_path
                   or os.path.expanduser("~/ray_tpu_results"))
        self.exp_dir = os.path.join(storage, run_name)
        ckpt_cfg = self._run_config.checkpoint_config
        self._manager = CheckpointManager(
            os.path.join(self.exp_dir, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order)
        self._restore: Optional[Checkpoint] = trainer._resume_checkpoint
        if self._restore is None:
            # r15 head HA: the manager now recovers on-disk entries, so
            # a driver restarted after a head crash (same run name)
            # resumes from its own latest checkpoint automatically —
            # the trainer rides through the restart instead of
            # retraining from step 0.
            self._restore = self._manager.latest
        self._history: List[Dict[str, Any]] = []
        self._last_metrics: Dict[str, Any] = {}
        self._last_step = -1            # highest step in the history
        self._last_ckpt_step = -1       # highest step with a checkpoint
        if self._restore is not None:
            # seed step accounting from the restore point's persisted
            # metrics: steps the resumed loop replays (checkpoint ->
            # crash) dedup exactly like an in-process restore, so the
            # concatenated (step, loss) history of a restarted run
            # equals an uninterrupted one
            seeded = self._manager.metrics_for(self._restore).get("step")
            if seeded is not None:
                self._last_step = int(seeded)
                self._last_ckpt_step = int(seeded)
        self._reshapes = 0
        self._restores = 0
        self._last_bcast: Optional[dict] = None
        self._drain_pending: Set[str] = set()
        self._grow_flush_requested = False
        self._ctx = _context.get_ctx()
        pub = getattr(getattr(self._ctx, "controller", None),
                      "pubsub", None)
        self._pubsub = pub
        self._cursor = (pub.current_seq(NODE_CHANNEL)
                        if pub is not None else 0)

    # ------------------------------------------------------- capacity
    def _cluster(self):
        return getattr(self._ctx, "cluster", None)

    def _target_world(self) -> int:
        """Workers (bundles) the cluster can host NOW, clamped to
        max_workers: per-worker resource shape (all k cards of a
        bundle) packed into each schedulable (alive, non-draining)
        node's total, so a node with fewer than k cards hosts none.
        Other tenants' usage is ignored — the group's own resources are
        about to be freed at reshape, and elastic training is assumed
        to own its nodes."""
        cluster = self._cluster()
        if cluster is None:
            return min(self._desired, self._max_workers)
        shape = self._trainer._scaling.worker_resources()
        cap = 0
        for n in cluster.schedulable_nodes():
            avail = dict(n.scheduler.total)
            while cap < self._max_workers and fits(avail, shape):
                for k, v in shape.items():
                    avail[k] = avail.get(k, 0.0) - v
                cap += 1
            if cap >= self._max_workers:
                break
        return cap

    def _await_settled(self, timeout: float = 10.0) -> None:
        """Wait for the health monitor to classify every node: after a
        kill, the dead node stays 'alive' until heartbeat staleness
        trips, and sizing/placing the new group against a ghost just
        buys a placement failure and another reshape lap."""
        cluster = self._cluster()
        if cluster is None:
            return
        hb = CONFIG.heartbeat_timeout_s
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            now = time.monotonic()
            stale = [n for n in cluster.alive_nodes()
                     if now - n.last_heartbeat > hb]
            if not stale:
                return
            time.sleep(min(0.1, hb / 4))

    def _await_capacity(self) -> int:
        """Block until the cluster can host >= min_workers (a replaced
        node may take a while to join); TimeoutError past the window."""
        deadline = time.monotonic() + CONFIG.elastic_capacity_timeout_s
        while True:
            target = self._target_world()
            if target >= self._min_workers:
                return target
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic capacity stayed below min_workers="
                    f"{self._min_workers} (have {target}) for "
                    f"{CONFIG.elastic_capacity_timeout_s:.0f}s")
            time.sleep(CONFIG.elastic_poll_s)

    # ----------------------------------------------------- node events
    def _poll_events(self, group: WorkerGroup,
                     group_nodes: Set[str]) -> None:
        pub = self._pubsub
        if pub is None:
            return
        try:
            msgs, self._cursor = pub.poll(NODE_CHANNEL, self._cursor)
        except StaleCursorError as e:
            self._cursor = e.resync
            return
        for m in msgs:
            nid, state = m.get("node_id"), m.get("state")
            if state == "DRAINING" and nid in group_nodes:
                if nid not in self._drain_pending:
                    logger.info(
                        "elastic: node %s draining (preemption notice) "
                        "— requesting checkpoint flush", nid)
                    self._drain_pending.add(nid)
                    self._request_flush(group)
            # ALIVE (node gain) needs no bookkeeping here: the grow
            # check re-reads capacity every round. DEAD needs none
            # either: the dead worker's refs error with ActorError.

    def _request_flush(self, group: WorkerGroup) -> None:
        """Fire-and-forget checkpoint request to every rank, all k of
        each bundle (SPMD loops must reach the save together; the
        per-rank flag flips them all, and the step-keyed
        should_checkpoint keeps ranks aligned)."""
        for w in group.workers:
            try:
                w.request_checkpoint.remote()
            except Exception:
                pass                    # dying worker: reshape follows

    def _ack_drains(self) -> None:
        """A checkpoint covering current progress just registered: the
        draining nodes may be released (drain-before-kill contract)."""
        if not self._drain_pending:
            return
        cluster = self._cluster()
        for nid in list(self._drain_pending):
            try:
                if cluster is not None:
                    cluster.acknowledge_drain(nid)
                logger.info("elastic: drain of %s acknowledged "
                            "(checkpoint registered at step %d)",
                            nid, self._last_ckpt_step)
            except Exception:
                pass
            self._drain_pending.discard(nid)

    # -------------------------------------------------------- restore
    def _has_remote_agents(self) -> bool:
        cluster = self._cluster()
        if cluster is None:
            return False
        return any(getattr(n.scheduler, "advertise_addr", None)
                   is not None for n in cluster.alive_nodes())

    def _restore_ref(self):
        """Ship the restore checkpoint once: tar bytes -> object store,
        then a broadcast-tree fan-out so every node holds a copy before
        workers resolve the ref (source serves <= fanout transfers;
        without this, W re-joining workers mean W head pulls)."""
        if self._restore is None:
            return None
        data = pack_dir(self._restore.path)
        ref = ray_tpu_torch.put(data)
        self._restores += 1
        logger.info("elastic: restoring from %s (%d bytes, restore #%d)",
                    self._restore.path, len(data), self._restores)
        if self._elastic.broadcast_restore and self._has_remote_agents():
            try:
                st = ray_tpu_torch.broadcast(ref, timeout=60)
                self._last_bcast = st
                logger.info("elastic: restore broadcast tree %s", st)
            except Exception:
                logger.warning("elastic: restore broadcast failed; "
                               "workers will pull from the head",
                               exc_info=True)
        return ref

    # ---------------------------------------------------------- grow
    def _should_grow(self, group: WorkerGroup) -> bool:
        """Grow reshape: capacity now hosts more workers (bundles) than
        the group has (and the group is under max). Never tear down
        progress that isn't checkpointed — request a flush and grow on
        the round where it registers."""
        if group.num_workers >= self._max_workers:
            return False
        target = self._target_world()
        if target <= group.num_workers:
            self._grow_flush_requested = False
            return False
        if self._last_step < 0:
            return True                 # nothing to lose yet
        if self._last_ckpt_step >= self._last_step:
            return True                 # progress is safe on disk
        if not self._grow_flush_requested:
            logger.info(
                "elastic: capacity for %d workers (have %d) — "
                "requesting pre-grow checkpoint flush",
                target, group.num_workers)
            self._grow_flush_requested = True
            self._request_flush(group)
        return False

    # -------------------------------------------------------- driving
    def _peer_lost(self, refs: list, group_nodes: Set[str]) -> bool:
        """Whether a rank's error follows the loss of a peer. A
        surviving rank's collective fails on its own (gloo: the dead
        peer closed the connection) before the dead ranks' ActorError
        reaches the trainer, so the error alone would count as the
        user's failure. Watch for up to two heartbeat timeouts: a group
        node declared dead, or another rank of the round failing with a
        reshape error, is a lost peer; a round whose other ranks all
        resolved without one is the user's failure."""
        cluster = self._cluster()
        deadline = time.monotonic() + 2 * CONFIG.heartbeat_timeout_s
        pending = list(refs)
        while True:
            if cluster is not None and any(
                    not getattr(cluster.get_node(n), "alive", False)
                    for n in group_nodes):
                return True
            ready, pending = ray_tpu_torch.wait(
                pending, num_returns=len(pending), timeout=0)
            for ref in ready:
                try:
                    ray_tpu_torch.get(ref, timeout=1.0)
                except RayTpuError as e:
                    if _is_reshape_error(e):
                        return True
            if not pending or time.monotonic() > deadline:
                return False
            time.sleep(CONFIG.elastic_poll_s)

    def _drive(self, group: WorkerGroup,
               group_nodes: Set[str]) -> str:
        """Run result rounds until the loops finish ("done") or a grow
        reshape is due ("reshape"). Shrink is not decided here — a lost
        worker raises ActorError out of the round and fit() reshapes.
        A round polls every rank (`group.world_size`: k a bundle)."""
        poll_s = CONFIG.elastic_poll_s
        budget = self._run_config.worker_poll_timeout
        done = [False] * group.world_size
        while not all(done):
            self._poll_events(group, group_nodes)
            if self._should_grow(group):
                return "reshape"
            live = [(i, w) for i, (w, d) in
                    enumerate(zip(group.workers, done)) if not d]
            refs = [w.next_result.remote() for _, w in live]
            round_start = time.monotonic()
            while True:
                try:
                    results = ray_tpu_torch.get(refs, timeout=poll_s)
                    break
                except GetTimeoutError:
                    # keep watching for preemption notices while the
                    # workers compute; a grow decision waits for the
                    # round boundary (workers sit in report() until
                    # consumed, so aborting mid-round buys nothing)
                    self._poll_events(group, group_nodes)
                    if (budget is not None
                            and time.monotonic() - round_start > budget):
                        raise TimeoutError(
                            f"no worker result within {budget}s")
                except RayTpuError as e:
                    if (not _is_reshape_error(e)
                            and self._peer_lost(refs, group_nodes)):
                        raise WorkerDiedError(
                            f"a rank failed after its group lost a "
                            f"peer: {e}") from e
                    raise
            round_metrics: Optional[Dict[str, Any]] = None
            round_ckpt: Optional[bytes] = None
            first_live = live[0][0] if live else 0
            for (i, _w), item in zip(live, results):
                if item is None:
                    done[i] = True
                    continue
                metrics, ckpt_bytes = item
                if i == first_live:
                    round_metrics = metrics
                    round_ckpt = ckpt_bytes
            if round_metrics is None:
                continue
            step = round_metrics.get("step")
            step = self._last_step + 1 if step is None else int(step)
            if round_ckpt is not None and step >= self._last_ckpt_step:
                self._manager.register_bytes(round_ckpt, round_metrics)
                self._last_ckpt_step = step
                self._ack_drains()
            if step > self._last_step:
                # fresh ground; replayed steps (a restored run re-
                # covering checkpoint..crash) are skipped so no step
                # lands in the history twice
                self._history.append(round_metrics)
                self._last_metrics = round_metrics
                self._last_step = step
        return "done"

    # ------------------------------------------------------------ fit
    def fit(self) -> Result:
        trainer = self._trainer
        max_failures = self._run_config.failure_config.max_failures
        failures = 0
        error: Optional[BaseException] = None
        fn_bytes = cloudpickle.dumps(trainer._fn)
        ckpt_every = int(self._elastic.checkpoint_every_n_steps)
        final_world = 0

        while True:
            try:
                world = self._await_capacity()
            except TimeoutError as e:
                error = error or e
                break
            group = WorkerGroup(
                world, trainer._scaling.worker_resources(),
                trainer._scaling.placement_strategy, bundles=None,
                name="elastic_train_worker_group",
                ranks_per_worker=trainer._scaling.ranks_per_worker())
            backend: Backend = trainer._backend_config.backend_cls()()
            final_world = world
            reshape = False
            started = False
            try:
                group.start()
                node_ids = ray_tpu_torch.get(
                    [w.node_id.remote() for w in group.workers],
                    timeout=30)
                group_nodes = {n for n in node_ids if n}
                backend.on_start(group, trainer._backend_config)
                restore_arg = self._restore_ref()
                shard_bytes = trainer._dataset_shards(group.world_size)
                ray_tpu_torch.get([
                    w.init_session.remote(fn_bytes, trainer._config,
                                          restore_arg, shard_bytes[i],
                                          ckpt_every)
                    for i, w in enumerate(group.workers)])
                backend.on_training_start(group, trainer._backend_config)
                self._grow_flush_requested = False
                started = True
                logger.info("elastic: training on %d worker(s), %d "
                            "rank(s), from step %d", world,
                            group.world_size, self._last_step + 1)
                if self._drive(group, group_nodes) == "done":
                    break
                reshape = True          # grow
                logger.info("elastic: grow reshape from %d workers",
                            world)
            except PlacementGroupUnschedulableError:
                raise
            except (RayTpuError, TimeoutError) as e:
                if _is_reshape_error(e):
                    reshape = True
                    logger.warning("elastic: lost worker(s) (%s) — "
                                   "reshaping", e)
                elif not started and isinstance(e, TimeoutError):
                    # placement raced a node death: capacity changed
                    # between sizing and reserving — reshape, don't
                    # charge the user's failure budget
                    reshape = True
                    logger.warning("elastic: group start raced a "
                                   "capacity change (%s) — reshaping", e)
                else:
                    failures += 1
                    logger.warning("elastic: training failure %d: %s",
                                   failures, e)
                    if max_failures >= 0 and failures > max_failures:
                        error = e
                        break
            finally:
                try:
                    backend.on_shutdown(group)
                except Exception:
                    pass
                group.shutdown()
            if reshape:
                self._reshapes += 1
                if self._reshapes > CONFIG.elastic_max_reshapes:
                    error = RuntimeError(
                        f"elastic: {self._reshapes} reshapes exceeded "
                        f"RAY_TPU_ELASTIC_MAX_RESHAPES="
                        f"{CONFIG.elastic_max_reshapes} — cluster is "
                        f"flapping faster than training progresses")
                    break
                self._await_settled()
            self._restore = (self._manager.latest
                             or trainer._resume_checkpoint)

        return Result(
            metrics=self._last_metrics,
            checkpoint=self._manager.latest,
            path=self.exp_dir,
            metrics_history=self._history,
            error=error,
            artifacts={"elastic": {
                "reshapes": self._reshapes,
                "restores": self._restores,
                "final_world_size": final_world,
                "last_step": self._last_step,
                "last_checkpoint_step": self._last_ckpt_step,
                # tree stats of the newest restore delivery (None when
                # no restore or no remote agents): nodes/depth/failed +
                # object_id — chaos tests join this against
                # object_plane_stats serve counters to assert the
                # source served <= fanout transfers
                "restore_broadcast": self._last_bcast,
            }})
