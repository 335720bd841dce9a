"""TorchTrainer: the DataParallelTrainer equivalent, standalone.

Port of `ray_tpu/train/trainer.py` (its TorchTrainer): the data-parallel
fit loop, dataset sharding and the driver's result loop are copies. The
MPMD pipeline mode (`pipeline_stages > 1`, ROADMAP queue 1, item 9) and
elastic mode (item 3) raise NotImplementedError.

Parity: reference train/data_parallel_trainer.py (training_loop:428-474)
+ backend_executor.py (start:135, whole-group _restart:759, max_failures
:770) + trainer.py TrainingIterator:36 — but standalone rather than
riding on Tune (SURVEY.md §7 step 7 argues for inverting the reference's
coupling at base_trainer.py:567-623; ray_tpu_torch.tune layers on top of this
instead).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorError, RayTpuError
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                        PipelineConfig, Result, RunConfig,
                                        ScalingConfig)
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TorchTrainer:
    """Runs `train_loop_per_worker` on a group of worker actors.

    Each worker is one process; with TorchConfig(distributed=True) the
    group forms one `torch.distributed` process group, so the user loop
    can all-reduce across ranks or wrap its model in DDP — the
    collective-safe fan-out primitive of SURVEY.md §7.
    """

    def __init__(self,
                 train_loop_per_worker: Optional[Callable] = None,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 backend_config: Optional[BackendConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 pipeline_stages: int = 0,
                 pipeline_config: Optional[PipelineConfig] = None):
        self._fn = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self._datasets = dict(datasets or {})
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._backend_config = backend_config or TorchConfig()
        self._resume_checkpoint = resume_from_checkpoint
        # MPMD pipeline mode (r13 in the JAX package): pipeline_stages
        # > 1 partitions the layer stack across that many stage worker
        # GROUPS over compiled-DAG channels; not ported yet (fit raises).
        # train_loop_per_worker is unused there — the stage program
        # comes from pipeline_config.
        self._pipeline_stages = int(pipeline_stages)
        self._pipeline_config = pipeline_config
        if self._pipeline_stages <= 1 and train_loop_per_worker is None:
            raise ValueError(
                "train_loop_per_worker is required unless "
                "pipeline_stages > 1")

    # ------------------------------------------------------------- fit
    def fit(self) -> Result:
        if self._pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline_stages > 1 (train/pipeline.py) needs the DAG and "
                "its channels: ROADMAP queue 1, item 9")
        if self._scaling.elastic is not None:
            from ray_tpu_torch._private.config import CONFIG
            if CONFIG.elastic:
                # Elastic mode (r14 in the JAX package): reshape on node
                # loss/gain instead of the whole-group restart below.
                raise NotImplementedError(
                    "elastic training (train/elastic.py) waits for the node "
                    "agent: ROADMAP queue 1, item 3")
        return self._fit_data_parallel()

    def _fit_data_parallel(self) -> Result:
        run_name = self._run_config.name or f"train_{int(time.time())}"
        storage = (self._run_config.storage_path
                   or os.path.expanduser("~/ray_tpu_torch_results"))
        exp_dir = os.path.join(storage, run_name)
        ckpt_cfg = self._run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(exp_dir, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order)

        max_failures = self._run_config.failure_config.max_failures
        failures = 0
        restore: Optional[Checkpoint] = self._resume_checkpoint
        metrics_history: list = []
        last_metrics: Dict[str, Any] = {}
        error: Optional[BaseException] = None

        while True:
            group = WorkerGroup(self._scaling.num_workers,
                                self._scaling.worker_resources(),
                                self._scaling.placement_strategy,
                                bundles=self._scaling.worker_bundles())
            backend: Backend = self._backend_config.backend_cls()()
            try:
                group.start()
                backend.on_start(group, self._backend_config)
                fn_bytes = cloudpickle.dumps(self._fn)
                # restore ships as tar bytes (workers may not share the
                # driver's filesystem)
                restore_arg = None
                if restore is not None:
                    from ray_tpu_torch.train.checkpoint import (
                        pack_dir, tar_array)
                    # put once, fan out the ref: workers resolve it to
                    # the tar via shm instead of N pickled copies
                    restore_arg = ray_tpu_torch.put(
                        tar_array(pack_dir(restore.path)))
                shard_bytes = self._dataset_shards(group.num_workers)
                ray_tpu_torch.get([
                    w.init_session.remote(fn_bytes, self._config,
                                          restore_arg, shard_bytes[i])
                    for i, w in enumerate(group.workers)])
                backend.on_training_start(group, self._backend_config)
                last_metrics = self._training_loop(
                    group, manager, metrics_history)
                error = None
                break
            except (ActorError, RayTpuError, TimeoutError) as e:
                from ray_tpu_torch.exceptions import (
                    PlacementGroupUnschedulableError as _PGErr)
                if isinstance(e, _PGErr):
                    # Retrying cannot create capacity; surface loudly
                    # (VERDICT r1: unschedulable raises, never hangs).
                    # The finally block tears the group down.
                    raise
                failures += 1
                logger.warning("worker group failure %d: %s", failures, e)
                if max_failures >= 0 and failures > max_failures:
                    error = e
                    break
                restore = manager.latest or self._resume_checkpoint
            finally:
                backend.on_shutdown(group)
                group.shutdown()

        return Result(metrics=last_metrics,
                      checkpoint=manager.latest,
                      path=exp_dir,
                      metrics_history=metrics_history,
                      error=error)

    # ------------------------------------------------- dataset sharding
    def _dataset_shards(self, n: int) -> list:
        """Split every dataset into one shard per worker (reference
        data_parallel_trainer streaming_split). Datasets with fewer
        partitions than workers are repartitioned first."""
        if not self._datasets:
            return [None] * n
        per_worker: list = [dict() for _ in range(n)]
        for name, dset in self._datasets.items():
            if dset.num_partitions() < n:
                dset = dset.repartition(n)
            for rank, shard in enumerate(dset.split(n)):
                per_worker[rank][name] = shard
        return [cloudpickle.dumps(s) for s in per_worker]

    # ---------------------------------------------------- driver loop
    def _training_loop(self, group: WorkerGroup,
                       manager: CheckpointManager,
                       metrics_history: list) -> Dict[str, Any]:
        last: Dict[str, Any] = {}
        done = [False] * group.num_workers
        while not all(done):
            # One synchronous round of next_result across live workers —
            # report() is collective in SPMD loops, so all workers reach
            # it together (reference get_next_results, backend_executor
            # :578 gathers one result from every worker per round).
            refs = [w.next_result.remote()
                    for w, d in zip(group.workers, done) if not d]
            results = ray_tpu_torch.get(
                refs, timeout=self._run_config.worker_poll_timeout)
            idx = 0
            round_metrics: Optional[Dict[str, Any]] = None
            round_ckpt: Optional[bytes] = None
            for i in range(group.num_workers):
                if done[i]:
                    continue
                item = results[idx]
                idx += 1
                if item is None:
                    done[i] = True
                    continue
                metrics, ckpt_bytes = item
                if i == 0:
                    round_metrics = metrics
                    round_ckpt = ckpt_bytes
                # rank>0 checkpoints: workers already reclaimed their own
                # temp dirs host-side; nothing to do driver-side.
            if round_metrics is not None:
                metrics_history.append(round_metrics)
                last = round_metrics
                if round_ckpt is not None:
                    manager.register_bytes(round_ckpt, round_metrics)
        return last
