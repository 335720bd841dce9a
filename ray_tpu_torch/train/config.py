"""Train configuration dataclasses.

Port of `ray_tpu/train/config.py`. Parity: reference
python/ray/air/config.py (ScalingConfig:102, RunConfig, CheckpointConfig,
FailureConfig). `ScalingConfig` speaks workers x GPUs (`use_gpu`,
`gpus_per_worker`) where the JAX package speaks hosts x chips; its `mesh`
and `topology` raise until the parallel layer and multi-node placement
are ported. `ElasticConfig` and `PipelineConfig` are copies, so configs
validate the same way, though `fit` raises on both paths for now.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ElasticConfig:
    """Elastic, preemption-tolerant data-parallel training (r14).

    With ``ScalingConfig(elastic=ElasticConfig(...))``, ``fit()``
    survives node loss AND gain mid-run: the worker group reshapes (the
    dp mesh shrinks to the surviving worker count or grows when a
    replacement host joins), state auto-restores from the latest
    registered checkpoint — delivered to (re)joining workers through
    the r8 broadcast tree instead of N head pulls — and step accounting
    stays exact (a restored run's replayed reports are deduped by step;
    dataset shards re-split deterministically). On a preemption notice
    (autoscaler drain) the trainer flushes a checkpoint and
    acknowledges the drain so the node is released only after state is
    safe.

    min_workers: reshape floor — below this fit() waits for capacity
        (RAY_TPU_ELASTIC_CAPACITY_TIMEOUT_S) instead of running with
        too small a mesh.
    max_workers: reshape ceiling; 0 = ScalingConfig.num_workers.
    checkpoint_every_n_steps: cadence the worker loop should honor via
        ``train.should_checkpoint(step)`` (fires on step n-1, 2n-1, …,
        plus whenever the trainer requests a flush — drain notices,
        pre-grow). 0 leaves checkpointing entirely to the user loop,
        at the cost of replaying from the last user checkpoint on
        reshape.
    broadcast_restore: deliver the restore checkpoint via
        ``ray_tpu_torch.broadcast`` (source serves <= fanout transfers) when
        remote agents are present; off = every worker pulls from the
        head.
    """
    min_workers: int = 1
    max_workers: int = 0
    checkpoint_every_n_steps: int = 1
    broadcast_restore: bool = True

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers and self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers={self.max_workers} < "
                f"min_workers={self.min_workers}")
        if self.checkpoint_every_n_steps < 0:
            raise ValueError("checkpoint_every_n_steps must be >= 0")


@dataclasses.dataclass
class ScalingConfig:
    """How many training workers and what each holds.

    num_workers: one worker process per rank of the process group.
    use_gpu=False runs CPU-only workers (CI, debugging); use_gpu=True
    reserves `gpus_per_worker` of the runtime's GPU resource for each.
    """
    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: int = 0            # 0 = one card
    resources_per_worker: Optional[Dict[str, float]] = None
    mesh: Any = None                    # the parallel layer: not yet
    placement_strategy: str = "PACK"
    # TPU pod-slice placement in the JAX package; the GPU counterpart is
    # multi-node placement, not ported yet
    topology: Optional[str] = None
    pod_name: Optional[str] = None
    # Elastic mode (r14): reshape the group on node loss/gain instead
    # of whole-group restart-in-place; num_workers becomes the DESIRED
    # world size within [elastic.min_workers, elastic.max_workers].
    elastic: Optional[ElasticConfig] = None

    def __post_init__(self):
        if self.elastic is not None:
            # cross-validate against the EFFECTIVE ceiling now (0 means
            # num_workers): an impossible floor would otherwise surface
            # only as a misleading capacity timeout at fit() time
            eff_max = self.elastic.max_workers or self.num_workers
            if self.elastic.min_workers > eff_max:
                raise ValueError(
                    f"elastic.min_workers={self.elastic.min_workers} "
                    f"exceeds the effective max_workers={eff_max} "
                    f"(= num_workers when elastic.max_workers is 0)")
        if self.mesh is not None:
            raise NotImplementedError(
                "ScalingConfig.mesh needs the parallel layer (DeviceMesh, "
                "FSDP/TP plans), ROADMAP queue 1, item 5")
        if self.topology is not None:
            raise NotImplementedError(
                "ScalingConfig.topology (pod-slice placement) has its GPU "
                "counterpart in multi-node placement: ROADMAP queue 1, "
                "items 3 and 5")

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", float(self.gpus_per_worker or 1))
        return res

    def worker_bundles(self) -> Optional[list]:
        """Explicit per-rank bundles (pod-slice mode in the JAX package,
        which `topology` refuses here): always None."""
        return None


@dataclasses.dataclass
class PipelineConfig:
    """MPMD pipeline-parallel training (r13): the layer stack is
    partitioned across `pipeline_stages` worker GROUPS (remainder
    layers to the last stage, parallel.pipeline.partition_layers), and
    activations/grads stream stage-to-stage over compiled-DAG channels
    with a 1F1B (or GPipe) microbatch schedule — each stage is its own
    set of processes owning its own slice, per "Scaling Deep Learning
    Training with MPMD Pipeline Parallelism" (PAPERS.md).

    init_params: layer-stacked pytree, leaves (L, ...).
    stage_fn(stage_params, x, *consts) -> y: applies ONE stage's
        sub-stack (leaves (L_s, ...), possibly ragged across stages —
        MPMD stages are independent programs).
    loss_fn(y, targets) -> scalar summed microbatch loss (the 1F1B
        contract shared with parallel.pipeline.pipeline_grads_1f1b).
    batch_fn(step) -> (x, targets): the per-step global batch.
    update_fn(params, grads, step) -> params: per-stage optimizer
        applied to that stage's slice with grads already averaged over
        microbatches; None = SGD with `lr`.
    transport: "shm" (same-box rings) | "wire" (cross-host, tensors
        over the Envelope raw zero-copy path) | "auto" (wire for
        cross-host edges only).
    ring_depth: channel ring slots (None -> RAY_TPU_CHANNEL_RING_DEPTH;
        >= 2 overlaps a stage's sends with its neighbors' compute).
    """
    init_params: Any = None
    stage_fn: Any = None
    loss_fn: Any = None
    batch_fn: Any = None
    steps: int = 1
    consts: tuple = ()
    num_microbatches: int = 4
    schedule: str = "1f1b"
    transport: str = "shm"
    ring_depth: Optional[int] = None
    channel_capacity_bytes: int = 4 << 20
    workers_per_stage: int = 1
    update_fn: Any = None
    lr: float = 1e-2

    def __post_init__(self):
        if self.schedule not in ("1f1b", "gpipe"):
            raise ValueError("schedule must be 1f1b|gpipe")
        if self.transport not in ("shm", "wire", "auto"):
            raise ValueError("transport must be shm|wire|auto")
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None        # None = keep all
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"

    def __post_init__(self):
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be max|min")


@dataclasses.dataclass
class FailureConfig:
    """Whole-group restart-from-checkpoint semantics (reference
    backend_executor.py:759-786): max_failures < 0 means unlimited."""
    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None  # default ~/ray_tpu_torch_results
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    # Max seconds between report() rounds before the group is declared
    # hung. None = wait forever (first steps of big models can spend
    # minutes building kernels and loading weights).
    worker_poll_timeout: Optional[float] = None


@dataclasses.dataclass
class Result:
    """What TorchTrainer.fit returns (reference train/base_trainer Result)."""
    metrics: Dict[str, Any]
    checkpoint: Optional["Checkpoint"]  # noqa: F821 (train.checkpoint)
    path: str
    metrics_history: list = dataclasses.field(default_factory=list)
    error: Optional[BaseException] = None
    # trial config when produced by a Tune sweep (reference Result.config)
    config: Optional[Dict[str, Any]] = None
    # non-scalar outputs (MPMD pipeline mode returns the reassembled
    # layer-major params here; metrics stay scalar-only)
    artifacts: Optional[Dict[str, Any]] = None
