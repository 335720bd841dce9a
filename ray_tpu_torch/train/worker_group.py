"""WorkerGroup: N train-worker actors with env fanout and session control.

Port of `ray_tpu/train/worker_group.py`. Parity: reference
train/_internal/worker_group.py (WorkerGroup:102, RayTrainWorker:19) +
the accelerator-visibility env sharing of backend_executor.py:271-351.
Each worker is one process that becomes one rank of a
`torch.distributed` process group. A worker reserves `num_gpus` from its
bundle's `GPU` where the JAX package reserves `num_tpus` from `TPU`.

This module must not import torch when it is loaded: the backend's env
(`CUDA_VISIBLE_DEVICES` for CPU groups) reaches a worker after its
actor class is unpickled, and must come before its first CUDA call.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, _TrainSession


class RayTrainWorker:
    """Actor running one training session (one per host)."""

    def __init__(self, rank: int, world_size: int):
        self._rank = rank
        self._world_size = world_size
        self._session: Optional[_TrainSession] = None

    # ------------------------------------------------------------ setup
    def set_env(self, env: Dict[str, str]) -> None:
        os.environ.update(env)

    def get_address(self) -> str:
        return socket.gethostbyname(socket.gethostname())

    def node_id(self) -> Optional[str]:
        """The cluster node hosting this worker (the elastic trainer
        maps DRAINING/DEAD node events onto group members with this)."""
        return os.environ.get("RAY_TPU_NODE_ID")

    def find_free_port(self) -> int:
        with socket.socket() as s:
            s.bind(("", 0))
            return s.getsockname()[1]

    def run(self, fn_bytes: bytes, args: tuple, kwargs: dict) -> Any:
        """Execute an arbitrary callable on the worker (utility fanout)."""
        fn = cloudpickle.loads(fn_bytes)
        return fn(*args, **kwargs)

    # --------------------------------------------------------- training
    def init_session(self, fn_bytes: bytes, config: Dict[str, Any],
                     restore_bytes: Optional[bytes],
                     datasets_bytes: Optional[bytes] = None,
                     ckpt_every: int = 0) -> None:
        fn = cloudpickle.loads(fn_bytes)
        ctx = TrainContext(
            world_rank=self._rank, world_size=self._world_size,
            local_rank=0, local_world_size=1, node_rank=self._rank)
        restore = None
        if restore_bytes is not None:
            # The driver ships the restore checkpoint as tar bytes so the
            # worker never needs the driver's filesystem (VERDICT r2:
            # multi-host checkpointing must not assume a shared fs).
            import tempfile

            from ray_tpu_torch.train.checkpoint import unpack_dir
            rdir = tempfile.mkdtemp(prefix="rtt_restore_")
            unpack_dir(restore_bytes, rdir)
            restore = Checkpoint(rdir)
        shards = (cloudpickle.loads(datasets_bytes)
                  if datasets_bytes else None)
        self._session = _TrainSession(fn, config, ctx, restore,
                                      dataset_shards=shards,
                                      ckpt_every=ckpt_every)
        self._session.start()

    def request_checkpoint(self) -> None:
        """Elastic flush request (drain notice / pre-grow): the user
        loop's next should_checkpoint() returns True."""
        if self._session is not None:
            self._session.request_checkpoint()

    def next_result(self):
        """(metrics, checkpoint tar as a uint8 array|None) or None at
        loop end.

        Rank 0 packs its reported checkpoint dir for the driver; every rank then deletes its own session temp dir (the
        driver cannot — it may be on another host)."""
        assert self._session is not None, "init_session first"
        item = self._session.next_result()
        if item is None:
            return None
        metrics, ckpt = item
        data = None
        if ckpt is not None:
            import tempfile

            from ray_tpu_torch.train.checkpoint import pack_dir, tar_array
            if self._rank == 0:
                data = tar_array(pack_dir(ckpt.path))
            # only reclaim dirs we created (session temp checkpoints);
            # user-managed persistent dirs are left alone.
            tmp = tempfile.gettempdir()
            if (os.path.abspath(ckpt.path).startswith(tmp)
                    and "rtt_ckpt_" in os.path.basename(ckpt.path)):
                import shutil
                shutil.rmtree(ckpt.path, ignore_errors=True)
        return metrics, data

    def finished(self) -> bool:
        return self._session is None or self._session.finished

    def ping(self) -> str:
        return "ok"


class WorkerGroup:
    """Owns the actor handles; all-or-nothing lifecycle.

    The group schedules through a placement group (one bundle per
    worker, reference backend_executor.py:219) so worker placement is
    atomic: either every rank gets its bundle or the PG creation raises
    — no half-started group holding cards."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_strategy: str = "PACK",
                 bundles: Optional[List[Dict[str, float]]] = None,
                 name: str = "train_worker_group"):
        self.num_workers = num_workers
        self._resources = dict(resources_per_worker or {"CPU": 1.0})
        self._strategy = placement_strategy
        # Group name (MPMD pipeline mode runs one group PER STAGE, so
        # each stage's placement group is distinguishable in state ops).
        self.name = name
        # Explicit per-rank bundles (the JAX package's pod-slice mode;
        # the port's ScalingConfig makes none yet).
        self._bundles = bundles
        if bundles is not None and len(bundles) != num_workers:
            raise ValueError(f"{len(bundles)} bundles != "
                             f"{num_workers} workers")
        self.workers: List[Any] = []
        self._pg = None

    @property
    def resources_per_worker(self) -> Dict[str, float]:
        return dict(self._resources)

    def start(self) -> None:
        from ray_tpu_torch.util.placement_group import (placement_group,
                                                        remove_placement_group)
        self._pg = placement_group(
            self._bundles or
            [dict(self._resources) for _ in range(self.num_workers)],
            strategy=self._strategy, name=self.name)
        if not self._pg.wait(timeout_seconds=60):
            pg, self._pg = self._pg, None
            remove_placement_group(pg)
            raise TimeoutError(
                f"placement group for {self.num_workers} train workers "
                f"({self._resources} each, {self._strategy}) not ready "
                f"within 60s — cluster lacks free capacity")
        self.workers = []
        for rank in range(self.num_workers):
            res = dict(self._bundles[rank] if self._bundles
                       else self._resources)
            cls = ray_tpu_torch.remote(**{
                "num_cpus": res.pop("CPU", 1.0),
                "num_gpus": res.pop("GPU", 0) or None,
                "resources": res or None,
            })(RayTrainWorker)
            self.workers.append(
                cls.options(placement_group=self._pg,
                            placement_group_bundle_index=rank)
                .remote(rank, self.num_workers))
        # fail fast if any worker failed to start
        ray_tpu_torch.get([w.ping.remote() for w in self.workers], timeout=60)

    def shutdown(self) -> None:
        """Idempotent, dead-actor-tolerant teardown. The post-chaos
        state — workers already dead with their node, the PG already in
        RESCHEDULING, a previous shutdown() half-done — must neither
        raise nor hang: every step is best-effort and state is detached
        up front so a re-entrant call is a no-op."""
        workers, self.workers = self.workers, []
        pg, self._pg = self._pg, None
        for w in workers:
            try:
                ray_tpu_torch.kill(w)
            except BaseException:
                pass                # already dead / node gone
        if pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group)
            try:
                remove_placement_group(pg)
            except BaseException:
                pass

    # ------------------------------------------------------------ fanout
    def run_on_all(self, fn: Callable, *args, **kwargs) -> List[Any]:
        fn_bytes = cloudpickle.dumps(fn)
        return ray_tpu_torch.get([w.run.remote(fn_bytes, args, kwargs)
                                  for w in self.workers])

    def run_on_rank(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        fn_bytes = cloudpickle.dumps(fn)
        return ray_tpu_torch.get(
            self.workers[rank].run.remote(fn_bytes, args, kwargs))

    def run_on_rank_async(self, rank: int, fn: Callable,
                          *args, **kwargs) -> Any:
        """Non-blocking run: returns the ObjectRef. MPMD pipeline stage
        loops are long-lived calls that must run CONCURRENTLY across
        stage groups — the blocking fanout above would serialize them."""
        fn_bytes = cloudpickle.dumps(fn)
        return self.workers[rank].run.remote(fn_bytes, args, kwargs)

    def set_env_on_all(self, env: Dict[str, str]) -> None:
        ray_tpu_torch.get([w.set_env.remote(env) for w in self.workers])
