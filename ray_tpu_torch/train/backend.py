"""Backend plugins: per-framework worker-group wiring.

Port of `ray_tpu/train/backend.py`. Parity: reference
train/backend.py:32-56 (Backend ABC with on_start/on_training_start/
on_shutdown) and the torch backend's master-address broadcast + env
fanout (train/torch/config.py:66-121,156-200): worker 0 gives a
rendezvous address and a free port, and every worker joins one
`torch.distributed` process group there (`parallel/dist.py`), where the
JAX package's JaxBackend joins `jax.distributed`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclasses.dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    """No-op base backend."""

    def on_start(self, worker_group: WorkerGroup,
                 backend_config: "BackendConfig") -> None:
        pass

    def on_training_start(self, worker_group: WorkerGroup,
                          backend_config: "BackendConfig") -> None:
        pass

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        pass


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """distributed=True joins all workers into one process group
    (None: when the group has more than one worker). `backend` names
    the process group's backend; None is nccl for workers that reserved
    a GPU and gloo otherwise. `env` is fanned out to every worker
    BEFORE the group forms. platform="cpu" hides the cards from every
    worker (`CUDA_VISIBLE_DEVICES=""`, sent before its first CUDA call)
    and the group uses gloo: the CPU counterpart of JaxConfig's
    platform="cpu"."""
    distributed: Optional[bool] = None  # None = auto (W > 1)
    coordinator_port: Optional[int] = None
    env: Optional[dict] = None
    platform: Optional[str] = None      # "cpu" | None (the cards)
    backend: Optional[str] = None       # "nccl" | "gloo" | None (auto)

    def __post_init__(self):
        if self.platform not in (None, "cpu"):
            raise ValueError(f"platform must be 'cpu' or None, got "
                             f"{self.platform!r}")
        if self.backend not in (None, "nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl', 'gloo' or None, "
                             f"got {self.backend!r}")
        if self.platform == "cpu" and self.backend == "nccl":
            raise ValueError("platform='cpu' has no nccl")

    def backend_cls(self):
        return TorchBackend


def _join_distributed(coordinator: str, num_processes: int, rank: int,
                      backend: str) -> int:
    import torch

    from ray_tpu_torch.parallel.dist import (initialize_distributed,
                                             process_index)
    device = None
    if backend == "nccl":
        # ranks on one host take its cards in turn
        device = torch.device("cuda", rank % torch.cuda.device_count())
    initialize_distributed(coordinator, num_processes, rank,
                           backend=backend, device=device)
    return process_index()


class TorchBackend(Backend):
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: TorchConfig) -> None:
        import cloudpickle

        import ray_tpu_torch
        w = worker_group.num_workers
        distributed = backend_config.distributed
        if distributed is None:
            distributed = w > 1
        if backend_config.env:
            worker_group.set_env_on_all(backend_config.env)
        if backend_config.platform == "cpu":
            worker_group.set_env_on_all({"CUDA_VISIBLE_DEVICES": ""})
        if not distributed:
            return
        backend = backend_config.backend
        if backend is None:
            gpus = worker_group.resources_per_worker.get("GPU", 0)
            backend = ("nccl" if gpus and backend_config.platform is None
                       else "gloo")
        addr = ray_tpu_torch.get(worker_group.workers[0].get_address.remote())
        port = (backend_config.coordinator_port
                or ray_tpu_torch.get(
                    worker_group.workers[0].find_free_port.remote()))
        coordinator = f"{addr}:{port}"
        # every worker joins; worker 0 listens at the coordinator
        join = cloudpickle.dumps(_join_distributed)
        refs = [worker_group.workers[rank].run.remote(
            join, (coordinator, w, rank, backend), {})
            for rank in range(w)]
        ranks = ray_tpu_torch.get(refs, timeout=120)
        if ranks != list(range(w)):
            raise RuntimeError(f"process group ranks {ranks}, expected "
                               f"0..{w - 1}")
