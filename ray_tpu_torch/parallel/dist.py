"""Multi-process bootstrap: `torch.distributed`'s process group.

Port of `ray_tpu/parallel/dist.py`. The JAX package joins every worker
into one `jax.distributed` program; here each worker joins one
`torch.distributed` process group over `tcp://coordinator` (the
reference's torch backend, python/ray/train/torch/config.py:66-121).
`ray_tpu_torch.train`'s TorchBackend calls this on every worker actor
with a rendezvous address given by worker 0.

nccl binds each rank to its CUDA device (`device_id`); gloo runs on the
CPU. A failed join raises: nothing retries on another backend.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

_initialized = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> None:
    """Join the process group (idempotent).

    `coordinator_address` is "host:port" (rank 0 listens there);
    `backend` is "nccl" or "gloo", None meaning nccl when a card is
    visible and gloo otherwise; `device` is the rank's CUDA device for
    nccl (None: the current one). One process with no coordinator has
    nothing to join and makes no group.
    """
    global _initialized
    if _initialized:
        return
    import torch
    import torch.distributed as tdist

    if num_processes is not None and num_processes <= 1 and (
            coordinator_address is None):
        # Single-process: nothing to rendezvous.
        _initialized = True
        return
    if tdist.is_initialized():
        _initialized = True
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    else:
        kwargs["init_method"] = "env://"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if backend == "nccl":
        dev = (torch.device(device) if device is not None
               else torch.device("cuda", torch.cuda.current_device()))
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    logger.info("torch.distributed.init_process_group(%s)", kwargs)
    tdist.init_process_group(**kwargs)
    _initialized = True


def is_distributed_initialized() -> bool:
    return _initialized


def process_index() -> int:
    import torch.distributed as tdist
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as tdist
    return tdist.get_world_size() if tdist.is_initialized() else 1


def coordinator_env() -> dict:
    """Env vars a worker-group launcher should fan out (parity with the
    reference's MASTER_ADDR/MASTER_PORT fanout,
    reference python/ray/train/torch/config.py:156-200)."""
    return {
        k: v for k, v in os.environ.items()
        if k.startswith(("MASTER_", "NCCL_", "TORCH_"))
    }
