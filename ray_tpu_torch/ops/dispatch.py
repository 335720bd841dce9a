"""Device resolution for the port's entry points and kernel wrappers.

Counterpart of `ray_tpu/ops/dispatch.py`, which decides at trace time
whether a Pallas kernel compiles for the TPU or runs interpreted. Here
the decision follows the tensor: a wrapper launches its CUDA kernel for
a CUDA tensor, runs the plain version for a CPU tensor, and raises for
anything else. Entry points resolve `device=None` to the card and never
fall back to the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch.distributed.tensor import DTensor


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` -> the current CUDA device; raises if there is none.

    The CPU is used only when the caller asks for it by name.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise, so
    a wrapper never runs its plain version on a device it was not
    written for, nor on a DTensor (whose local shards the wrappers in
    `ops/sharded.py` hand to the kernel)."""
    if isinstance(t, DTensor):
        raise TypeError("a kernel wrapper takes plain tensors; under a mesh "
                        "call it on local shards (ray_tpu_torch.ops.sharded)")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} for a kernel wrapper")
