"""GPU accelerator manager: detection, visibility, multi-host slices.

The counterpart of `ray_tpu/_private/accelerators/tpu.py`, for hosts of
NVIDIA cards:
- card detection through the runtime's own probe (`detect_num_gpus`:
  `nvidia-smi -L` and `CUDA_VISIBLE_DEVICES`, no CUDA context made);
- card-subset visibility through `CUDA_VISIBLE_DEVICES`;
- slice resources: a slice of hosts (a GPU "pod") schedules as one unit
  when every host of it advertises `{<pod_name>: 1}` and host 0 also
  `{GPU-<generation>-head: 1}`, so "one actor per host, addressed as a
  unit" is a plain resource request.

An accelerator type reads "<generation>-<cards>": "h100-8" is one 8-card
HGX host, "h100-16" two of them, "h100-1" one host with one card. The
type, the slice's name and the host's index in it come from
`RAY_TPU_ACCELERATOR_TYPE`, `RAY_TPU_POD_NAME` and
`RAY_TPU_POD_WORKER_ID` (a GPU host has no TPU-VM runtime to set them).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from ray_tpu_torch._private.runtime import detect_num_gpus

# cards per host by generation: the SXM parts ship in 8-card HGX boards
_CARDS_PER_HOST = {"a100": 8, "h100": 8, "h200": 8, "b200": 8}


def parse_accelerator_type(accelerator_type: str) -> tuple:
    """'h100-16' -> ('h100', 16). Raises on malformed input."""
    parts = accelerator_type.lower().split("-")
    if len(parts) != 2 or not parts[1].isdigit() or int(parts[1]) < 1:
        raise ValueError(
            f"malformed GPU accelerator type {accelerator_type!r}; "
            f"expected e.g. 'h100-8', 'h100-16'")
    gen, size = parts[0], int(parts[1])
    if gen not in _CARDS_PER_HOST:
        raise ValueError(f"unknown GPU generation {gen!r} "
                         f"(known: {sorted(_CARDS_PER_HOST)})")
    return gen, size


def cards_per_host(accelerator_type: str) -> int:
    gen, size = parse_accelerator_type(accelerator_type)
    return min(_CARDS_PER_HOST[gen], size)


def num_hosts(accelerator_type: str) -> int:
    """Hosts in the slice (>=1)."""
    gen, size = parse_accelerator_type(accelerator_type)
    return max(1, -(-size // _CARDS_PER_HOST[gen]))


def head_resource_name(accelerator_type: str) -> str:
    gen, _ = parse_accelerator_type(accelerator_type)
    return f"GPU-{gen}-head"


class GPUAcceleratorManager:
    """AcceleratorManager-shape API (reference accelerator.py ABC)."""

    RESOURCE_NAME = "GPU"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        return detect_num_gpus()

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        return os.environ.get("RAY_TPU_ACCELERATOR_TYPE")

    @staticmethod
    def get_current_pod_name() -> Optional[str]:
        return os.environ.get("RAY_TPU_POD_NAME")

    @staticmethod
    def get_current_pod_worker_id() -> int:
        return int(os.environ.get("RAY_TPU_POD_WORKER_ID", "0"))

    @staticmethod
    def set_visible_accelerators(card_ids: List[int]) -> None:
        """Restrict this process to a subset of the host's cards (before
        it makes a CUDA context)."""
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, card_ids))

    @classmethod
    def get_current_node_additional_resources(cls) -> Dict[str, float]:
        """Slice resources this node should advertise: {pod_name: 1} on
        every host of the slice, plus {GPU-<gen>-head: 1} on host 0."""
        pod = cls.get_current_pod_name()
        if not pod:
            return {}
        out: Dict[str, float] = {pod: 1.0}
        accel = cls.get_current_node_accelerator_type()
        if accel and cls.get_current_pod_worker_id() == 0:
            out[head_resource_name(accel)] = 1.0
        return out
