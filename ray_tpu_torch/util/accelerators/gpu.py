"""Public multi-host GPU slice scheduling helpers.

The counterpart of `ray_tpu/util/accelerators/tpu.py`: a slice of GPU
hosts schedules as one STRICT_SPREAD placement group with a per-host
bundle {GPU: cards_per_host, <pod_name>: 1}, the head bundle adding
{GPU-<gen>-head: 1}, giving "one actor per host, addressed as a unit",
the primitive the Train worker group rides on with
`ScalingConfig(topology=...)`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.accelerators.gpu import (cards_per_host,
                                                     head_resource_name,
                                                     num_hosts)


def slice_bundles(accelerator_type: str,
                  pod_name: Optional[str] = None,
                  cpus_per_host: float = 1.0) -> List[Dict[str, float]]:
    """One bundle per slice host; bundle 0 carries the head resource."""
    per_host = cards_per_host(accelerator_type)
    bundles: List[Dict[str, float]] = []
    for i in range(num_hosts(accelerator_type)):
        b: Dict[str, float] = {"CPU": cpus_per_host,
                               "GPU": float(per_host)}
        if pod_name:
            b[pod_name] = 1.0
        if i == 0:
            b[head_resource_name(accelerator_type)] = 1.0
        bundles.append(b)
    return bundles


def slice_placement_group(accelerator_type: str,
                          pod_name: Optional[str] = None,
                          cpus_per_host: float = 1.0):
    """Reserve a whole slice: STRICT_SPREAD so each bundle lands on a
    distinct host. Raises PlacementGroupUnschedulableError when the
    cluster cannot ever hold the slice."""
    from ray_tpu_torch.util.placement_group import placement_group
    return placement_group(
        slice_bundles(accelerator_type, pod_name, cpus_per_host),
        strategy="STRICT_SPREAD",
        name=f"gpu_slice_{accelerator_type}")
