"""The port's parallelism layer (counterpart of `ray_tpu/parallel`).

- :class:`MeshSpec` / :func:`prepare_mesh` — a `DeviceMesh` over the
  default process group with the dimensions (pp, dp, fsdp, sp, ep, tp).
- logical-axis sharding rules (:mod:`ray_tpu_torch.parallel.sharding`)
  that map model-logical axes ("batch", "embed", "mlp", "heads", ...) onto
  mesh axes as DTensor placements, one DTensor per parameter leaf.
- collectives (:mod:`ray_tpu_torch.parallel.collectives`) over one named
  mesh axis, on each rank's local tensor (inside `local_map`).
- multi-process bootstrap (:mod:`ray_tpu_torch.parallel.dist`):
  `torch.distributed`'s process group.

The SPMD pipeline (`ray_tpu/parallel/pipeline.py`) is not ported yet
(ROADMAP queue 1, item 9).
"""
from ray_tpu_torch.parallel import collectives, dist  # noqa: F401
from ray_tpu_torch.parallel.dist import initialize_distributed  # noqa: F401
from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    local_mesh,
    mesh_shape_for,
    prepare_mesh,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    LOGICAL_AXIS_RULES,
    logical_sharding,
    param_shardings,
    shard_pytree,
    with_logical_constraint,
)

__all__ = ["MeshSpec", "prepare_mesh", "local_mesh", "mesh_shape_for",
           "LOGICAL_AXIS_RULES", "logical_sharding", "shard_pytree",
           "with_logical_constraint", "param_shardings", "collectives",
           "dist", "initialize_distributed"]
