"""The port's parallelism layer.

So far only the multi-process bootstrap (:mod:`ray_tpu_torch.parallel.dist`),
the counterpart of `ray_tpu/parallel/dist.py`: `torch.distributed`'s
process group where the JAX package joins `jax.distributed`. The mesh,
sharding rules and collectives (`ray_tpu/parallel/{mesh,sharding,
collectives}.py`) are still to port (ROADMAP queue 1, item 5).
"""
from ray_tpu_torch.parallel import dist  # noqa: F401

__all__ = ["dist"]
