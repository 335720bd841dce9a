"""Parameters from the JAX package's pytree, for parity tests and for
serving weights trained by the JAX package.

The JAX tree stacks each layer parameter on a leading layers axis and
casts matmul weights to the activation dtype at every use; the port
unstacks the layers and casts once here, which rounds the same way.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.transformer import Params
from ray_tpu_torch.ops.dispatch import resolve_device

_NORMS = ("attn_norm", "mlp_norm")


def params_from_jax(tree: Mapping[str, Any], config: TransformerConfig,
                    device=None) -> Params:
    """`tree`: the JAX param pytree with numpy arrays as leaves (e.g.
    `jax.tree_util.tree_map(np.asarray, params)`). Returns the port's
    parameters on `device` (default: the card)."""
    if config.moe_num_experts:
        raise NotImplementedError("MoE parameters are not ported yet")
    dev = resolve_device(device)

    def to(a, dtype):
        arr = np.array(a, dtype=np.float32)      # a writable copy
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    ad, pd = config.activation_dtype, config.parameter_dtype
    stacked = tree["layers"]
    layers = []
    for i in range(config.n_layers):
        layers.append({name: to(arr[i], pd if name in _NORMS else ad)
                       for name, arr in stacked.items()})
    params: Params = {
        "embed": to(tree["embed"], ad),
        "layers": layers,
        "final_norm": to(tree["final_norm"], pd),
    }
    if not config.tie_embeddings:
        params["lm_head"] = to(tree["lm_head"], ad)
    return params
