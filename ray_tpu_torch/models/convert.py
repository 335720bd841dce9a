"""Parameters from the JAX package's pytree, and the one cast that serving
makes.

The JAX tree stacks each layer parameter (the MoE router and experts
included) on a leading layers axis; the port unstacks the layers and keeps every leaf in the parameter dtype, as
the JAX tree does. Both packages cast the matmul weights to the
activation dtype at every use. For serving, `cast_for_serving` makes that
cast once (the same rounding), and `init_for_serving` makes random
serving weights without ever holding the whole parameter-dtype model.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.transformer import NORMS, Params, Transformer
from ray_tpu_torch.ops.dispatch import resolve_device


def params_from_jax(tree: Mapping[str, Any], config: TransformerConfig,
                    device=None) -> Params:
    """`tree`: the JAX param pytree with numpy arrays as leaves (e.g.
    `jax.tree_util.tree_map(np.asarray, params)`). Returns the port's
    parameters on `device` (default: the card), each leaf in the
    parameter dtype. An MoE tree's `router`, `moe_gate`, `moe_up` and
    `moe_down`, stacked (L, E, ...) there, are unstacked per layer as the
    other layer leaves are."""
    dev = resolve_device(device)
    pd = config.parameter_dtype

    def to(a):
        arr = np.array(a, dtype=np.float32)      # a writable copy
        return torch.from_numpy(arr).to(device=dev, dtype=pd)

    stacked = tree["layers"]
    params: Params = {
        "embed": to(tree["embed"]),
        "layers": [{name: to(arr[i]) for name, arr in stacked.items()}
                   for i in range(config.n_layers)],
        "final_norm": to(tree["final_norm"]),
    }
    if not config.tie_embeddings:
        params["lm_head"] = to(tree["lm_head"])
    return params


def _serving_leaf(config: TransformerConfig):
    ad = config.activation_dtype

    def cast(name: str, t: torch.Tensor) -> torch.Tensor:
        # norm weights stay in the parameter dtype: the RMSNorm kernel
        # reads (1 + w) in f32 from either dtype
        return t if name in NORMS else t.to(ad)
    return cast


def cast_for_serving(params: Params, config: TransformerConfig) -> Params:
    """Cast `embed`, `lm_head` and the matmul weights to the activation
    dtype, in place, one leaf at a time (the dict is updated and
    returned). The forwards' casts at use then cost nothing. For
    inference only: training keeps the parameter-dtype leaves."""
    cast = _serving_leaf(config)
    for layer in params["layers"]:
        for name in layer:
            layer[name] = cast(name, layer[name])
    for name in ("embed", "lm_head"):
        if name in params:
            params[name] = cast(name, params[name])
    return params


def init_for_serving(model: Transformer, seed: int, device=None) -> Params:
    """`cast_for_serving(model.init(seed, device))`, leaf by leaf: the
    same values, with the peak memory of the cast model plus one leaf."""
    return model.init_leaves(seed, device, _serving_leaf(model.config))
