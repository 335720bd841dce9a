"""Parameters from the JAX package's pytree, and the one cast that serving
makes.

The JAX tree stacks each layer parameter (the MoE router and experts
included) on a leading layers axis; the port unstacks the layers and keeps every leaf in the parameter dtype, as
the JAX tree does. Both packages cast the matmul weights to the
activation dtype at every use. For serving, `cast_for_serving` makes that
cast once (the same rounding), and `init_for_serving` makes random
serving weights without ever holding the whole parameter-dtype model.

`tp_shard_params` takes one tensor-parallel rank's shard of the params,
Megatron style, as the JAX rules table (`ray_tpu/parallel/sharding.py`)
lays them over `tp`: the heads and kv heads (the columns of `wq`, `wk`,
`wv`, the rows of `wo`), the FFN (the columns of `gate` and `up`, the
rows of `down`) and the vocab (the columns of `lm_head`). The norms and
`embed` are replicated, so the lookup stays a gather. A tied model's
shard carries its slice of the head as its own `lm_head`.
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


# leaf -> (the axis it splits along over tp, the config dimension that
# axis spans); every other leaf is replicated
TP_SPLITS = {"wq": (1, "n_heads"), "wk": (1, "kv_heads"),
             "wv": (1, "kv_heads"), "wo": (0, "n_heads"),
             "gate": (1, "d_ff"), "up": (1, "d_ff"), "down": (0, "d_ff"),
             "lm_head": (1, "vocab_size")}


def check_tp(config: TransformerConfig, tp: int) -> None:
    """Raise a ValueError naming the first dimension that `tp` ranks
    cannot split evenly."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if config.moe_num_experts:
        raise ValueError("a tp shard of the params covers dense FFN "
                         "layers only")
    for dim in ("n_heads", "kv_heads", "d_ff", "vocab_size"):
        n = getattr(config, dim)
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {dim}={n}")


def _tp_leaf(config: TransformerConfig, tp: int, rank: int, device):
    """`take(name, leaf)`: the rank's part of one leaf, on `device`
    (None: where the leaf is), in memory of its own, so the whole leaf
    can be freed."""
    dev = None if device is None else resolve_device(device)

    def take(name: str, t: torch.Tensor) -> torch.Tensor:
        split = TP_SPLITS.get(name)
        if split is None:
            return t if dev is None else t.to(dev)
        axis = split[0]
        n = t.shape[axis] // tp
        part = t.narrow(axis, rank * n, n)
        if dev is not None and dev != t.device:
            return part.to(dev).contiguous()
        return part.clone(memory_format=torch.contiguous_format)
    return take


def tp_shard_params(params: Params, config: TransformerConfig, tp: int,
                    rank: int, device=None) -> Params:
    """Rank `rank`'s shard of `params` over `tp` ranks, leaf by leaf, each
    part copied to `device` (None: where the leaf is). `params` is left
    as it is."""
    check_tp(config, tp)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside 0..{tp - 1}")
    take = _tp_leaf(config, tp, rank, device)
    shard: Params = {
        "embed": take("embed", params["embed"]),
        "layers": [{name: take(name, t) for name, t in layer.items()}
                   for layer in params["layers"]],
        "final_norm": take("final_norm", params["final_norm"]),
    }
    head = (params["embed"].T if config.tie_embeddings
            else params["lm_head"])
    shard["lm_head"] = take("lm_head", head)
    return shard


def init_shard_for_serving(model: Transformer, seed: int, tp: int,
                           rank: int, device=None) -> Params:
    """`tp_shard_params(init_for_serving(model, seed, device), ...)`, leaf
    by leaf: the same values, with the peak memory of the shard plus one
    whole leaf."""
    config = model.config
    check_tp(config, tp)
    cast = _serving_leaf(config)
    take = _tp_leaf(config, tp, rank, None)
    tied = config.tie_embeddings
    head = []

    def finish(name: str, t: torch.Tensor) -> torch.Tensor:
        t = cast(name, t)
        if tied and name == "embed":
            head.append(take("lm_head", t.T))
        return take(name, t)
    shard = model.init_leaves(seed, device, finish)
    if tied:
        shard["lm_head"] = head[0]
    return shard
