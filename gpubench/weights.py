"""The weights of a run, made from its seed on the device.

Both sides get the same bits: the program receives the tree that
`make_params` builds, and the reference makes it again after the window
from the same seed (`iter_leaves` in the same order), so it reads
nothing that the program made. The tree has the layout the port's
`Transformer` takes: `embed`, `layers` (a list of per-layer dicts),
`final_norm`, `lm_head`.

Scales (standard deviations) are chosen so that every part shows in the
logits: the embedding at 1, so the residual stream starts at unit size;
q and k at `QK_GAIN / sqrt(d)`, so the attention scores have a standard
deviation of about QK_GAIN**2 and each query attends to a few keys, as a
trained model's heads do (with 1/sqrt(d) the scores are near uniform and
a long context averages the values away); every other matmul at
1/sqrt(fan_in); the norm weights, which the port applies as (1 + w), at
0.1.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

QK_GAIN = 1.6


def leaf_specs(cfg) -> List[Tuple[str, tuple, float]]:
    """(name, shape of one layer's leaf, std) of every per-layer leaf."""
    e, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.kv_heads * hd
    specs = [("attn_norm", (e,), 0.1),
             ("wq", (e, qd), QK_GAIN / math.sqrt(e)),
             ("wk", (e, kvd), QK_GAIN / math.sqrt(e)),
             ("wv", (e, kvd), 1 / math.sqrt(e)),
             ("wo", (qd, e), 1 / math.sqrt(qd)),
             ("mlp_norm", (e,), 0.1)]
    E = cfg.moe_num_experts
    if E:
        specs += [("router", (e, E), 1 / math.sqrt(e)),
                  ("moe_gate", (E, e, f), 1 / math.sqrt(e)),
                  ("moe_up", (E, e, f), 1 / math.sqrt(e)),
                  ("moe_down", (E, f, e), 1 / math.sqrt(f))]
    else:
        specs += [("gate", (e, f), 1 / math.sqrt(e)),
                  ("up", (e, f), 1 / math.sqrt(e)),
                  ("down", (f, e), 1 / math.sqrt(f))]
    return specs


def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    x = torch.empty(shape, dtype=dtype, device=device)
    x.normal_(0.0, std, generator=gen)
    return x


def iter_leaves(cfg, seed: int, device, dtype: torch.dtype,
                stacked: bool) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every leaf, in the one order both sides use.
    `stacked`: each per-layer leaf is made for all layers in one call
    (serving: a view per layer); otherwise one tensor a layer, so each
    is a leaf of its own for the optimizer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    yield ("embed",), _normal(gen, (cfg.vocab_size, cfg.d_model), 1.0,
                              dtype, device)
    for name, shape, std in leaf_specs(cfg):
        if stacked:
            slab = _normal(gen, (cfg.n_layers, *shape), std, dtype, device)
            for i in range(cfg.n_layers):
                yield ("layers", i, name), slab[i]
        else:
            for i in range(cfg.n_layers):
                yield ("layers", i, name), _normal(gen, shape, std, dtype,
                                                   device)
    yield ("final_norm",), _normal(gen, (cfg.d_model,), 0.1, dtype, device)
    yield ("lm_head",), _normal(gen, (cfg.d_model, cfg.vocab_size),
                                1 / math.sqrt(cfg.d_model), dtype, device)


def make_params(cfg, seed: int, device, dtype: torch.dtype,
                stacked: bool) -> Dict:
    """The whole tree, in `dtype`, on `device`."""
    if cfg.tie_embeddings:
        raise ValueError("the benchmark's configurations untie the head")
    tree = {"layers": [{} for _ in range(cfg.n_layers)]}
    for path, t in iter_leaves(cfg, seed, device, dtype, stacked):
        if path[0] == "layers":
            tree["layers"][path[1]][path[2]] = t
        else:
            tree[path[0]] = t
    return tree


def get_leaf(tree: Dict, path: tuple) -> torch.Tensor:
    node = tree
    for key in path:
        node = node[key]
    return node


def paths(cfg) -> List[tuple]:
    """Every leaf's path, in `iter_leaves` order (made without tensors)."""
    out = [("embed",)]
    for name, _shape, _std in leaf_specs(cfg):
        out += [("layers", i, name) for i in range(cfg.n_layers)]
    return out + [("final_norm",), ("lm_head",)]
