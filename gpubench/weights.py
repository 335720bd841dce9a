"""The weights of a run, made from its seed on the device.

Both sides get the same bits: the program receives the tree that
`make_params` builds from a config file's `core.dims`, and the reference
makes it again after the window from the same seed (`iter_leaves` in the
same order), so it reads nothing that the program made. The tree has
the layout the port's `Transformer` takes: `embed`, `layers` (a list of
per-layer dicts, laid out by the architecture's `leaf_specs`),
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

from gpubench import core

QK_GAIN = 1.6


def leaf_specs(dims) -> List[Tuple[str, tuple, float]]:
    """(name, shape of one layer's leaf, std) of every per-layer leaf, as
    the architecture lays them out (`arch.leaf_specs`)."""
    return core.arch_named(dims.architecture).leaf_specs(dims)


def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    x = torch.empty(shape, dtype=dtype, device=device)
    x.normal_(0.0, std, generator=gen)
    return x


def iter_leaves(dims, seed: int, device, dtype: torch.dtype,
                stacked: bool) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every leaf, in the one order both sides use.
    `stacked`: each per-layer leaf is made for all layers in one call
    (serving: a view per layer); otherwise one tensor a layer, so each
    is a leaf of its own for the optimizer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    yield ("embed",), _normal(gen, (dims.vocab_size, dims.d_model), 1.0,
                              dtype, device)
    for name, shape, std in leaf_specs(dims):
        if stacked:
            slab = _normal(gen, (dims.n_layers, *shape), std, dtype, device)
            for i in range(dims.n_layers):
                yield ("layers", i, name), slab[i]
        else:
            for i in range(dims.n_layers):
                yield ("layers", i, name), _normal(gen, shape, std, dtype,
                                                   device)
    yield ("final_norm",), _normal(gen, (dims.d_model,), 0.1, dtype, device)
    yield ("lm_head",), _normal(gen, (dims.d_model, dims.vocab_size),
                                1 / math.sqrt(dims.d_model), dtype, device)


def make_params(dims, seed: int, device, dtype: torch.dtype,
                stacked: bool) -> Dict:
    """The whole tree, in `dtype`, on `device`."""
    if dims.tie_embeddings:
        raise ValueError("the benchmark's configurations untie the head")
    tree = {"layers": [{} for _ in range(dims.n_layers)]}
    for path, t in iter_leaves(dims, seed, device, dtype, stacked):
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


def paths(dims) -> List[tuple]:
    """Every leaf's path, in `iter_leaves` order (made without tensors)."""
    out = [("embed",)]
    for name, _shape, _std in leaf_specs(dims):
        out += [("layers", i, name) for i in range(dims.n_layers)]
    return out + [("final_norm",), ("lm_head",)]
