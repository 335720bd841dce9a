"""Driver entry points: the single-card forward step and the multi-rank
dry run.

The counterpart of the repo root's `__graft_entry__.py`. `entry()`
returns the forward step of the flagship model with its example
arguments; on the card each forward launches the flash-attention forward
kernel once a layer (head_dim 64) and the RMSNorm kernel twice a layer
and once at the end. `dryrun_multichip(n)` and `_mesh_specs_for(n)` are
`ray_tpu_torch.dryrun`'s: the full training step over n-rank meshes of
gloo CPU ranks, held to a one-process run.
"""
from __future__ import annotations

import torch

from ray_tpu_torch.dryrun import _mesh_specs_for, dryrun_multichip
from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops.dispatch import resolve_device

__all__ = ["entry", "dryrun_multichip", "_mesh_specs_for",
           "_provision_devices", "_flagship_config"]


def _flagship_config(**overrides) -> TransformerConfig:
    base = dict(
        vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
        n_kv_heads=4, d_ff=1408, max_seq_len=512, remat=True,
        dtype="bfloat16", param_dtype="float32")
    base.update(overrides)
    return TransformerConfig(**base)


def entry(device=None):
    """(fn, example_args): the flagship model's forward step
    `fn(params, tokens) -> logits (2, 256, 32000) f32`, with parameters
    from seed 0 and tokens (2, 256) of zeros on `device` (default: the
    card)."""
    dev = resolve_device(device)
    model = Transformer(_flagship_config())
    params = model.init(0, dev)
    tokens = torch.zeros((2, 256), dtype=torch.long, device=dev)

    def fn(params, tokens):
        with torch.no_grad():
            return model.apply(params, tokens)

    return fn, (params, tokens)


def _provision_devices(n: int) -> list:
    """n devices: the first n cards where the host has them, else n CPU
    devices (each a gloo rank's, as `dryrun_multichip` runs them)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * n

