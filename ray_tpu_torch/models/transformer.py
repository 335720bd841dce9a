"""Llama-family decoder: GQA + RoPE + SwiGLU on the port's ops.

Port of the dense branch of `ray_tpu/models/transformer.py`. Parameters
are a plain dict, as in the JAX package, with one difference: the
layers are a list of per-layer dicts instead of arrays stacked on a
leading layers axis (PyTorch runs the layer loop eagerly; there is no
scan to feed). Matmul weights, `embed` and `lm_head` are stored in the
activation dtype, cast once when made; the norm weights stay in the
parameter dtype (f32), since the RMSNorm kernel reads `(1 + w)` in f32.

Not in this slice: `loss` and remat (training), the MoE, ring-attention
and pipeline branches, and the one-hot embedding, which exists for XLA
SPMD and has no use here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope_cached, rope_cos_sin

Params = Dict[str, Any]


class Transformer(nn.Module):
    """Functional model for one TransformerConfig: `init` makes the
    parameters, `apply(params, tokens)` runs the forward."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        if config.moe_num_experts:
            raise NotImplementedError(
                "the port's Transformer has the dense FFN only so far")
        self.config = config

    # ------------------------------------------------------------ init
    def init(self, seed: int, device=None) -> Params:
        """Random parameters from `seed`, made on `device` (default: the
        card). Same structure and scales as the JAX `init`; the numbers
        differ, as torch and JAX generators do."""
        c = self.config
        dev = resolve_device(device)
        ad, pd = c.activation_dtype, c.parameter_dtype
        e, f, hd = c.d_model, c.d_ff, c.head_dim
        qd, kvd = c.n_heads * hd, c.kv_heads * hd
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        std = 0.02
        out_std = std / math.sqrt(2 * c.n_layers)

        def w(shape, scale):
            x = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return x.mul_(scale).to(ad)

        layers = []
        for _ in range(c.n_layers):
            layers.append({
                "attn_norm": torch.zeros((e,), dtype=pd, device=dev),
                "wq": w((e, qd), std),
                "wk": w((e, kvd), std),
                "wv": w((e, kvd), std),
                "wo": w((qd, e), out_std),
                "mlp_norm": torch.zeros((e,), dtype=pd, device=dev),
                "gate": w((e, f), std),
                "up": w((e, f), std),
                "down": w((f, e), out_std),
            })
        params: Params = {
            "embed": w((c.vocab_size, e), std),
            "layers": layers,
            "final_norm": torch.zeros((e,), dtype=pd, device=dev),
        }
        if not c.tie_embeddings:
            params["lm_head"] = w((e, c.vocab_size), std)
        return params

    # --------------------------------------------------------- forward
    def _embed_lookup(self, table: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
        return table[tokens]

    def _layer(self, x: torch.Tensor, layer: Params, rope) -> torch.Tensor:
        c = self.config
        b, s, _ = x.shape
        hd = c.head_dim

        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q = (h @ layer["wq"]).view(b, s, c.n_heads, hd)
        k = (h @ layer["wk"]).view(b, s, c.kv_heads, hd)
        v = (h @ layer["wv"]).view(b, s, c.kv_heads, hd)
        cos, sin = rope
        q = apply_rope_cached(q, cos, sin)
        k = apply_rope_cached(k, cos, sin)
        attn = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True,
                               block_q=c.attn_block_q,
                               block_k=c.attn_block_k)
        attn = attn.transpose(1, 2).reshape(b, s, c.n_heads * hd)
        x = x + attn @ layer["wo"]

        h = rms_norm(x, layer["mlp_norm"], c.norm_eps)
        gate = F.silu(h @ layer["gate"])
        up = h @ layer["up"]
        return x + (gate * up) @ layer["down"]

    def hidden(self, params: Params, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Trunk: tokens (b, s) -> post-final-norm hidden states (b, s, e)."""
        c = self.config
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self._embed_lookup(params["embed"], tokens)
        rope = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        for layer in params["layers"]:
            x = self._layer(x, layer, rope)
        return rms_norm(x, params["final_norm"], c.norm_eps)

    def _head(self, params: Params) -> torch.Tensor:
        return (params["embed"].T if self.config.tie_embeddings
                else params["lm_head"])

    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) int -> logits (b, s, vocab) in f32."""
        x = self.hidden(params, tokens, positions)
        return (x @ self._head(params)).to(torch.float32)

    forward = apply
