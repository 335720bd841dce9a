"""Llama-family decoder: GQA + RoPE + SwiGLU on the port's ops.

Port of the dense branch of `ray_tpu/models/transformer.py`. Parameters
are a plain dict, as in the JAX package, with one difference: the
layers are a list of per-layer dicts instead of arrays stacked on a
leading layers axis (PyTorch runs the layer loop eagerly; there is no
scan to feed). Every leaf is stored in the parameter dtype and cast to
the activation dtype at each use, as the JAX package does, so training
differentiates and updates the parameter-dtype leaves (f32 master
weights under the default config). Serving casts the matmul weights once
instead (`models/convert.py::cast_for_serving`), after which the casts
at use are free.

Not in this slice: the MoE, ring-attention and pipeline branches, and
the one-hot embedding, which exists for XLA SPMD and has no use here.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.ops.attention import attn_remat_policy, flash_attention
from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.ops.losses import chunked_lm_loss, softmax_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope_cached, rope_cos_sin

Params = Dict[str, Any]

NORMS = ("attn_norm", "mlp_norm", "final_norm")


class Transformer(nn.Module):
    """Functional model for one TransformerConfig: `init` makes the
    parameters, `apply(params, tokens)` runs the forward and
    `loss(params, batch)` the causal LM loss."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        if config.moe_num_experts:
            raise NotImplementedError(
                "the port's Transformer has the dense FFN only so far")
        self.config = config

    # ------------------------------------------------------------ init
    def init(self, seed: int, device=None) -> Params:
        """Random parameters from `seed`, made on `device` (default: the
        card), every leaf in the parameter dtype. Same structure and
        scales as the JAX `init`; the numbers differ, as torch and JAX
        generators do."""
        return self.init_leaves(seed, device, lambda name, t: t)

    def init_leaves(self, seed: int, device,
                    finish: Callable[[str, torch.Tensor], torch.Tensor]
                    ) -> Params:
        """`init`, with `finish(name, leaf)` applied to each leaf as soon
        as it is made, so a transform (the serving cast) never holds the
        whole parameter-dtype model at once."""
        c = self.config
        dev = resolve_device(device)
        pd = c.parameter_dtype
        e, f, hd = c.d_model, c.d_ff, c.head_dim
        qd, kvd = c.n_heads * hd, c.kv_heads * hd
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        std = 0.02
        out_std = std / math.sqrt(2 * c.n_layers)

        def w(name, shape, scale):
            x = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return finish(name, x.mul_(scale).to(pd))

        def zeros(name):
            return finish(name, torch.zeros((e,), dtype=pd, device=dev))

        layers = []
        for _ in range(c.n_layers):
            layers.append({
                "attn_norm": zeros("attn_norm"),
                "wq": w("wq", (e, qd), std),
                "wk": w("wk", (e, kvd), std),
                "wv": w("wv", (e, kvd), std),
                "wo": w("wo", (qd, e), out_std),
                "mlp_norm": zeros("mlp_norm"),
                "gate": w("gate", (e, f), std),
                "up": w("up", (e, f), std),
                "down": w("down", (f, e), out_std),
            })
        params: Params = {
            "embed": w("embed", (c.vocab_size, e), std),
            "layers": layers,
            "final_norm": zeros("final_norm"),
        }
        if not c.tie_embeddings:
            params["lm_head"] = w("lm_head", (e, c.vocab_size), std)
        return params

    # --------------------------------------------------------- forward
    def _embed_lookup(self, table: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as casting the table first
        return table[tokens].to(self.config.activation_dtype)

    def _layer(self, x: torch.Tensor, layer: Params, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
        c = self.config
        ad = c.activation_dtype
        b, s, _ = x.shape
        hd = c.head_dim

        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q = (h @ layer["wq"].to(ad)).view(b, s, c.n_heads, hd)
        k = (h @ layer["wk"].to(ad)).view(b, s, c.kv_heads, hd)
        v = (h @ layer["wv"].to(ad)).view(b, s, c.kv_heads, hd)
        q = apply_rope_cached(q, cos, sin)
        k = apply_rope_cached(k, cos, sin)
        attn = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True,
                               block_q=c.attn_block_q, block_k=c.attn_block_k)
        attn = attn.transpose(1, 2).reshape(b, s, c.n_heads * hd)
        x = x + attn @ layer["wo"].to(ad)

        h = rms_norm(x, layer["mlp_norm"], c.norm_eps)
        gate = F.silu(h @ layer["gate"].to(ad))
        up = h @ layer["up"].to(ad)
        return x + (gate * up) @ layer["down"].to(ad)

    def hidden(self, params: Params, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Trunk: tokens (b, s) -> post-final-norm hidden states (b, s, e).

        With `config.remat` each layer runs under
        `torch.utils.checkpoint` (non-reentrant) when a gradient is being
        taken: its activations are recomputed in the backward. Under
        `remat_policy="full"` that includes the flash forward kernel;
        under `"save_attn"` the checkpoint keeps the kernel's O and lse
        from the forward and replays them in the recompute
        (`attn_remat_policy`), so each layer runs it once.
        """
        c = self.config
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self._embed_lookup(params["embed"], tokens)
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        remat = c.remat and torch.is_grad_enabled()
        context_fn = (attn_remat_policy() if c.remat_policy == "save_attn"
                      else noop_context_fn)
        for layer in params["layers"]:
            if remat:
                x = checkpoint(self._layer, x, layer, cos, sin,
                               use_reentrant=False, context_fn=context_fn)
            else:
                x = self._layer(x, layer, cos, sin)
        return rms_norm(x, params["final_norm"], c.norm_eps)

    def _head(self, params: Params) -> torch.Tensor:
        head = (params["embed"].T if self.config.tie_embeddings
                else params["lm_head"])
        return head.to(self.config.activation_dtype)

    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) int -> logits (b, s, vocab) in f32."""
        x = self.hidden(params, tokens, positions)
        return (x @ self._head(params)).to(torch.float32)

    forward = apply

    # ------------------------------------------------------------ loss
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Causal LM loss (a 0-d f32 tensor). batch: tokens (b, s);
        optional loss_mask (b, s) aligned with tokens-as-labels:
        loss_mask[i] = 0 excludes token i from being a prediction target.
        The dense FFN has no MoE load-balance term."""
        c = self.config
        tokens = batch["tokens"].long()
        mask = batch.get("loss_mask")
        x = self.hidden(params, tokens)
        if c.loss_chunk:
            # Full-length formulation (keeps seq divisible by the chunk):
            # labels[i] = tokens[i+1], the final position masked out.
            b, s = tokens.shape
            labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
            m = (torch.ones((b, s), dtype=torch.float32,
                            device=tokens.device)
                 if mask is None else mask.to(torch.float32))
            m = torch.cat([m[:, 1:], torch.zeros_like(m[:, :1])], dim=1)
            return chunked_lm_loss(x, self._head(params), labels, m,
                                   chunk_size=c.loss_chunk)
        logits = (x @ self._head(params)).to(torch.float32)[:, :-1]
        if mask is not None:
            mask = mask[:, 1:]
        loss, _ = softmax_cross_entropy(logits, tokens[:, 1:], mask=mask)
        return loss
