"""Transformer configuration + presets (the port's own copy).

Same fields and presets as `ray_tpu/models/config.py`; only the dtype
properties differ: they return torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None      # None = MHA
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"               # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True                    # checkpoint each layer
    # "full": recompute everything in bwd. "save_attn": save the
    # flash-attention out+lse across the checkpoint.
    remat_policy: str = "full"
    use_ring_attention: bool = False      # seq-parallel attention (sp axis)
    pipeline_microbatches: int = 0
    attn_block_q: int = 128
    attn_block_k: int = 128
    loss_chunk: int = 0                   # >0: chunked LM loss (seq chunks)
    # --- Mixture of Experts (0 = dense FFN).
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01            # load-balance loss weight

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def _ffn_params(self, active_only: bool = False) -> int:
        e, f = self.d_model, self.d_ff
        if not self.moe_num_experts:
            return 3 * e * f
        experts = self.moe_top_k if active_only else self.moe_num_experts
        return experts * 3 * e * f + e * self.moe_num_experts  # + router

    def num_params(self, active_only: bool = False) -> int:
        """Parameter count (embeddings + layers + head)."""
        e, hd = self.d_model, self.head_dim
        per_layer = (e * self.n_heads * hd          # wq
                     + 2 * e * self.kv_heads * hd   # wk, wv
                     + self.n_heads * hd * e        # wo
                     + self._ffn_params(active_only)
                     + 2 * e)                       # two norms
        total = self.vocab_size * e + self.n_layers * per_layer + e
        if not self.tie_embeddings:
            total += e * self.vocab_size
        return total

    def flops_per_token(self) -> float:
        """Approximate training FLOPs/token (fwd+bwd ≈ 6·N_active +
        attention)."""
        n = self.num_params(active_only=True)
        attn = 12 * self.n_layers * self.d_model * self.max_seq_len
        return 6.0 * n + attn


def tiny(vocab_size: int = 256) -> TransformerConfig:
    """CI/debug model: runs on the CPU in seconds."""
    return TransformerConfig(
        vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=128, max_seq_len=128, remat=False,
        dtype="float32", param_dtype="float32")


def llama2_7b() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=None, d_ff=11008, max_seq_len=4096)


def llama2_13b() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=32000, d_model=5120, n_layers=40, n_heads=40,
        n_kv_heads=None, d_ff=13824, max_seq_len=4096)


def llama3_8b() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=8192, rope_theta=500000.0)


PRESETS = {
    "tiny": tiny,
    "llama2-7b": llama2_7b,
    "llama2-13b": llama2_13b,
    "llama3-8b": llama3_8b,
}
