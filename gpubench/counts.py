"""Operations and bytes that the inputs need, and the card's peaks.

Every roofline share and every `mfu` reads these. They count what the
inputs need (each prompt at its true length, each decode row at its own
context, attention's causal triangle once), never what a kernel happens
to compute (padding, a whole-`max_seq_len` gather, recomputation), so a
later kernel that does less work is read by the same yardstick.

A "model" here is a plain dict of sizes (`sizes(cfg)`), so the counts
take no object of the program.
"""
from __future__ import annotations

from typing import Dict

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense, no sparsity) at its
# full 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16 = 2


def sizes(cfg) -> Dict[str, int]:
    """The sizes the counts read, from a TransformerConfig."""
    return {"d": cfg.d_model, "f": cfg.d_ff, "layers": cfg.n_layers,
            "heads": cfg.n_heads, "kv_heads": cfg.kv_heads,
            "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
            "experts": cfg.moe_num_experts, "top_k": cfg.moe_top_k}


def layer_matmul_params(m: Dict[str, int], active_only: bool = True) -> int:
    """Weights one token multiplies in one layer: q, k, v, o, and the FFN
    (the experts it is routed to, and the router, for an MoE layer)."""
    d, f, hd = m["d"], m["f"], m["head_dim"]
    attn = d * hd * (2 * m["heads"] + 2 * m["kv_heads"])
    if not m["experts"]:
        return attn + 3 * d * f
    n = m["top_k"] if active_only else m["experts"]
    return attn + n * 3 * d * f + d * m["experts"]


def causal_pairs(s: int) -> int:
    """(query, key) pairs under a causal mask over s positions."""
    return s * (s + 1) // 2


# ------------------------------------------------------------ attention
def attn_fwd_flops(heads: int, head_dim: int, pairs: int) -> float:
    """QK^T and PV over `pairs` (query, key) pairs of every query head."""
    return 4.0 * heads * head_dim * pairs


def attn_fwd_bytes(s: int, heads: int, kv_heads: int, head_dim: int,
                   batch: int = 1) -> float:
    """Q, K, V read once, O written once (bf16), lse written (f32)."""
    return batch * s * (BF16 * head_dim * (2 * heads + 2 * kv_heads)
                        + 4 * heads)


def attn_bwd_flops(heads: int, head_dim: int, pairs: int) -> float:
    """The backward's five products over the pairs: S = QK^T again (the
    forward kept only lse), dV = P^T dO, dP = dO V^T, dQ = dS K,
    dK = dS^T Q."""
    return 10.0 * heads * head_dim * pairs


def attn_bwd_bytes(s: int, heads: int, kv_heads: int, head_dim: int,
                   batch: int = 1) -> float:
    """Q, K, V, O, dO and lse read; dQ, dK, dV written."""
    q_like = BF16 * head_dim * heads          # q, o, do, dq: per position
    kv_like = BF16 * head_dim * kv_heads      # k, v, dk, dv
    return batch * s * (4 * q_like + 4 * kv_like + 4 * heads)


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


# -------------------------------------------------------------- serving
def prefill_flops(m: Dict[str, int], length: int) -> float:
    """One prompt of `length` tokens: every layer's matmuls for each
    token, causal attention, and the head for the last position only
    (the engine needs the next token's logits, nothing more)."""
    layers = m["layers"]
    mm = 2.0 * layer_matmul_params(m) * length * layers
    attn = attn_fwd_flops(m["heads"], m["head_dim"],
                          causal_pairs(length)) * layers
    return mm + attn + 2.0 * m["d"] * m["vocab"]


def decode_step_counts(m: Dict[str, int], rows: int,
                       contexts: int) -> Dict[str, float]:
    """One decode step over `rows` active rows whose contexts (the
    positions each attends to, its new token included) sum to
    `contexts`: the weights read once, each row's own K/V read and its
    new K/V written, and the FLOPs of its token."""
    layers, kvh, hd = m["layers"], m["kv_heads"], m["head_dim"]
    weights = BF16 * (layer_matmul_params(m, active_only=False) * layers
                      + m["d"] * m["vocab"])
    kv = BF16 * 2 * kvh * hd * layers * (contexts + rows)
    flops = (2.0 * (layer_matmul_params(m) * layers + m["d"] * m["vocab"])
             * rows
             + attn_fwd_flops(m["heads"], hd, contexts) * layers)
    return {"flops": flops, "bytes": float(weights + kv)}


# ------------------------------------------------------------- training
def train_flops_per_token(m: Dict[str, int], seq: int) -> float:
    """Model FLOPs a token of a training step: forward and backward
    (3 x 2 x the active matmul weights, the head included) and causal
    attention at `seq`; no recomputation, no dispatch or combine
    products (an MoE's routing moves tokens, it computes nothing of the
    model)."""
    layers = m["layers"]
    mm = 6.0 * (layer_matmul_params(m) * layers + m["d"] * m["vocab"])
    attn = 3.0 * attn_fwd_flops(m["heads"], m["head_dim"],
                                causal_pairs(seq)) * layers / seq
    return mm + attn


def total_params(m: Dict[str, int], tied: bool = False) -> int:
    """Every parameter: embedding, layers (with both norms), final norm,
    head."""
    per_layer = layer_matmul_params(m, active_only=False) + 2 * m["d"]
    head = 0 if tied else m["d"] * m["vocab"]
    return m["vocab"] * m["d"] + m["layers"] * per_layer + m["d"] + head
