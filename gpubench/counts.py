"""Operations and bytes that the inputs need, and the card's peaks.

Every roofline share and every `mfu` reads these. They count what the
inputs need (each prompt at its true length, each decode row at its own
context, attention's causal triangle once), never what a kernel happens
to compute (padding, a whole-`max_seq_len` gather, recomputation), so a
later kernel that does less work is read by the same yardstick.

A "model" here is a plain dict of sizes (`sizes(core.dims(config))`),
so the counts take no object of the program. A layer of attention
window W counts, for each query, the keys of its window; an expert
layer counts its experts at the expert width.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense, no sparsity) at its
# full 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16 = 2


def sizes(dims) -> Dict:
    """The sizes the counts read, from a config file's `core.dims`: with
    both FFN widths, and each layer's attention window (0: full) and FFN
    kind (`dense` or `experts`)."""
    m = {"d": dims.d_model, "f": dims.d_ff, "layers": dims.n_layers,
         "heads": dims.n_heads, "kv_heads": dims.kv_heads,
         "head_dim": dims.head_dim, "vocab": dims.vocab_size,
         "experts": dims.moe_num_experts, "top_k": dims.moe_top_k}
    m.update(f_expert=getattr(dims, "d_ff_expert", m["f"]),
             windows=list(getattr(dims, "windows", [])),
             ffn=list(getattr(dims, "ffn_kinds", [])))
    return m


def layer_kinds(m: Dict) -> List[Tuple[int, str]]:
    """(attention window, FFN kind) of each layer. Sizes without them
    (one kind of layer) are full attention throughout, with experts
    where the model has experts."""
    n = m["layers"]
    windows = m.get("windows") or [0] * n
    ffn = m.get("ffn") or ["experts" if m["experts"] else "dense"] * n
    return list(zip(windows, ffn))


def windows_of(m: Dict) -> List[int]:
    """The distinct attention windows, ascending (full attention, 0, is
    none)."""
    return sorted({w for w, _kind in layer_kinds(m) if w})


def layer_matmul_params(m: Dict, active_only: bool = True,
                        layer: int = 0) -> int:
    """Weights one token multiplies in one layer: q, k, v, o, and the FFN
    (the experts it is routed to, and the router, for an expert layer),
    each FFN at its own width."""
    d, hd = m["d"], m["head_dim"]
    attn = d * hd * (2 * m["heads"] + 2 * m["kv_heads"])
    if layer_kinds(m)[layer][1] == "dense":
        return attn + 3 * d * m["f"]
    n = m["top_k"] if active_only else m["experts"]
    return attn + n * 3 * d * m.get("f_expert", m["f"]) + d * m["experts"]


def matmul_params(m: Dict, active_only: bool = True) -> int:
    """`layer_matmul_params` summed over the layers."""
    return sum(layer_matmul_params(m, active_only, i)
               for i in range(m["layers"]))


def causal_pairs(s: int) -> int:
    """(query, key) pairs under a causal mask over s positions."""
    return s * (s + 1) // 2


def window_pairs(s: int, window: int) -> int:
    """(query, key) pairs over s positions where query i sees keys
    i - window < j <= i: sum over i < s of min(i + 1, window); the
    causal triangle where the window is 0 (full) or covers s."""
    if not window or window >= s:
        return causal_pairs(s)
    return causal_pairs(window) + (s - window) * window


def pairs(m: Dict, s: int) -> int:
    """(query, key) pairs of one sequence of s positions, over every
    layer, each at its own window."""
    return sum(window_pairs(s, w) for w, _kind in layer_kinds(m))


def layer_contexts(m: Dict, contexts: int,
                   window_contexts: Sequence[int] = ()) -> List[int]:
    """Each layer's positions read by a decode step whose rows' contexts
    sum to `contexts`: that sum in a full layer; in a layer of window W,
    the sum over the rows of min(context, W), given in `window_contexts`
    for each of `windows_of(m)` in turn."""
    wins = windows_of(m)
    if len(window_contexts) != len(wins):
        raise ValueError(f"windows {wins} want their sums of "
                         f"min(context, W), got {list(window_contexts)}")
    per = {0: contexts, **dict(zip(wins, window_contexts))}
    return [per[w] for w, _kind in layer_kinds(m)]


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
def prefill_flops(m: Dict, length: int) -> float:
    """One prompt of `length` tokens: every layer's matmuls for each
    token, attention over each layer's (query, key) pairs (the causal
    triangle, or its band in a windowed layer), and the head for the
    last position only (the engine needs the next token's logits,
    nothing more)."""
    mm = 2.0 * matmul_params(m) * length
    attn = attn_fwd_flops(m["heads"], m["head_dim"], pairs(m, length))
    return mm + attn + 2.0 * m["d"] * m["vocab"]


def decode_step_counts(m: Dict, rows: int, contexts: int,
                       window_contexts: Sequence[int] = ()
                       ) -> Dict[str, float]:
    """One decode step over `rows` active rows whose contexts (the
    positions each attends to, its new token included) sum to
    `contexts` (and, for each window W of `windows_of(m)`, whose
    min(context, W) sum to `window_contexts`): the weights read once,
    each row's own K/V in each layer's reach read and its new K/V
    written, and the FLOPs of its token."""
    kvh, hd = m["kv_heads"], m["head_dim"]
    reach = layer_contexts(m, contexts, window_contexts)
    weights = BF16 * (matmul_params(m, active_only=False)
                      + m["d"] * m["vocab"])
    kv = BF16 * 2 * kvh * hd * sum(c + rows for c in reach)
    flops = (2.0 * (matmul_params(m) + m["d"] * m["vocab"]) * rows
             + attn_fwd_flops(m["heads"], hd, sum(reach)))
    return {"flops": flops, "bytes": float(weights + kv)}


def decode_attn_bytes(m: Dict, rows: int, contexts: int,
                      window_contexts: Sequence[int] = ()) -> int:
    """The least bytes of one decode step's attention, every layer: each
    row's own K/V in the layer's reach read and its new k / v written,
    q read and O written (bf16)."""
    kvh, hd = m["kv_heads"], m["head_dim"]
    qo = 2 * BF16 * m["heads"] * hd * rows
    return sum(2 * BF16 * kvh * hd * (c + rows) + qo
               for c in layer_contexts(m, contexts, window_contexts))


# ------------------------------------------------------------- training
def train_flops_per_token(m: Dict, seq: int) -> float:
    """Model FLOPs a token of a training step: forward and backward
    (3 x 2 x the active matmul weights, the head included) and
    attention over each layer's (query, key) pairs at `seq`; no
    recomputation, no dispatch or combine products (an MoE's routing
    moves tokens, it computes nothing of the model)."""
    mm = 6.0 * (matmul_params(m) + m["d"] * m["vocab"])
    attn = 3.0 * attn_fwd_flops(m["heads"], m["head_dim"],
                                pairs(m, seq)) / seq
    return mm + attn


def total_params(m: Dict, tied: bool = False) -> int:
    """Every parameter: embedding, layers (with both norms), final norm,
    head."""
    layers = matmul_params(m, active_only=False) + 2 * m["d"] * m["layers"]
    head = 0 if tied else m["d"] * m["vocab"]
    return m["vocab"] * m["d"] + layers + m["d"] + head
