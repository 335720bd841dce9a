"""The plain reference: Mistral-7B's and Mixtral-8x7B's decoder in
float32, written from the published architecture.

A pre-norm decoder: RMSNorm, grouped-query attention with rotary
embeddings (the split-halves convention of the published code,
`rotate_half`), a SwiGLU MLP or a top-k mixture of SwiGLU experts, a
final RMSNorm and an untied head. Plain `torch` operations, no kernels,
no cache, no batching of requests. It imports nothing of the program.

Departures from the published models, each the configuration as it is
run (the config files list them):
  * RMSNorm scales by (1 + w), the same function reparametrised;
  * the experts take a bounded number of tokens each (GShard capacity,
    `capacity_factor`), assignments queued first choice before second
    choice; a dropped assignment adds nothing to its token (the other
    keeps its renormalised weight). Mixtral drops no token;
  * the load-balance term is the Switch form over first choices,
    E * sum_e(first-choice share_e * mean router probability_e), and the
    loss adds `aux_coef` times its mean over the layers.

`quant="fp8"` is the control: every matmul's operands rounded to float8
e4m3 at a scale for each tensor (weights, activations and, in the
backward, gradients), as fp8 training with per-tensor scaling does, the
products then taken in float32.

Parameters are the benchmark's tree (`weights.make_params`): `embed`,
`layers` (dicts), `final_norm`, `lm_head`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
E4M3_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at the tensor's amax scale, back in float32."""
    scale = E4M3_MAX / x.abs().amax().clamp_min(1e-12)
    return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale


class _MM8(torch.autograd.Function):
    """x @ w with every product's operands in e4m3, each at its tensor's
    scale, the backward's too (the forward's x and w, the incoming
    gradient)."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x.reshape(-1, x.shape[-1])), _fp8(w)
        ctx.save_for_backward(xq, wq)
        ctx.shape = x.shape
        return (xq @ wq).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g.reshape(-1, g.shape[-1]))
        return (gq @ wq.t()).reshape(ctx.shape), xq.t() @ gq


def mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    """x @ w in float32 (or, for the control, in fp8)."""
    x, w = x.to(F32), w.to(F32)
    if quant == "fp8":
        return _MM8.apply(x, w)
    if quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.to(F32))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (s, heads, hd) rotated by position: pairs (i, i + hd/2)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                        device=x.device) / hd))
    ang = pos.to(F32)[:, None] * inv[None, :]                  # (s, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, head_block: int = 8) -> torch.Tensor:
    """Causal softmax attention of one sequence, float32. q (s, h, hd),
    k/v (s, kvh, hd); query heads share kv heads in groups. Heads are
    taken `head_block` at a time to bound the (s, s) scores."""
    s, h, hd = q.shape
    group = h // k.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()

    def heads(qh, kh, vh):
        scores = (qh @ kh.transpose(1, 2)) / math.sqrt(hd)
        scores = scores.masked_fill(~mask, float("-inf"))
        return torch.softmax(scores, dim=-1) @ vh

    outs = []
    for h0 in range(0, h, head_block):
        hs = range(h0, min(h, h0 + head_block))
        qh = q[:, h0:h0 + len(hs)].transpose(0, 1)             # (n, s, hd)
        kv_idx = torch.tensor([i // group for i in hs], device=q.device)
        kh = k[:, kv_idx].transpose(0, 1)
        vh = v[:, kv_idx].transpose(0, 1)
        # under autograd each block keeps only its inputs and recomputes
        # its scores in the backward
        outs.append(checkpoint(heads, qh, kh, vh, use_reentrant=False)
                    if torch.is_grad_enabled() else heads(qh, kh, vh))
    return torch.cat(outs, dim=0).transpose(0, 1)              # (s, h, hd)


def attention_block(x, layer, cfg, pos, quant) -> torch.Tensor:
    """x + attention(norm(x)), x (s, d) float32."""
    s = x.shape[0]
    hd = cfg["head_dim"]
    h = rms_norm(x, layer["attn_norm"], cfg["norm_eps"])
    q = mm(h, layer["wq"], quant).view(s, -1, hd)
    k = mm(h, layer["wk"], quant).view(s, -1, hd)
    v = mm(h, layer["wv"], quant).view(s, -1, hd)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    a = attention(q, k, v).reshape(s, -1)
    return x + mm(a, layer["wo"], quant)


def swiglu(x, gate, up, down, quant) -> torch.Tensor:
    return mm(F.silu(mm(x, gate, quant)) * mm(x, up, quant), down, quant)


def moe(h: torch.Tensor, layer, cfg, quant):
    """(output (T, d), load-balance term) of the expert layer."""
    T = h.shape[0]
    E, k = cfg["experts"], cfg["top_k"]
    cap = max(1, math.ceil(T * k / E * cfg["capacity_factor"]))
    probs = torch.softmax(mm(h, layer["router"], quant), dim=-1)   # (T, E)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    # assignments in queue order: every first choice, then every second
    order_e = top_e.t().reshape(-1)                              # (k*T,)
    onehot = F.one_hot(order_e, E)
    slot = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)        # (k*T,)
    kept = slot < cap
    token = torch.arange(k * T, device=h.device) % T
    weight = top_p.t().reshape(-1)
    out = torch.zeros_like(h)
    for e in range(E):
        sel = torch.nonzero((order_e == e) & kept).squeeze(1)
        if sel.numel() == 0:
            continue
        t = token[sel]
        y = swiglu(h[t], layer["moe_gate"][e], layer["moe_up"][e],
                   layer["moe_down"][e], quant)
        out = out.index_add(0, t, y * weight[sel, None])
    first = F.one_hot(top_e[:, 0], E).to(F32).mean(0)
    lb = E * (first * probs.mean(0)).sum()
    return out, lb


def block(x, layer, cfg, pos, quant):
    """One decoder layer: (x, load-balance term or 0)."""
    x = attention_block(x, layer, cfg, pos, quant)
    h = rms_norm(x, layer["mlp_norm"], cfg["norm_eps"])
    if cfg["experts"]:
        y, lb = moe(h, layer, cfg, quant)
        return x + y, lb
    return x + swiglu(h, layer["gate"], layer["up"], layer["down"],
                      quant), torch.zeros((), device=x.device)


def hidden(params, tokens: torch.Tensor, cfg, quant=None,
           remat: bool = False):
    """Final-normed hidden states (s, d) of one sequence, and the
    load-balance terms summed over the layers."""
    x = params["embed"][tokens].to(F32)
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    aux = torch.zeros((), device=x.device)
    for layer in params["layers"]:
        if remat:
            x, lb = checkpoint(block, x, layer, cfg, pos, quant,
                               use_reentrant=False)
        else:
            x, lb = block(x, layer, cfg, pos, quant)
        aux = aux + lb
    return rms_norm(x, params["final_norm"], cfg["norm_eps"]), aux


def logits(params, tokens: torch.Tensor, cfg, quant=None,
           rows: slice = slice(None)) -> torch.Tensor:
    """Float32 logits (s, vocab) of one sequence, at the positions
    `rows` (default: every one)."""
    with torch.no_grad():
        x, _ = hidden(params, tokens, cfg, quant)
        return mm(x[rows], params["lm_head"], quant)


def loss(params, batch: torch.Tensor, cfg, quant=None,
         remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy over every row of `batch` (b, s)
    and every position but the last, plus `aux_coef` times the mean
    load-balance term over the layers (an expert model). The expert
    layer routes all the batch's tokens together, as one step does."""
    b, s = batch.shape
    if cfg["experts"]:
        # routing and capacity see the whole batch: run the layers over
        # the batch's tokens as one sequence of rows per layer
        x = params["embed"][batch].to(F32)                   # (b, s, d)
        pos = torch.arange(s, device=batch.device)
        aux = torch.zeros((), device=x.device)
        for layer in params["layers"]:
            x, lb = checkpoint(_batch_block, x, layer, cfg, pos, quant,
                               use_reentrant=False) if remat else \
                _batch_block(x, layer, cfg, pos, quant)
            aux = aux + lb
        x = rms_norm(x, params["final_norm"], cfg["norm_eps"])
    else:
        xs = [hidden(params, row, cfg, quant, remat)[0] for row in batch]
        x, aux = torch.stack(xs), torch.zeros((), device=batch.device)
    total = torch.zeros((), device=batch.device)
    for i in range(b):
        lg = mm(x[i, :-1], params["lm_head"], quant)
        total = total + F.cross_entropy(lg, batch[i, 1:], reduction="sum")
    ce = total / (b * (s - 1))
    if cfg["experts"]:
        ce = ce + cfg["aux_coef"] * aux / len(params["layers"])
    return ce


def _batch_block(x, layer, cfg, pos, quant):
    """One layer over a batch (b, s, d): attention row by row, the expert
    layer over all b * s tokens at once."""
    b, s, d = x.shape
    x = torch.stack([attention_block(x[i], layer, cfg, pos, quant)
                     for i in range(b)])
    h = rms_norm(x, layer["mlp_norm"], cfg["norm_eps"]).reshape(b * s, d)
    y, lb = moe(h, layer, cfg, quant)
    return x + y.view(b, s, d), lb


class AdamW:
    """Decoupled weight decay Adam (Loshchilov and Hutter), float32 state,
    bias-corrected, as `torch.optim.AdamW` and `optax.adamw` define it."""

    def __init__(self, leaves: List[torch.Tensor], lr: float, betas,
                 eps: float, weight_decay: float):
        self.leaves, self.lr, self.eps, self.wd = leaves, lr, eps, \
            weight_decay
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p, dtype=F32) for p in leaves]
        self.v = [torch.zeros_like(p, dtype=F32) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def sizes(config: Dict, capacity_factor: float = 1.25) -> Dict:
    """The reference's settings from a config file's published keys."""
    d = config["hidden_size"]
    return {"head_dim": config.get("head_dim")
            or d // config["num_attention_heads"],
            "norm_eps": float(config["rms_norm_eps"]),
            "rope_theta": float(config["rope_theta"]),
            "experts": int(config.get("num_local_experts") or 0),
            "top_k": int(config.get("num_experts_per_tok") or 0),
            "capacity_factor": float(config.get("run", {}).get(
                "moe_capacity_factor", capacity_factor)),
            "aux_coef": float(config.get("router_aux_loss_coef") or 0.0)}
