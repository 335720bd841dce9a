"""Loss ops: token cross-entropy in f32 and the chunked LM loss.

Port of `ray_tpu/ops/losses.py`. The vocab-sharded variant
(`sharded_softmax_cross_entropy`) belongs to the tensor-parallel slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0):
    """Token-level CE. logits (..., vocab); labels int (...,).

    Returns (mean_loss, per_token_loss). `mask` (labels' shape, 1 =
    count) excludes padding from the mean. `z_loss` adds the logsumexp^2
    regulariser.
    """
    logits = logits.to(torch.float32)
    # No detach on the max: the two m-terms must cancel in the backward (a
    # half-stopped max adds a spurious one_hot(argmax) to every token's
    # gradient).
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1,
                               labels.long()[..., None])[..., 0]
    per_token = lse - label_logit
    if z_loss:
        per_token = per_token + z_loss * lse.square()
    if mask is None:
        return per_token.mean(), per_token
    mask = mask.to(torch.float32)
    denom = mask.sum().clamp_min(1.0)
    return (per_token * mask).sum() / denom, per_token


def _chunk_loss(xc, head, lc, mc):
    logits = (xc @ head).to(torch.float32)
    _, per_token = softmax_cross_entropy(logits, lc)
    return (per_token * mc).sum()


def chunked_lm_loss(x: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk_size: int = 512) -> torch.Tensor:
    """LM head projection + CE over sequence chunks, each chunk's logits
    recomputed in the backward (`torch.utils.checkpoint`), so the full
    (b, s, vocab) f32 logits never exist at once.

    x: (b, s, e) final hidden states; head (e, vocab); labels (b, s).
    The padded tail of the last chunk carries mask 0. Returns the mean
    loss over unmasked positions.
    """
    b, s, _ = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    if s % chunk_size:
        pad = chunk_size - s % chunk_size
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
        s += pad
    total = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        args = (x[:, sl], head, labels[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_loss, *args,
                                       use_reentrant=False)
        else:
            total = total + _chunk_loss(*args)
    return total / mask.sum().clamp_min(1.0)
