"""Loss ops: token cross-entropy in f32 and the chunked LM loss.

Port of `ray_tpu/ops/losses.py`, with the vocab-sharded variant
(`sharded_softmax_cross_entropy`) over a mesh axis's group.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel import collectives


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


def _dense_per_token(logits, labels):
    return softmax_cross_entropy(logits, labels)[1]


def _chunk_loss(xc, head, lc, mc, per_token_fn):
    logits = (xc @ head).to(torch.float32)
    return (per_token_fn(logits, lc) * mc).sum()


def chunked_ce_sum(x: torch.Tensor, head: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   chunk_size: int, per_token_fn=_dense_per_token
                   ) -> torch.Tensor:
    """The masked SUM of token CE over sequence chunks, each chunk's
    logits recomputed in the backward. `per_token_fn(logits, labels)`
    gives a chunk's per-token losses (the vocab-sharded CE on a mesh)."""
    b, s, _ = x.shape
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
        args = (x[:, sl], head, labels[:, sl], mask[:, sl], per_token_fn)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_loss, *args,
                                       use_reentrant=False)
        else:
            total = total + _chunk_loss(*args)
    return total


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
    total = chunked_ce_sum(x, head, labels, mask, chunk_size)
    return total / mask.sum().clamp_min(1.0)


def sharded_softmax_cross_entropy(local_logits: torch.Tensor,
                                  labels: torch.Tensor, axis: str,
                                  vocab_shard_size: int,
                                  mask: Optional[torch.Tensor] = None, *,
                                  mesh):
    """CE when the vocab dim is sharded over mesh `axis`, on each rank's
    local logits (inside `local_map`).

    Each rank holds logits[..., lo:lo+shard]; the logsumexp and the
    label-logit gather are allreduced over the axis, so no rank
    materialises the full vocab. The global max is a constant shift
    (stopped in both places it appears, so its terms cancel exactly in
    the backward, where `lax.pmax` has no gradient to give). Returns
    (mean loss, per-token loss), the same on every rank of the axis.
    """
    local_logits = local_logits.to(torch.float32)
    lo = collectives.axis_index(axis, mesh=mesh) * vocab_shard_size
    with torch.no_grad():
        gmax = collectives.allreduce(local_logits.amax(dim=-1), axis, "max",
                                     mesh=mesh)
    shifted = local_logits - gmax[..., None]
    sumexp = collectives.allreduce(torch.exp(shifted).sum(dim=-1), axis,
                                   mesh=mesh)
    lse = torch.log(sumexp) + gmax
    local_label = labels.long() - lo
    in_shard = (local_label >= 0) & (local_label < vocab_shard_size)
    safe = local_label.clamp(0, vocab_shard_size - 1)
    picked = torch.gather(local_logits, -1, safe[..., None])[..., 0]
    label_logit = collectives.allreduce(torch.where(in_shard, picked, 0.0),
                                        axis, mesh=mesh)
    per_token = lse - label_logit
    if mask is None:
        return per_token.mean(), per_token
    mask = mask.to(torch.float32)
    denom = mask.sum().clamp_min(1.0)
    return (per_token * mask).sum() / denom, per_token
