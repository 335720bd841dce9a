"""Ring attention: exact causal attention over a sequence-split mesh axis.

Port of `ray_tpu/ops/ring_attention.py`. Each rank holds a sequence
shard of Q/K/V; K/V chunks rotate around the `sp` ring by point-to-point
passes (`collectives.ppermute`, whose backward is the reverse pass) while
every rank accumulates its Q shard's attention with online-softmax
merging: O(seq/n) memory per rank.

The chunk is plain differentiable torch, as the JAX chunk is an einsum
(not a Pallas call): it takes global offsets, so the causal mask is exact
across ring steps, and the merge by log-sum-exp needs the lse's
cotangent, which the port's flash op drops. Each chunk is recomputed in
the backward (`torch.utils.checkpoint`, as `jax.checkpoint`).

Call :func:`ring_attention` on local shards (inside `local_map`), or
:func:`ring_attention_sharded` on DTensors (or whole tensors) with a mesh.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from ray_tpu_torch.ops.sharded import (as_dtensor, attention_specs,
                                       flash_attention_sharded,
                                       pick_kv_heads)
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import compute_mesh

NEG_INF = float("-inf")


def _chunk_attention(q, k, v, q_off: int, k_off: int, causal: bool,
                     sm_scale: float):
    """Attention of a Q shard against one K/V chunk; returns (o, lse) f32.

    GQA-aware: q has (b, h, sq, d) with h = g * kvh; k/v stay at their
    raw kv-head count and are matched via a grouped einsum, so the ring
    never transfers or stores repeated K/V. Offsets are *global* token
    positions of the shard starts, so the causal mask is exact across
    ring steps. Fully-masked rows yield lse = -inf and a zero output,
    which the merge treats as "no mass".
    """
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.to(torch.float32).reshape(b, kvh, g, sq, d)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bngqd,bnkd->bngqk", qf, kf) * sm_scale
    if causal:
        qi = q_off + torch.arange(sq, device=q.device)[:, None]
        ki = k_off + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1)                                       # (b,n,g,sq)
    # Rows with every entry masked: treat as zero mass.
    dead = m <= DEFAULT_MASK_VALUE / 2
    m_safe = torch.where(dead, 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(dead[..., None], 0.0, p)
    l = p.sum(dim=-1)
    # Normalised partial output: _merge expects each partial to be a
    # proper softmax-weighted average with its mass carried in lse.
    o = torch.einsum("bngqk,bnkd->bngqd", p, vf) / l.clamp_min(
        1e-37)[..., None]
    lse = torch.where(dead | (l == 0.0), NEG_INF,
                      m_safe + torch.log(l.clamp_min(1e-37)))
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def _merge(o1, lse1, o2, lse2):
    """Combine two partial attention results via their log-sum-exps."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isinf(m) & (m < 0), 0.0, m)
    w1 = torch.where(torch.isinf(lse1) & (lse1 < 0), 0.0,
                     torch.exp(lse1 - m_safe))
    w2 = torch.where(torch.isinf(lse2) & (lse2 < 0), 0.0,
                     torch.exp(lse2 - m_safe))
    tot = w1 + w2
    safe_tot = tot.clamp_min(1e-37)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / safe_tot[..., None]
    o = torch.where(tot[..., None] == 0.0, 0.0, o)
    lse = torch.where(tot == 0.0, NEG_INF, m_safe + torch.log(safe_tot))
    return o, lse


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None, *,
                   mesh: DeviceMesh) -> torch.Tensor:
    """Exact attention over seq shards; every rank of `mesh` calls it on
    its local shards. q (b, h, s_local, d); k/v (b, kvh, s_local, d).
    Rank i of `axis` holds sequence shard i."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    h, kvh = q.shape[1], k.shape[1]
    if h % kvh:
        raise ValueError(
            f"num_heads ({h}) must be a multiple of num_kv_heads ({kvh})")
    n = collectives.axis_size(axis, mesh=mesh)
    idx = collectives.axis_index(axis, mesh=mesh)
    s_local = q.shape[2]
    q_off = idx * s_local

    o = q.new_zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32)
    lse = q.new_full(q.shape[:3], NEG_INF, dtype=torch.float32)
    kr, vr = k, v
    for r in range(n):
        # chunk currently held arrived from rank (idx - r) mod n
        k_off = ((idx - r) % n) * s_local
        # Remat each chunk so backward recomputes the (s_local, s_local)
        # scores instead of saving them per ring step.
        o_r, lse_r = checkpoint(_chunk_attention, q, kr, vr, q_off, k_off,
                                causal, sm_scale, use_reentrant=False)
        o, lse = _merge(o, lse, o_r, lse_r)
        if r != n - 1:
            kr = collectives.ppermute_ring(kr, axis, mesh=mesh)
            vr = collectives.ppermute_ring(vr, axis, mesh=mesh)
    return o.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh: DeviceMesh, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           axis: str = "sp"):
    """Shards seq over `axis`, batch over the data axes of the mesh
    (dp/fsdp), heads over tp where it is nontrivial, and runs the ring on
    each rank's shards; with a trivial `axis`, the flash op on each
    rank's (rows, heads) shard instead. q/k/v are DTensors, or plain
    tensors every rank holds whole; returns a DTensor.

    K/V heads: sharded over tp beside the q heads when tp divides them;
    a single K/V head (MQA) is read whole by every rank; otherwise every
    rank reads all K/V heads and picks those of its q heads, the JAX
    version's repeat made locally.
    """
    mesh = compute_mesh(mesh)
    if dict(zip(mesh.mesh_dim_names, mesh.shape)).get(axis, 1) == 1:
        return flash_attention_sharded(q, k, v, mesh, causal=causal,
                                       sm_scale=sm_scale)
    h, kvh = q.shape[1], k.shape[1]
    qp, kvp, kv_grad, tp_axis, pick = attention_specs(mesh, h, kvh, axis)
    q, k, v = (as_dtensor(q, mesh, qp), as_dtensor(k, mesh, kvp),
               as_dtensor(v, mesh, kvp))
    tp_index = mesh.get_local_rank(tp_axis) if tp_axis else 0

    def local(q_, k_, v_):
        if pick:
            k_ = pick_kv_heads(k_, q_.shape[1], h, tp_index)
            v_ = pick_kv_heads(v_, q_.shape[1], h, tp_index)
        return ring_attention(q_, k_, v_, axis=axis, causal=causal,
                              sm_scale=sm_scale, mesh=mesh)

    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)
