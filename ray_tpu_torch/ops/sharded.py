"""The kernels under a DeviceMesh: each runs on every rank's local shards
inside `local_map`.

The CUDA kernels take plain tensors, and a wrapper never falls back to
its plain version for a DTensor, so a model whose activations are
DTensors calls these. `flash_attention_sharded` splits q/k/v by rows
over the data axes and by heads over tp (the specs
`ring_attention_sharded` uses, with the sequence whole), and
`rms_norm_sharded` hands each rank whole embed rows. Each local call is
the direct call on the shard, so a one-rank mesh gives the direct call's
bits, forward and backward.

Gradients: a shard's rows and heads are independent, so a rank's local
gradient is its shard's; a weight or K/V head that every rank reads
whole while the rows are split gets a partial gradient from each rank
(`Partial`), which DTensor sums.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.parallel.mesh import compute_mesh
from ray_tpu_torch.parallel.sharding import logical_placements


def _sizes(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _placements(mesh: DeviceMesh, dims: dict) -> Tuple[Placement, ...]:
    """{mesh axis: tensor dim} -> placements (every other axis replicated)."""
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.mesh_dim_names)


def attention_specs(mesh: DeviceMesh, h: int, kvh: int,
                    seq_axis: Optional[str] = None):
    """(q placements, k/v placements, k/v grad placements, tp axis or
    None, whether each rank picks its own K/V heads) for (b, heads, s, d)
    attention inputs: batch over the nontrivial data axes dp/fsdp, heads
    over tp, the sequence over `seq_axis` (ring attention) or whole.

    K/V heads shard over tp beside the q heads when tp divides them; a
    single K/V head is read whole by every rank; otherwise every rank
    reads all K/V heads and picks those its q heads map to, and its K/V
    gradient is partial over tp."""
    sizes = _sizes(mesh)
    dims = {a: 0 for a in ("dp", "fsdp")
            if a != seq_axis and sizes.get(a, 1) > 1}
    if seq_axis is not None:
        dims[seq_axis] = 2
    tp = sizes.get("tp", 1) if seq_axis != "tp" else 1
    if tp > 1 and h % tp:
        raise ValueError(f"{h} heads do not split over tp={tp}")
    q = _placements(mesh, {**dims, **({"tp": 1} if tp > 1 else {})})
    if tp == 1 or kvh % tp == 0:
        return q, q, q, ("tp" if tp > 1 else None), False
    kv = _placements(mesh, dims)
    kv_grad = tuple(Partial() if a == "tp" else p
                    for a, p in zip(mesh.mesh_dim_names, kv))
    return q, kv, kv_grad, "tp", kvh != 1


def pick_kv_heads(k: torch.Tensor, h_local: int, h: int, tp_index: int
                  ) -> torch.Tensor:
    """The K/V heads of this rank's q heads [tp_index * h_local, ...), one
    per q head (the JAX `ring_attention_sharded` repeat, made locally)."""
    group = h // k.shape[1]
    heads = (torch.arange(h_local, device=k.device)
             + tp_index * h_local) // group
    return k.index_select(1, heads)


def as_dtensor(x: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement]) -> DTensor:
    """A DTensor as given, or a plain tensor every rank holds whole
    split into its local shard (no communication)."""
    if isinstance(x, DTensor):
        return x
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def flash_attention_sharded(q, k, v, mesh: Optional[DeviceMesh] = None,
                            causal: bool = True,
                            sm_scale: Optional[float] = None) -> DTensor:
    """`flash_attention` on each rank's (rows, heads) shard of q/k/v; the
    sequence is gathered whole first where it was split. q/k/v are
    DTensors (or plain tensors every rank holds whole, with `mesh`)."""
    mesh = compute_mesh(mesh if mesh is not None else q.device_mesh)
    h, kvh = q.shape[1], k.shape[1]
    qp, kvp, kv_grad, tp_axis, pick = attention_specs(mesh, h, kvh)
    q, k, v = (as_dtensor(q, mesh, qp), as_dtensor(k, mesh, kvp),
               as_dtensor(v, mesh, kvp))
    tp_index = mesh.get_local_rank(tp_axis) if tp_axis else 0

    def local(q_, k_, v_):
        if pick:
            k_ = pick_kv_heads(k_, q_.shape[1], h, tp_index)
            v_ = pick_kv_heads(v_, q_.shape[1], h, tp_index)
        return flash_attention(q_, k_, v_, causal=causal, sm_scale=sm_scale)

    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def sharded_linear(x: DTensor, w: DTensor) -> DTensor:
    """`x @ w` for x (..., k) and a weight w (k, n), each rank multiplying
    its shards inside `local_map`: the layouts are decided here, per mesh
    axis, as Megatron and FSDP decide them, instead of by DTensor's
    sharding propagation (whose search over a 3-axis mesh took minutes for
    one matmul). Per axis: a weight split by rows where x's last dim is
    split the same way (tp after a column split) gives a partial sum; a
    weight split by columns (tp) where x is whole gives output columns
    split the same way; any other split weight (fsdp along embed) is
    gathered first. x keeps its row splits; a partial x is summed first."""
    mesh = x.device_mesh
    last = x.ndim - 1
    xp, wp, out, x_grad, w_grad = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px.is_partial():
            px = Replicate()
        x_split_k = px.is_shard() and px.dim == last
        x_split_rows = px.is_shard() and not x_split_k
        if pw.is_shard() and pw.dim == 0 and x_split_k:   # contraction
            xp.append(px), wp.append(pw), out.append(Partial())
            x_grad.append(px), w_grad.append(pw)
        elif pw.is_shard() and pw.dim == 1 and not x_split_rows:
            # columns split (tp), x whole on this axis
            xp.append(Replicate()), wp.append(pw), out.append(Shard(last))
            x_grad.append(Partial()), w_grad.append(pw)
        else:                                     # w whole on this axis
            if x_split_k:
                px = Replicate()
            xp.append(px), wp.append(Replicate()), out.append(px)
            x_grad.append(px)
            w_grad.append(Partial() if px.is_shard() else Replicate())
    return local_map(torch.matmul, out_placements=out,
                     in_placements=(tuple(xp), tuple(wp)),
                     in_grad_placements=(tuple(x_grad), tuple(w_grad)),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def rms_norm_sharded(x: DTensor, w: DTensor, eps: float = 1e-6) -> DTensor:
    """`rms_norm` on each rank's whole rows of x: a split of the last
    (normalised) dim or a partial sum is gathered first, and the weight is
    read whole by every rank."""
    mesh = x.device_mesh
    last = x.ndim - 1
    xp = tuple(Replicate() if p.is_partial() or (p.is_shard() and
                                                 p.dim == last) else p
               for p in x.placements)
    wp = (Replicate(),) * mesh.ndim
    w_grad = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    fn = local_map(lambda x_, w_: rms_norm(x_, w_, eps),
                   out_placements=list(xp),
                   in_placements=(xp, wp), in_grad_placements=(xp, w_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, w)


def vocab_sharded_lookup(table: DTensor, tokens: DTensor, mesh: DeviceMesh,
                         rules: dict) -> DTensor:
    """Rows of `table` (vocab, embed) for `tokens` (b, s): the table split
    over tp by vocab (gathered whole along embed), each rank looks up the
    tokens in its vocab shard and gives zeros elsewhere, so the result is
    a partial sum over tp that holds one nonzero term per row: exact,
    like the one-hot contraction the JAX model uses on a split table."""
    mesh = compute_mesh(mesh)
    names = mesh.mesh_dim_names
    sizes = _sizes(mesh)
    tp = sizes.get("tp", 1)
    vocab = table.shape[0]
    if vocab % tp:
        raise ValueError(f"vocab {vocab} does not split over tp={tp}")
    shard = vocab // tp
    rows = logical_placements(mesh, ("batch", "seq"), rules)
    tbl = logical_placements(mesh, ("vocab", None), rules)
    out = tuple(Partial() if a == "tp" and tp > 1 else p
                for a, p in zip(names, rows))
    tbl_grad = tuple(q if q.is_shard() else
                     (Partial() if p.is_shard() else Replicate())
                     for p, q in zip(rows, tbl))
    lo = mesh.get_local_rank("tp") * shard if tp > 1 else 0

    def local(tbl_, tok):
        if tp == 1:
            return tbl_[tok]
        idx = tok - lo
        inside = (idx >= 0) & (idx < shard)
        got = tbl_[idx.clamp(0, shard - 1)]
        return torch.where(inside[..., None], got, torch.zeros_like(got))

    return local_map(local, out_placements=list(out),
                     in_placements=(tbl, rows),
                     in_grad_placements=(tbl_grad, rows),
                     device_mesh=mesh, redistribute_inputs=True)(
                         table, tokens)
