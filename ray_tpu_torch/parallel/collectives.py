"""Collectives over one named mesh axis, on each rank's local tensor.

Port of `ray_tpu/parallel/collectives.py`. The JAX verbs are XLA
collectives emitted inside `shard_map`, where the mesh is ambient; here
each is a `torch.distributed` call over the group of one mesh dimension
(`mesh.get_group(axis)`), made by every rank of the mesh on its local
tensor (inside `local_map`, or on `DTensor.to_local()` values), so the
mesh is passed by keyword.

Gradients follow the convention of `local_map`: every rank's cotangent is
its share of one objective, and a value the collective leaves the same on
every rank (an allreduce's, an allgather's) carries the whole cotangent on
each rank. So the backward of `allreduce` passes the cotangent to each
contribution (the transpose of `psum` onto an invariant value), that of
`allgather` takes the rank's own slice, that of `reducescatter` gathers,
and that of `all_to_all` and of a permutation is the inverse exchange.
`max`/`min` reductions are not differentiable, as `lax.pmax` is not.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def axis_index(axis: str, *, mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(axis)


def axis_size(axis: str, *, mesh: DeviceMesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _global(group, i: int) -> int:
    return dist.get_global_rank(group, i)


# ---------------------------------------------------------------- reduce
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op: str):
        out = x.clone().contiguous()
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=group)
        n = dist.get_world_size(group)
        ctx.scale = 1.0 / n if op == "mean" else 1.0
        if op == "mean":
            out = out / n
        elif op in ("max", "min"):
            ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def allreduce(x: torch.Tensor, axis: str, op: str = "sum", *,
              mesh: DeviceMesh) -> torch.Tensor:
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op!r}")
    return _AllReduce.apply(x, _group(mesh, axis), op)


# ---------------------------------------------------------------- gather
def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} shards")
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim)[dist.get_rank(group)]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def allgather(x: torch.Tensor, axis: str, *, tiled: bool = True,
              gather_dim: int = 0, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's shard, concatenated along `gather_dim` in rank order
    (`tiled`), or stacked on a new `gather_dim`."""
    if not tiled:
        x = x.unsqueeze(gather_dim)
    return _AllGather.apply(x, _group(mesh, axis), gather_dim)


def reducescatter(x: torch.Tensor, axis: str, *, scatter_dim: int = 0,
                  tiled: bool = True, mesh: DeviceMesh) -> torch.Tensor:
    """The sum over ranks, of which rank i keeps block i along
    `scatter_dim` (`tiled`), or row i with the dim removed."""
    out = _ReduceScatter.apply(x, _group(mesh, axis), scatter_dim)
    return out if tiled else out.squeeze(scatter_dim)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def scatter_to(x: torch.Tensor, axis: str, *, dim: int = 0,
               mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block along `dim` of a value every rank of the axis
    holds whole (no communication); the transpose of `allgather`, so its
    backward gathers the blocks' cotangents into the whole one on every
    rank."""
    return _ScatterTo.apply(x, _group(mesh, axis), dim)


def copy_to(x: torch.Tensor, axis: str, *, mesh: DeviceMesh
            ) -> torch.Tensor:
    """`x` as it is, entering a computation that each rank of the axis
    does on its own part (its slice of an mlp dim); the transpose of
    `allreduce`, so its backward sums the ranks' partial cotangents."""
    return _CopyTo.apply(x, _group(mesh, axis))


# ------------------------------------------------------------- broadcast
class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, root: int):
        ctx.group, ctx.root = group, root
        out = x.clone().contiguous()
        dist.broadcast(out, src=_global(group, root), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # one value held by every rank: its cotangent goes to the root's
        return (g if dist.get_rank(ctx.group) == ctx.root
                else torch.zeros_like(g)), None, None


def broadcast(x: torch.Tensor, axis: str, root: int = 0, *,
              mesh: DeviceMesh) -> torch.Tensor:
    """Everyone receives root's shard. Non-root buffers are never read,
    so a NaN there does not reach the result."""
    return _Broadcast.apply(x, _group(mesh, axis), root)


# ------------------------------------------------------------ all_to_all
def _exchange(x: torch.Tensor, group, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split into {n} chunks")
    chunks = x.chunk(n, split_dim)
    send = torch.stack([c.contiguous() for c in chunks])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int):
        ctx.args = (group, concat_dim, split_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
               *, tiled: bool = True, mesh: DeviceMesh) -> torch.Tensor:
    """Ulysses-style re-sharding: chunk j of `split_dim` goes to rank j,
    and the chunks received are concatenated along `concat_dim` in rank
    order (`tiled`); untiled, `split_dim` has one row per rank, and the
    rows received, in rank order, take its place moved to `concat_dim`."""
    group = _group(mesh, axis)
    if tiled:
        return _AllToAll.apply(x, group, split_dim, concat_dim)
    rows = _AllToAll.apply(x, group, split_dim, split_dim)
    return rows.movedim(split_dim, concat_dim)


# ----------------------------------------------------------- permutation
def _permute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """Each (src, dst) pair of axis indices sends src's `x` to dst; a
    rank no pair sends to receives zeros (`lax.ppermute`)."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, _global(group, dst),
                                  group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _global(group, src),
                                  group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group = group
        ctx.inverse = [(dst, src) for src, dst in perm]
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, ctx.inverse), None, None


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]],
             *, mesh: DeviceMesh) -> torch.Tensor:
    """`lax.ppermute` over one mesh axis; its backward sends each
    cotangent back along the reverse pairs."""
    return _Permute.apply(x, _group(mesh, axis), list(perm))


def ppermute_ring(x: torch.Tensor, axis: str, *, shift: int = 1,
                  mesh: DeviceMesh) -> torch.Tensor:
    """Rotate shards around the ring (K/V rotation for ring attention)."""
    n = axis_size(axis, mesh=mesh)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)],
                    mesh=mesh)


def send_recv(x: torch.Tensor, axis: str, pairs, *,
              mesh: DeviceMesh) -> torch.Tensor:
    """Explicit point-to-point: `pairs` is a list of (src, dst) indices
    along `axis`. Only named destinations receive; every other rank keeps
    its own buffer."""
    shifted = ppermute(x, axis, pairs, mesh=mesh)
    me = axis_index(axis, mesh=mesh)
    return shifted if any(dst == me for _, dst in pairs) else x


def barrier(axis: str, x=None, *, mesh: DeviceMesh):
    """Collective fence: every rank of the axis waits for the others. With
    `x` (a tensor, or a dict, list or tuple of them), returns it with a
    zero-valued allreduce token added to every leaf, so the fence is part
    of the value's data dependency; bare, returns the token."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    token = allreduce(torch.zeros((), dtype=torch.int32, device=dev), axis,
                      mesh=mesh)
    if x is None:
        return token

    def add(v):
        if isinstance(v, dict):
            return {k: add(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(add(u) for u in v)
        return v + token.to(v.dtype)
    return add(x)
