"""GPipe and 1F1B pipeline parallelism over the `pp` mesh axis.

Port of `ray_tpu/parallel/pipeline.py`. The JAX module runs each stage
as a manual region of one XLA program (`shard_map` over pp, other axes
automatic) and rotates activations with `lax.ppermute`. PyTorch runs one
process per rank, so here each rank runs ITS OWN stage's code over the
mesh's pp group and sends activations up and cotangents down with the
pp group's point-to-point exchange (`collectives._permute`). The other
mesh axes stay as they are: a stage's activations and parameters may be
DTensors (dp, fsdp, tp, sp), and the exchange moves each rank's local
shard to the rank of the same coordinates one stage over.

Schedules: GPipe fill-drain (`pipeline_apply`; M+S-1 ticks, bubble
(S-1)/(M+S-1)) and one-forward-one-backward (`pipeline_grads_1f1b`;
M+2(S-1) ticks, at most 2(S-1)+1 stashed stage inputs). Both keep only
each microbatch's stage INPUT and recompute the stage forward in the
backward (the JAX 1F1B's remat trade; `pipeline_apply`'s backward is an
explicit reverse GPipe schedule, so its collectives run in one fixed
order on every rank instead of wherever autograd reaches them).

Layer layouts: the JAX contract is a tree whose leaves stack the layers
on a leading axis, (L, ...); the port's Transformer keeps a LIST of
per-layer dicts (`models/convert.py`). Every function here takes either.
Since each rank runs its own program, uneven splits (`layer_fn`) need no
padding: a stage simply runs its own number of layers; the remainder
layers go to the last stage (`partition_layers`), as in the JAX module.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ray_tpu_torch.parallel.collectives import _permute
from ray_tpu_torch.parallel.mesh import axis_sizes


def partition_layers(n_layers: int, n_stages: int) -> list:
    """Canonical stage partition: ``[(start, count), ...]`` per stage,
    with the remainder layers assigned to the LAST stage (it already
    sits next to the loss, so in MPMD mode its extra work overlaps the
    other stages' cooldown bubble). Shared by the SPMD schedules here
    and by the MPMD stage assignment (train/pipeline.py), so the two
    parallelism modes can never disagree about which stage owns which
    layer."""
    if n_stages < 1:
        raise ValueError(f"need at least one stage, got {n_stages}")
    if n_layers < n_stages:
        raise ValueError(
            f"{n_layers} layers cannot fill {n_stages} pipeline stages")
    k, r = divmod(n_layers, n_stages)
    parts = [(s * k, k) for s in range(n_stages - 1)]
    parts.append(((n_stages - 1) * k, k + r))
    return parts


def _is_layer_list(layer_params: Any) -> bool:
    return isinstance(layer_params, list)


def n_layers_of(layer_params: Any) -> int:
    """Layer count of a list of layers or of a stacked tree."""
    if _is_layer_list(layer_params):
        return len(layer_params)
    leaves = tree_flatten(layer_params)[0]
    if not leaves:
        raise ValueError("layer_params has no leaves")
    return int(leaves[0].shape[0])


def slice_stage(layer_params: Any, start: int, count: int) -> Any:
    """One stage's sub-stack: a list of layers is sliced, a stacked
    tree's leaves (L, ...) become (count, ...). Per-stage trees may be
    RAGGED across stages (each stage is its own program)."""
    if _is_layer_list(layer_params):
        return layer_params[start:start + count]
    return tree_map(lambda p: p[start:start + count], layer_params)


def split_stages(layer_params: Any, n_stages: int) -> Any:
    """Even split: stacked leaves (L, ...) -> (S, L//S, ...); a list of
    layers -> a list of S lists."""
    L = n_layers_of(layer_params)
    if L % n_stages:
        raise ValueError(
            f"{L} layers not divisible into {n_stages} pipeline "
            f"stages; pass layer_fn= for an uneven split "
            f"(remainder layers go to the last stage, see "
            f"partition_layers) or use the MPMD pipeline "
            f"(train/pipeline.py), where ragged stages are free")
    k = L // n_stages
    if _is_layer_list(layer_params):
        return [layer_params[s * k:(s + 1) * k] for s in range(n_stages)]
    return tree_map(lambda p: p.reshape(n_stages, k, *p.shape[1:]),
                    layer_params)


def split_stages_padded(layer_params: Any, n_stages: int):
    """Uneven split in the JAX module's uniform-shape form: stacked
    leaves (L, ...) -> (S, kmax, ...) zero-padded per stage (a list of
    layers -> S lists of kmax, padded with zero layers), plus the
    per-stage valid counts. The port's schedules do not need it (each
    rank runs its own count); it is kept for callers that stack."""
    L = n_layers_of(layer_params)
    parts = partition_layers(L, n_stages)
    kmax = max(c for _, c in parts)
    counts = np.asarray([c for _, c in parts], dtype=np.int32)
    if _is_layer_list(layer_params):
        zero = tree_map(torch.zeros_like, layer_params[0])
        return ([layer_params[s:s + c] + [zero] * (kmax - c)
                 for s, c in parts], counts)

    def stack(p):
        rows = []
        for start, count in parts:
            block = p[start:start + count]
            if count < kmax:
                pad = torch.zeros((kmax - count,) + tuple(p.shape[1:]),
                                  dtype=p.dtype, device=p.device)
                block = torch.cat([block, pad], dim=0)
            rows.append(block)
        return torch.stack(rows)
    return tree_map(stack, layer_params), counts


def _stage_call(stage_fn, layer_fn) -> Callable:
    """``call(stage_params, x, consts)``: the caller's whole-sub-stack
    function, or `layer_fn` applied to each of the stage's own layers."""
    if layer_fn is None:
        if stage_fn is None:
            raise ValueError("pass stage_fn or layer_fn")
        return lambda p, x, consts: stage_fn(p, x, *consts)

    def call(p, x, consts):
        n = n_layers_of(p)
        for i in range(n):
            layer = (p[i] if _is_layer_list(p)
                     else tree_map(lambda a: a[i], p))
            x = layer_fn(layer, x, *consts)
        return x
    return call


# ------------------------------------------------------------ locality
def _local_view(x):
    """(local tensor, wrap, unwrap) for a DTensor or a plain tensor: the
    pipeline exchanges each rank's local shard; `wrap` gives a local
    tensor of the same layout back its DTensor placements."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x, (lambda t: t), (lambda t: t)
    mesh, placements = x.device_mesh, tuple(x.placements)

    def wrap(t):
        return DTensor.from_local(t, mesh, placements, run_check=False)

    def unwrap(t):
        if isinstance(t, DTensor):
            if tuple(t.placements) != placements:
                t = t.redistribute(mesh, placements)
            return t.to_local()
        return t
    return x.to_local(), wrap, unwrap


def _param_local(g, p):
    """A parameter's gradient as a local tensor laid out as `p` is (a
    DTensor gradient is first brought to the parameter's placements);
    zeros where this rank computed none."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        if g is None:
            return torch.zeros_like(p.to_local())
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        return g.to_local()
    return torch.zeros_like(p) if g is None else g


def _param_wrap(local, p):
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
    return local


def _sum_over_pp(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Allreduce a list of local tensors over the pp group in one flat
    buffer per dtype (grads of disjoint stages: the sum assembles them)."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


class _Plan:
    """What one rank needs to run its stage of a schedule."""

    def __init__(self, mesh, layer_params, call, consts, M: int):
        self.group = mesh.get_group("pp")
        self.S = axis_sizes(mesh)["pp"]
        self.stage = mesh.get_local_rank("pp")
        self.leaves, self.spec = tree_flatten(layer_params)
        L = n_layers_of(layer_params)
        self.start, self.count = partition_layers(L, self.S)[self.stage]
        self.stacked = not _is_layer_list(layer_params)
        # flat indices (into self.leaves) of this stage's leaves, in the
        # order tree_flatten gives the stage's sub-tree; a stacked tree
        # slices every leaf
        ids = tree_unflatten(list(range(len(self.leaves))), self.spec)
        self.own = (list(range(len(self.leaves))) if self.stacked
                    else tree_flatten(slice_stage(ids, self.start,
                                                  self.count))[0])
        self.call, self.consts, self.M = call, tuple(consts), M
        self.up = [(i, (i + 1) % self.S) for i in range(self.S)]
        self.down = [(i, (i - 1) % self.S) for i in range(self.S)]

    def stage_params(self, leaves):
        return slice_stage(tree_unflatten(list(leaves), self.spec),
                           self.start, self.count)

    def run(self, stage_params, x):
        return self.call(stage_params, x, self.consts)


class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one autograd node: the forward runs the fill-
    drain ticks with no graph and keeps each microbatch's stage input;
    the backward runs the reverse schedule, recomputing each stage
    forward from its input, then sums the input and parameter cotangents
    over pp (the transpose of feeding every stage the same replicated
    input and parameters)."""

    @staticmethod
    def forward(ctx, plan: _Plan, x, *leaves):
        S, M, stage = plan.S, plan.M, plan.stage
        xl, wrap, unwrap = _local_view(x)
        bs = xl.shape[0] // M
        micro = [xl[m * bs:(m + 1) * bs] for m in range(M)]
        p = plan.stage_params(leaves)
        saved: dict = {}
        outs: list = [None] * M
        state = torch.zeros_like(micro[0])
        for t in range(M + S - 1):
            m = t - stage
            if 0 <= m < M:
                x_in = micro[m] if stage == 0 else state
                saved[m] = x_in
                y = unwrap(plan.run(p, wrap(x_in)))
                if stage == S - 1:
                    outs[m] = y
            else:
                y = torch.zeros_like(micro[0])
            state = _permute(y, plan.group, plan.up)
        out = (torch.cat(outs) if stage == S - 1
               else torch.zeros_like(xl))
        # every pp rank gets the last stage's outputs
        dist.all_reduce(out, group=plan.group)
        ctx.plan, ctx.saved, ctx.x = plan, saved, x
        ctx.leaves = leaves
        return wrap(out)

    @staticmethod
    def backward(ctx, g):
        plan, saved, x, leaves = ctx.plan, ctx.saved, ctx.x, ctx.leaves
        S, M, stage = plan.S, plan.M, plan.stage
        xl, wrap, unwrap = _local_view(x)
        gl = unwrap(g)
        bs = xl.shape[0] // M
        stage_leaves, stage_spec = tree_flatten(plan.stage_params(leaves))
        grads: list = [None] * len(stage_leaves)
        dx_micro: list = [None] * M
        cot_state = torch.zeros_like(gl[:bs])
        for t in range(M + S - 1):
            m = t - (S - 1 - stage)      # the last stage goes first
            if 0 <= m < M:
                cot = gl[m * bs:(m + 1) * bs] if stage == S - 1 \
                    else cot_state
                with torch.enable_grad():
                    ps = [q.detach().requires_grad_(q.requires_grad)
                          for q in stage_leaves]
                    xin = saved[m].detach().requires_grad_()
                    y = plan.run(tree_unflatten(ps, stage_spec), wrap(xin))
                    want = [q for q in ps if q.requires_grad] + [xin]
                    got = torch.autograd.grad(
                        y, want, wrap(cot), allow_unused=True)
                dps, dx = iter(got[:-1]), got[-1]
                for i, q in enumerate(ps):
                    if q.requires_grad:
                        d = next(dps)
                        if d is not None:
                            grads[i] = d if grads[i] is None else grads[i] + d
                dx = torch.zeros_like(cot) if dx is None else dx
                if stage == 0:
                    dx_micro[m] = dx
            else:
                dx = torch.zeros_like(cot_state)
            cot_state = _permute(dx, plan.group, plan.down)
        dx_full = (torch.cat(dx_micro) if stage == 0
                   else torch.zeros_like(xl))
        # parameter grads: this stage's, then every stage's over pp
        local = _layer_major(plan, leaves, grads)
        summed = _sum_over_pp([dx_full] + local, plan.group)
        dx_out = wrap(summed[0]) if x.requires_grad else None
        dleaves = [(_param_wrap(t, leaf) if leaf.requires_grad else None)
                   for t, leaf in zip(summed[1:], leaves)]
        return (None, dx_out, *dleaves)


def _layer_major(plan: _Plan, leaves, stage_grads) -> List[torch.Tensor]:
    """Local gradient buffers laid out as `leaves` (every layer), with
    this stage's grads in place and zeros for the other stages'."""
    own = dict(zip(plan.own, stage_grads))
    out = []
    for i, leaf in enumerate(leaves):
        g = own.get(i)
        if plan.stacked:
            buf = torch.zeros_like(leaf)
            if g is not None:
                buf[plan.start:plan.start + plan.count] = g
            out.append(buf)
        else:
            out.append(_param_local(g, leaf))
    return out


def _check(mesh, x, M: int, what: str) -> int:
    S = axis_sizes(mesh).get("pp", 1)
    if S <= 1:
        raise ValueError(f"{what} needs a pp axis > 1")
    b = x.shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible into {M} microbatches")
    local = _local_view(x)[0].shape[0]
    if local % M:
        raise ValueError(f"this rank's {local} rows not divisible into "
                         f"{M} microbatches")
    return S


def pipeline_apply(mesh, stage_fn: Optional[Callable], layer_params: Any,
                   x: torch.Tensor, num_microbatches: int,
                   consts: tuple = (),
                   layer_fn: Optional[Callable] = None) -> torch.Tensor:
    """Run `stage_fn(stage_params, x_microbatch, *consts)` (one stage's
    layers applied to one microbatch) over the pp axis of `mesh` with a
    GPipe schedule; differentiable in `x` and in the parameters.

    Every rank of the mesh calls this with the same arguments and the
    whole `layer_params` (a list of layers or a stacked tree); each runs
    its own stage's layers. `x`: (batch, ...) activations, a tensor or a
    DTensor; a rank splits its local rows into the microbatches.
    `consts` (e.g. rope caches) are passed to every call whole. Returns
    x's shape, the same on every pp rank.

    Uneven layer counts: pass ``layer_fn(one_layer_params, x, *consts)
    -> x`` INSTEAD of stage_fn; the last stage takes the remainder
    layers (`partition_layers`)."""
    M = int(num_microbatches)
    _check(mesh, x, M, "pipeline_apply")
    plan = _Plan(mesh, layer_params, _stage_call(stage_fn, layer_fn),
                 consts, M)
    return _GPipe.apply(plan, x, *plan.leaves)


def pipeline_grads_1f1b(mesh, stage_fn: Optional[Callable],
                        loss_fn: Callable, layer_params: Any,
                        x: torch.Tensor, targets: torch.Tensor,
                        num_microbatches: int, consts: tuple = (),
                        layer_fn: Optional[Callable] = None):
    """One-forward-one-backward schedule (PipeDream-Flush / Megatron-LM;
    the reference's dag_node_operation.py builds this ordering).

    Per tick t (T = M + 2(S-1) ticks) stage s runs the forward of
    microbatch t-s and the backward of microbatch t-2(S-1)+s when those
    are in range; the last stage computes a microbatch's loss and its
    backward in the tick its forward arrives. Activations go up the pp
    ring, cotangents down. A stage keeps only its stage inputs and
    recomputes its forward in the backward.

    Returns (mean loss over the microbatches, grads in `layer_params`'
    layout), both the same on every pp rank. loss_fn(y_microbatch,
    target_microbatch) -> scalar summed loss for that microbatch. Plain
    tensors (each rank's whole microbatch); `layer_fn` as in
    pipeline_apply."""
    M = int(num_microbatches)
    S = _check(mesh, x, M, "pipeline_grads_1f1b")
    plan = _Plan(mesh, layer_params, _stage_call(stage_fn, layer_fn),
                 consts, M)
    stage, last = plan.stage, S - 1
    bs = x.shape[0] // M
    micro = [x[m * bs:(m + 1) * bs] for m in range(M)]
    tmicro = [targets[m * bs:(m + 1) * bs] for m in range(M)]
    p = plan.stage_params([q.detach() for q in plan.leaves])
    p_leaves, p_spec = tree_flatten(p)
    grads = [torch.zeros_like(q) for q in p_leaves]
    saved: dict = {}
    loss_acc = torch.zeros((), dtype=x.dtype, device=x.device)
    zero = torch.zeros_like(micro[0])
    fwd_carry, bwd_carry = zero, zero
    for t in range(M + 2 * (S - 1)):
        # ---------- forward half-tick
        m_f = t - stage
        y = zero
        if 0 <= m_f < M:
            x_in = micro[m_f] if stage == 0 else fwd_carry
            saved[m_f] = x_in
            if stage != last:            # the last stage's forward is
                with torch.no_grad():    # fused into its backward
                    y = plan.run(p, x_in)
        # ---------- backward half-tick
        m_b = t - 2 * (S - 1) + stage
        dx = zero
        if 0 <= m_b < M:
            with torch.enable_grad():
                ps = [q.detach().requires_grad_() for q in p_leaves]
                xin = saved.pop(m_b).detach().requires_grad_()
                out = plan.run(tree_unflatten(ps, p_spec), xin)
                if stage == last:
                    loss_m = loss_fn(out, tmicro[m_b])
                    got = torch.autograd.grad(loss_m, ps + [xin],
                                              allow_unused=True)
                    loss_acc = loss_acc + loss_m.detach()
                else:
                    got = torch.autograd.grad(out, ps + [xin], bwd_carry,
                                              allow_unused=True)
            for i, d in enumerate(got[:-1]):
                if d is not None:
                    grads[i] = grads[i] + d
            if got[-1] is not None:
                dx = got[-1]
        # ---------- communication
        fwd_carry = _permute(y, plan.group, plan.up)
        bwd_carry = _permute(dx, plan.group, plan.down)
    loss = loss_acc if stage == last else torch.zeros_like(loss_acc)
    # assemble the layer-major grads of every stage on every rank
    full = _layer_major(plan, plan.leaves, [g / M for g in grads])
    summed = _sum_over_pp([loss.reshape(1)] + full, plan.group)
    return (summed[0].reshape(()) / M,
            tree_unflatten(summed[1:], plan.spec))
