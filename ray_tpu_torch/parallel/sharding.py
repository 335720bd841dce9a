"""Logical-axis sharding rules, as DTensor placements.

Port of `ray_tpu/parallel/sharding.py`. The JAX package annotates arrays
with *logical* axis names, maps them to mesh axes through a rule table,
and lets XLA insert the collectives. Here the same table (a copy of the
JAX one) maps logical axes to mesh dimensions of a `DeviceMesh`, and a
spec becomes DTensor placements: each mesh dimension a tensor dimension
is split over is `Shard(tensor_dim)`, every other one `Replicate()`.
A parameter leaf becomes one DTensor (`shard_pytree`), and
`with_logical_constraint` is a `redistribute`, which runs the collectives
XLA would have inserted there (and their transposes in the backward).

A tensor dimension split over two mesh axes (`"batch": ("dp", "fsdp")`)
is `Shard(d)` on both; DTensor splits it over the mesh dimensions in
mesh order, dp outer and fsdp inner, which is the order of the JAX
PartitionSpec `P(("dp", "fsdp"))`. A rule that names its axes out of
mesh order would place rows differently, so it raises. DTensors live on
the mesh's compute mesh, its nontrivial axes (`mesh.compute_mesh`).

Logical axes used by the model zoo:
  batch, seq, embed, mlp, heads, kv_heads, head_dim, vocab, experts, layers
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ray_tpu_torch.parallel.mesh import AXIS_ORDER, axis_sizes, compute_mesh

Axes = Union[str, Tuple[str, ...], None]

# rule: logical axis -> mesh axis (or tuple of mesh axes, or None=replicate).
# fsdp shards along embed (ZeRO-3 analogue: params gathered per-layer on use);
# tp shards mlp/heads/vocab (megatron); sp shards seq; ep shards experts;
# batch shards over (dp, fsdp) — fsdp contributes to the data axis for
# activations, matching the "fsdp is dp for activations" recipe.
LOGICAL_AXIS_RULES: dict[str, Axes] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "vocab": "tp",
    "experts": "ep",
    "layers": None,
    "stages": "pp",
}


def _mesh_axes_for(logical: Axes, rules: dict[str, Axes],
                   mesh: Optional[DeviceMesh]) -> Axes:
    if logical is None:
        return None
    if isinstance(logical, str):
        if logical not in rules:
            raise ValueError(
                f"unknown logical axis {logical!r}; known: {sorted(rules)}. "
                "Pass an extended rules dict to add custom axes.")
        mapped = rules[logical]
    else:
        mapped = logical
    if mapped is None:
        return None
    if mesh is not None:
        # Drop trivial mesh axes so specs stay minimal (pure cosmetics: a
        # size-1 axis means replicated anyway).
        sizes = axis_sizes(mesh)
        axes = mapped if isinstance(mapped, tuple) else (mapped,)
        axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    return mapped


def logical_spec(logical_axes: Sequence[Axes],
                 rules: Optional[dict[str, Axes]] = None,
                 mesh: Optional[DeviceMesh] = None) -> Tuple[Axes, ...]:
    """Map a tuple of logical axis names to a spec: per tensor dimension,
    the mesh axis (or tuple of axes, or None) it is split over; the
    counterpart of a JAX PartitionSpec."""
    rules = rules if rules is not None else LOGICAL_AXIS_RULES
    return tuple(_mesh_axes_for(ax, rules, mesh) for ax in logical_axes)


def spec_placements(mesh: DeviceMesh, spec: Sequence[Axes]
                    ) -> Tuple[Placement, ...]:
    """DTensor placements of a spec on `mesh` (a compute mesh: see
    `mesh.compute_mesh`), one per mesh dimension; trivial axes the spec
    names are dropped."""
    sizes = axis_sizes(mesh)
    by_axis = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes
                     if a not in AXIS_ORDER or sizes.get(a, 1) > 1)
        order = [AXIS_ORDER.index(a) if a in AXIS_ORDER else -1
                 for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"mesh axes {axes} of tensor dim {dim} are not in mesh "
                f"order {AXIS_ORDER}; DTensor would split the dim in mesh "
                f"order and place rows differently from the spec")
        for a in axes:
            if a in by_axis:
                raise ValueError(f"mesh axis {a!r} shards two tensor dims "
                                 f"in {spec}")
            by_axis[a] = dim
    unknown = set(by_axis) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names mesh axes {sorted(unknown)} "
                         f"that the mesh {mesh.mesh_dim_names} lacks")
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh: the counterpart of
    `jax.sharding.NamedSharding`, with the DTensor placements it means on
    the mesh's compute mesh (`dtensor_mesh`)."""
    mesh: DeviceMesh
    spec: Tuple[Axes, ...]

    @property
    def dtensor_mesh(self) -> DeviceMesh:
        return compute_mesh(self.mesh)

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return spec_placements(self.dtensor_mesh, self.spec)


def logical_sharding(mesh: DeviceMesh, logical_axes: Sequence[Axes],
                     rules: Optional[dict[str, Axes]] = None
                     ) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(logical_axes, rules, mesh))


def logical_placements(mesh: DeviceMesh, logical_axes: Sequence[Axes],
                       rules: Optional[dict[str, Axes]] = None
                       ) -> Tuple[Placement, ...]:
    return logical_sharding(mesh, logical_axes, rules).placements


def with_logical_constraint(x: Any, logical_axes: Sequence[Axes],
                            mesh: Optional[DeviceMesh] = None,
                            rules: Optional[dict[str, Axes]] = None) -> Any:
    """`lax.with_sharding_constraint` in logical-axis vocabulary: a no-op
    without a mesh; a DTensor is redistributed to the spec's placements
    (differentiable: the backward redistributes the gradient back), and a
    plain tensor, which every rank holds whole, becomes a DTensor of its
    local shard without communication."""
    if mesh is None:
        return x
    placements = logical_placements(mesh, logical_axes, rules)
    mesh = compute_mesh(mesh)
    if isinstance(x, DTensor):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def tree_map(fn, tree, *rest, is_leaf=None):
    """Map over nested dicts and lists (the port's parameter trees)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def param_shardings(mesh: DeviceMesh, logical_tree: Any,
                    rules: Optional[dict[str, Axes]] = None) -> Any:
    """Tree of logical-axis tuples -> tree of NamedShardings.

    `logical_tree` mirrors the param tree, with each leaf a tuple of
    logical axis names (e.g. ("embed", "mlp")). The port's Transformer
    gives it from `param_logical_axes()`.
    """
    return tree_map(lambda axes: logical_sharding(mesh, axes, rules),
                    logical_tree, is_leaf=_is_axes_leaf)


def shard_pytree(tree: Any, shardings: Any) -> Any:
    """Place a tree of tensors (or arrays) as DTensors per a matching
    tree of shardings. Every rank passes the whole tree; rank 0's values
    are the ones kept (`distribute_tensor` scatters them), as a JAX
    `device_put` takes the host's."""
    def place(x, s: NamedSharding):
        dev = ("cpu" if s.mesh.device_type == "cpu"
               else torch.device("cuda", torch.cuda.current_device()))
        t = torch.as_tensor(x).detach().to(dev)
        return distribute_tensor(t, s.dtensor_mesh, s.placements)
    return tree_map(place, tree, shardings)


def sync_grads(tree: Any) -> None:
    """Bring the gradient of every DTensor leaf to its parameter's
    placements, in place, after a backward. A parameter read whole by
    ranks that each saw other rows gets a partial gradient (a sum still to
    make), a split one may get a partial or another split; the
    redistribute makes the sums (allreduce, or reduce-scatter onto a
    shard) that XLA inserts for a JAX gradient of the same sharding."""
    def fix(p):
        g = getattr(p, "grad", None)
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(
                p.placements):
            p.grad = g.redistribute(p.device_mesh, p.placements)
    tree_map(fix, tree)


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Sharding for host-fed data batches: leading axis over (dp, fsdp)."""
    return logical_sharding(mesh, ("batch",))
