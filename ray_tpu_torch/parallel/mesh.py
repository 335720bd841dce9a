"""Named device meshes over the process group: a `DeviceMesh` per MeshSpec.

Port of `ray_tpu/parallel/mesh.py`. The JAX package is one controller
that lays its devices out in a `jax.sharding.Mesh`; PyTorch runs one
process per rank, so the mesh here is a `torch.distributed` `DeviceMesh`
over the ranks of the default process group, with one mesh dimension per
axis of AXIS_ORDER (size-1 axes included, so sharding rules can name any
axis). Where the JAX package counts TPU slices (DCN-connected groups),
this counts hosts: the outer axes (pp/dp/fsdp) may span hosts, the inner
model axes (sp/ep/tp) stay within one. A host is the runtime node a rank
runs on where the runtime placed it (a trainer's k ranks a bundle share
their bundle's node), else the machine.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import socket
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Canonical axis order: outermost (slowest-varying, cross-host) first.
# pp/dp/fsdp cross hosts fine; tp/sp/ep want locality so they're innermost.
AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape over the canonical parallelism axes.

    Any axis set to -1 absorbs the remaining rank count (at most one).
    Axes of size 1 are still materialised in the mesh so sharding rules can
    reference them unconditionally (a size-1 axis shards to replication).
    """

    dp: int = -1     # data parallel (gradient sum)
    fsdp: int = 1    # fully-sharded params/optimizer (ZeRO-3 analogue)
    tp: int = 1      # tensor parallel (megatron-style matmul sharding)
    sp: int = 1      # sequence/context parallel (ring attention axis)
    ep: int = 1      # expert parallel (MoE all_to_all axis)
    pp: int = 1      # pipeline parallel (not ported: ROADMAP item 9)

    def resolve(self, n_devices: int) -> Tuple[int, ...]:
        """Concrete per-axis sizes in AXIS_ORDER, -1 axis inferred."""
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes.values())} devices, "
                f"have {n_devices}")
        return tuple(sizes[a] for a in AXIS_ORDER)

    def build(self, device=None) -> DeviceMesh:
        return prepare_mesh(self, device)


def _rank_hosts(world: int) -> List[str]:
    """The host of every rank of the default group, by rank: the
    runtime node that runs it (`RAY_TPU_NODE_ID`, set in every runtime
    worker), else its machine's name."""
    hosts: List[Optional[str]] = [None] * world
    dist.all_gather_object(
        hosts, os.environ.get("RAY_TPU_NODE_ID") or socket.gethostname())
    return hosts


def _join_one_rank_group(dev: torch.device) -> None:
    """A process with no group joins a group of its own: nccl on the
    card, gloo on the CPU. A failed nccl join raises; nothing retries on
    gloo."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def _check_backend(dev: torch.device) -> None:
    backend = str(dist.get_backend()).lower()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a mesh on {dev} needs a {want} process group; "
                         f"the default group's backend is {backend}")


def prepare_mesh(spec: MeshSpec | None = None, device=None,
                 **axes: int) -> DeviceMesh:
    """Build a named DeviceMesh from a MeshSpec (or axis kwargs) over
    every rank of the default process group.

    `device` is resolved as every entry point resolves it: None is the
    card, "cpu" only when asked for. With no process group, this process
    joins a one-rank group first. Ranks are laid out host-major: with
    more than one host the outer axes are split over hosts
    (`_split_hybrid`), the inner ones within each.
    """
    if spec is None:
        spec = MeshSpec(**axes) if axes else MeshSpec()
    elif axes:
        raise ValueError("pass either a MeshSpec or axis kwargs, not both")
    from ray_tpu_torch.ops.dispatch import resolve_device  # ops imports us
    dev = resolve_device(device)
    if not dist.is_initialized():
        _join_one_rank_group(dev)
    _check_backend(dev)
    world = dist.get_world_size()
    shape = spec.resolve(world)
    hosts = _rank_hosts(world) if world > 1 else ["local"]
    names = list(dict.fromkeys(hosts))          # in order of first rank
    by_host = [[r for r in range(world) if hosts[r] == h] for h in names]
    n_hosts = len(names)
    if n_hosts > 1 and len({len(r) for r in by_host}) == 1:
        per_host = world // n_hosts
        dcn_shape, ici_shape = _split_hybrid(shape, n_hosts, per_host)
        ranks = _hybrid_rank_array(by_host, ici_shape, dcn_shape)
    else:
        ranks = np.arange(world).reshape(shape)
    return DeviceMesh(dev.type, torch.as_tensor(ranks),
                      mesh_dim_names=AXIS_ORDER)


def _hybrid_rank_array(by_host: List[List[int]], ici_shape, dcn_shape
                       ) -> np.ndarray:
    """Ranks laid out as `mesh_utils.create_hybrid_device_mesh` lays out
    devices: host h's ranks form an `ici_shape` block at position h of
    the `dcn_shape` grid, so along each axis the host index is the outer
    factor."""
    n = len(ici_shape)
    grid = np.asarray(by_host).reshape(tuple(dcn_shape) + tuple(ici_shape))
    # (dcn_0..dcn_n, ici_0..ici_n) -> (dcn_0, ici_0, dcn_1, ici_1, ...)
    order = [i for pair in zip(range(n), range(n, 2 * n)) for i in pair]
    full = tuple(d * i for d, i in zip(dcn_shape, ici_shape))
    return grid.transpose(order).reshape(full)


# Axes allowed to span hosts. tp/sp/ep are host-local: their collectives
# are latency/bandwidth-critical per-layer, and landing them across hosts
# silently would be a performance cliff, so we refuse.
_DCN_AXES = frozenset({"pp", "dp", "fsdp"})


def _split_hybrid(shape: Tuple[int, ...], n_hosts: int,
                  per_host: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Factor each axis into (cross-host, in-host) parts, consuming hosts
    outermost-first.

    Only pp/dp/fsdp may absorb the host factor — the inner model axes
    (sp/ep/tp) always stay within a host."""
    dcn, ici = [], []
    remaining = n_hosts
    for axis, size in zip(AXIS_ORDER, shape):
        allowed = axis in _DCN_AXES
        if allowed and remaining > 1 and size % remaining == 0:
            dcn.append(remaining)
            ici.append(size // remaining)
            remaining = 1
        elif allowed and remaining > 1 and remaining % size == 0 and size > 1:
            dcn.append(size)
            ici.append(1)
            remaining //= size
        else:
            dcn.append(1)
            ici.append(size)
    if remaining != 1:
        raise ValueError(
            f"cannot place {n_hosts} hosts onto mesh shape {shape}; "
            "make an outer axis (pp/dp/fsdp) a multiple of the host count")
    if math.prod(ici) != per_host:
        raise ValueError(
            f"inner (in-host) mesh {ici} needs {math.prod(ici)} ranks per "
            f"host but each host has {per_host}")
    return tuple(dcn), tuple(ici)


def local_mesh(device=None, **axes: int) -> DeviceMesh:
    """Mesh over this process's own device only (single-process debug):
    the process joins a one-rank group if it has none; in a larger group
    it raises, since every mesh spans the default group's ranks."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError("local_mesh is a one-rank mesh; this process is "
                         f"one of {dist.get_world_size()} ranks "
                         "(use prepare_mesh)")
    return prepare_mesh(MeshSpec(**axes) if axes else None, device)


def mesh_shape_for(n_devices: int, model_axes: int = 1) -> MeshSpec:
    """Heuristic default: put `model_axes` devices on tp, rest on dp."""
    if n_devices % model_axes:
        raise ValueError(f"{n_devices} % {model_axes} != 0")
    return MeshSpec(dp=n_devices // model_axes, tp=model_axes)


def axis_sizes(mesh: DeviceMesh) -> dict:
    """{axis name: size}, the counterpart of `jax.sharding.Mesh.shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@functools.lru_cache(maxsize=None)
def compute_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh DTensors live on: `mesh` less its size-1 axes (`dp` alone
    when every axis is trivial). A size-1 axis shards nothing, and
    DTensor's sharding propagation enumerates placements per mesh
    dimension, so each trivial axis would multiply its work for nothing
    (a matmul's propagation over the six axes took seconds)."""
    names = tuple(n for n, s in zip(mesh.mesh_dim_names, mesh.shape)
                  if s > 1) or ("dp",)
    if names == tuple(mesh.mesh_dim_names):
        return mesh
    return mesh[names]


def device_count(mesh: DeviceMesh) -> int:
    return int(np.prod(list(axis_sizes(mesh).values())))
