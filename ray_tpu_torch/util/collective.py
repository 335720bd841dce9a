"""Host-side (CPU) collective group across actors/driver.

Parity: reference ray.util.collective (util/collective/collective.py —
init_collective_group:120, allreduce:258, broadcast:373, allgather:423,
reducescatter:472, send:531, recv:594) with its gloo CPU backend
(collective_group/gloo_collective_group.py). Port of
`ray_tpu/util/collective.py`: card collectives belong to
torch.distributed over a process group (parallel/collectives.py); this
module is the control/host plane those collectives don't cover:
rendezvous, small-tensor CPU reductions, and p2p between actor
processes.

Values: numpy arrays and torch tensors, returned as numpy. A CUDA
tensor is copied to the host first. A bf16 tensor travels as its bytes
plus its dtype (numpy has no bfloat16), is reduced in bf16 by torch on
the coordinator, and comes back as a bf16 CPU tensor.

Transport: one named coordinator actor per group (its own process; all
participants rendezvous on the name), payloads ride the shm object
plane. Each participant keeps a local operation sequence number, so the
k-th collective call on every rank lands in the same round — the same
implicit-ordering contract gloo/NCCL groups rely on.
"""
from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np

_GROUPS: Dict[str, "_GroupHandle"] = {}
_DEFAULT_TIMEOUT_S = 60.0


class _TensorBytes:
    """A tensor whose dtype numpy lacks (bf16): its bytes and dtype."""

    def __init__(self, data: np.ndarray, dtype: str, shape: tuple):
        self.data, self.dtype, self.shape = data, dtype, shape

    @classmethod
    def of(cls, t) -> "_TensorBytes":
        import torch
        return cls(t.contiguous().reshape(-1).view(torch.uint8).numpy(),
                   str(t.dtype).rsplit(".", 1)[-1], tuple(t.shape))

    def tensor(self):
        import torch
        return torch.from_numpy(np.array(self.data)).view(
            getattr(torch, self.dtype)).reshape(self.shape)


def _host(value):
    """A value as it travels: numpy, or _TensorBytes for a tensor whose
    dtype numpy cannot hold. A CUDA tensor is copied to the host."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        try:
            return t.numpy()
        except TypeError:              # bf16 and other non-numpy dtypes
            return _TensorBytes.of(t)
    return np.asarray(value)


def _local(value):
    """A travelled value as the caller gets it back."""
    if isinstance(value, _TensorBytes):
        return value.tensor()
    if isinstance(value, list):
        return [_local(v) for v in value]
    return value


def _reduce(arrays: List[Any], op: str):
    """Reduce numpy arrays, or (any _TensorBytes among them) torch
    tensors in their own dtype."""
    if any(isinstance(a, _TensorBytes) for a in arrays):
        import torch
        ts = [a.tensor() if isinstance(a, _TensorBytes)
              else torch.from_numpy(np.asarray(a)) for a in arrays]
        fns = {"sum": lambda x, y: x + y, "max": torch.maximum,
               "min": torch.minimum, "prod": lambda x, y: x * y,
               "mean": lambda x, y: x + y}
        if op not in fns:
            raise ValueError(f"unknown reduce op {op!r}")
        out = ts[0].clone()
        for t in ts[1:]:
            out = fns[op](out, t)
        if op == "mean":
            out = out / len(ts)
        return _TensorBytes.of(out)
    arrays = [np.asarray(a) for a in arrays]
    if op == "sum":
        out = arrays[0].copy()
        for a in arrays[1:]:
            out = out + a
    elif op == "max":
        out = np.maximum.reduce(arrays)
    elif op == "min":
        out = np.minimum.reduce(arrays)
    elif op == "prod":
        out = np.multiply.reduce(arrays)
    elif op == "mean":
        out = sum(arrays[1:], arrays[0].copy()) / len(arrays)
    else:
        raise ValueError(f"unknown reduce op {op!r}")
    return out


class _Coordinator:
    """Rendezvous + reduction actor (one per group)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._cv = threading.Condition()
        self._rounds: Dict[Any, dict] = {}
        self._mail: Dict[Any, Any] = {}     # p2p mailbox

    def ping(self):
        return "pong"

    # ---------------------------------------------------- collectives
    def collect(self, key, rank: int, payload, kind: str, op: str,
                src_rank: int, timeout: float):
        with self._cv:
            rnd = self._rounds.setdefault(key, {"data": {}, "claimed": 0})
            if rank in rnd["data"]:
                raise RuntimeError(
                    f"rank {rank} contributed twice to round {key!r} — "
                    f"collective calls out of sync")
            rnd["data"][rank] = payload
            if len(rnd["data"]) == self.world_size:
                rnd["result"] = self._finish(rnd["data"], kind, op,
                                             src_rank)
                self._cv.notify_all()
            elif not self._cv.wait_for(lambda: "result" in rnd,
                                       timeout=timeout):
                # withdraw our contribution so a retry of this key isn't
                # poisoned ("contributed twice") and abandoned rounds
                # don't accumulate
                rnd["data"].pop(rank, None)
                if not rnd["data"]:
                    self._rounds.pop(key, None)
                raise TimeoutError(
                    f"collective round {key!r}: only "
                    f"{len(rnd['data']) + 1}/{self.world_size} ranks "
                    f"arrived within {timeout}s")
            result = rnd["result"]
            rnd["claimed"] += 1
            if rnd["claimed"] == self.world_size:
                del self._rounds[key]
        if kind == "reducescatter":
            if isinstance(result, _TensorBytes):
                return _TensorBytes.of(result.tensor().tensor_split(
                    self.world_size)[rank])
            return np.array_split(result, self.world_size)[rank]
        return result

    def _finish(self, data: Dict[int, Any], kind: str, op: str,
                src_rank: int):
        if kind == "broadcast":
            return data[src_rank]
        if kind == "allgather":
            return [data[r] for r in range(self.world_size)]
        if kind == "barrier":
            return True
        return _reduce([data[r] for r in range(self.world_size)], op)

    # ------------------------------------------------------------ p2p
    def put_mail(self, key, payload) -> None:
        with self._cv:
            if key in self._mail:
                raise RuntimeError(f"duplicate send for {key!r}")
            self._mail[key] = payload
            self._cv.notify_all()

    def take_mail(self, key, timeout: float):
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._mail,
                                     timeout=timeout):
                raise TimeoutError(f"recv {key!r}: no matching send "
                                   f"within {timeout}s")
            return self._mail.pop(key)


class _GroupHandle:
    def __init__(self, name: str, world_size: int, rank: int, actor):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.actor = actor
        self.seq = 0                      # per-rank op counter
        self.p2p_seq: Dict[tuple, int] = {}


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> None:
    """Join (rank of world_size) a named collective group. Every
    participant — driver or actor — calls this once before using the
    verbs below (reference collective.py:120)."""
    import time as _time

    import ray_tpu_torch
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    if group_name in _GROUPS:
        raise RuntimeError(f"group {group_name!r} already initialized "
                           f"in this process")
    name = f"_rtpu_collective::{group_name}"
    # Rank 0 creates the coordinator; everyone else looks it up (retry —
    # a concurrent get_if_exists from every rank would race the
    # check-then-create window across processes).
    coord = None
    if rank == 0:
        coord = ray_tpu_torch.remote(
            max_concurrency=max(2, world_size * 2))(_Coordinator).options(
            name=name, get_if_exists=True).remote(world_size)
    else:
        deadline = _time.time() + _DEFAULT_TIMEOUT_S
        while coord is None:
            try:
                coord = ray_tpu_torch.get_actor(name)
            except ValueError:
                if _time.time() > deadline:
                    raise TimeoutError(
                        f"rank {rank}: coordinator for group "
                        f"{group_name!r} never appeared — did rank 0 "
                        f"call init_collective_group?")
                _time.sleep(0.1)
    ray_tpu_torch.get(coord.ping.remote())      # rendezvous / liveness
    _GROUPS[group_name] = _GroupHandle(group_name, world_size, rank,
                                       coord)


def destroy_collective_group(group_name: str = "default") -> None:
    import ray_tpu_torch
    h = _GROUPS.pop(group_name, None)
    if h is not None and h.rank == 0:
        try:
            ray_tpu_torch.kill(h.actor)
        except BaseException:
            pass


def _group(group_name: str) -> _GroupHandle:
    h = _GROUPS.get(group_name)
    if h is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            f"process; call init_collective_group first")
    return h


def _round(h: _GroupHandle, kind: str, payload, op: str = "sum",
           src_rank: int = 0, timeout: float = _DEFAULT_TIMEOUT_S):
    import ray_tpu_torch
    key = (kind, h.seq)
    h.seq += 1
    return _local(ray_tpu_torch.get(
        h.actor.collect.remote(key, h.rank, payload, kind, op, src_rank,
                               timeout),
        timeout=timeout + 10.0))


# ------------------------------------------------------------- verbs
def allreduce(array, op: str = "sum", group_name: str = "default",
              timeout: float = _DEFAULT_TIMEOUT_S) -> np.ndarray:
    return _round(_group(group_name), "allreduce", _host(array),
                  op=op, timeout=timeout)


def allgather(array, group_name: str = "default",
              timeout: float = _DEFAULT_TIMEOUT_S) -> List[np.ndarray]:
    return _round(_group(group_name), "allgather", _host(array),
                  timeout=timeout)


def broadcast(array, src_rank: int = 0, group_name: str = "default",
              timeout: float = _DEFAULT_TIMEOUT_S) -> np.ndarray:
    return _round(_group(group_name), "broadcast", _host(array),
                  src_rank=src_rank, timeout=timeout)


def reducescatter(array, op: str = "sum", group_name: str = "default",
                  timeout: float = _DEFAULT_TIMEOUT_S) -> np.ndarray:
    """Reduce across ranks, then return this rank's 1/world_size shard
    (split along axis 0, numpy array_split semantics)."""
    return _round(_group(group_name), "reducescatter", _host(array),
                  op=op, timeout=timeout)


def barrier(group_name: str = "default",
            timeout: float = _DEFAULT_TIMEOUT_S) -> None:
    _round(_group(group_name), "barrier", None, timeout=timeout)


def send(array, dst_rank: int, group_name: str = "default",
         tag: int = 0) -> None:
    import ray_tpu_torch
    h = _group(group_name)
    pk = (h.rank, dst_rank, tag)
    seq = h.p2p_seq.get(pk, 0)
    h.p2p_seq[pk] = seq + 1
    ray_tpu_torch.get(h.actor.put_mail.remote((*pk, seq), _host(array)))


def recv(src_rank: int, group_name: str = "default", tag: int = 0,
         timeout: float = _DEFAULT_TIMEOUT_S) -> np.ndarray:
    import ray_tpu_torch
    h = _group(group_name)
    pk = (src_rank, h.rank, tag)
    seq = h.p2p_seq.get(pk, 0)
    h.p2p_seq[pk] = seq + 1
    return _local(ray_tpu_torch.get(
        h.actor.take_mail.remote((*pk, seq), timeout),
        timeout=timeout + 10.0))
