"""A serving replica sharded over tensor-parallel ranks.

The port's own module: a JAX replica is one process that drives its
mesh's chips, while a PyTorch replica over tp ranks is tp processes. Rank
0 is the replica itself (`LLMEngine(mesh={"tp": n})`, in process or as a
Serve replica): it runs the scheduler and alone talks to the router and
the token stream. Ranks 1..n-1 are `TPRank` actors that rank 0 starts
with the replica's own actor options in a STRICT_PACK placement group.

The ranks form a process group of their own (`ReplicaGroup`), chosen by
rule: nccl when every rank has its own card, gloo when ranks share a
card (NCCL refuses two ranks on one device; gloo's all-reduce and
broadcast take CUDA tensors) or run on the CPU. At each of
`EngineCore`'s two model seams, rank 0 broadcasts the step's small
integer inputs (the lockstep protocol: a header of kind and sizes, then
one int32 payload), and every rank runs its shard of the model on them
(`models/decode.py` with `group`).

Faults end in an error, never a hang: a collective on a dead peer raises,
and every collective has the group's timeout, so rank 0's step raises and
`LLMEngine` ends every open request. An idle rank 0 sends a no-op step
every quarter of the timeout. A follower whose collective fails, or whose
rank 0 process is gone, exits its process, so it dies with rank 0.
"""
from __future__ import annotations

import datetime
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

COLLECTIVE_TIMEOUT_S = 120.0

KIND_NOOP, KIND_PREFILL, KIND_DECODE, KIND_STOP = 0, 1, 2, 3


def device_key(dev: torch.device) -> str:
    """What tells two ranks' devices apart: "cpu", or the card's UUID."""
    if dev.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(dev).uuid)


def choose_backend(keys: Sequence[str]) -> str:
    """nccl when every rank has a card of its own; gloo when two ranks
    share a card, or on the CPU."""
    if "cpu" in keys or len(set(keys)) < len(keys):
        return "gloo"
    return "nccl"


class ReplicaGroup:
    """One replica's process group: `rank`, `size`, `backend`, the sums
    that the sharded model needs, and the lockstep step protocol.
    `pg` may be any torch ProcessGroup (a test passes `dist.group.WORLD`);
    `join` makes a group of the replica's own."""

    def __init__(self, pg, rank: int, size: int, backend: str,
                 wire: torch.device = torch.device("cpu"), store=None):
        self.pg, self.rank, self.size = pg, rank, size
        self.backend = backend
        self.wire = wire          # where step messages travel
        self._store = store       # rank 0 hosts the rendezvous
        self.last_send = time.monotonic()

    @classmethod
    def join(cls, addr: Tuple[str, int], rank: int, size: int,
             backend: str, device: torch.device,
             store=None) -> "ReplicaGroup":
        """Join the group whose rendezvous rank 0 hosts at `addr` (rank
        0 passes the store it listens on)."""
        timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
        if store is None:
            store = (dist.HashStore() if size == 1 else dist.TCPStore(
                addr[0], addr[1], size, False, timeout=timeout))
        if backend == "nccl":
            torch.cuda.set_device(device)
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            pg = dist.ProcessGroupNCCL(store, rank, size, opts)
            wire = device
        else:
            pg = dist.ProcessGroupGloo(store, rank, size, timeout)
            wire = torch.device("cpu")
        return cls(pg, rank, size, backend, wire, store)

    # ------------------------------------------------------ collectives
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group, in place; returns it."""
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM
        self.pg.allreduce([t], opts).wait()
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank, in place; returns it."""
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = 0, 0
        self.pg.broadcast([t], opts).wait()
        return t

    # ------------------------------------------------ lockstep protocol
    def send_step(self, kind: int, arrays: Sequence[np.ndarray] = (),
                  true_len: int = 0) -> None:
        """Rank 0: announce a step and its integer inputs."""
        payload = (np.concatenate([np.asarray(a, np.int32).ravel()
                                   for a in arrays])
                   if arrays else np.zeros((0,), np.int32))
        self.last_send = time.monotonic()
        if self.size == 1:
            return
        header = torch.tensor([kind, payload.size, int(true_len), 0],
                              dtype=torch.int64, device=self.wire)
        self.broadcast(header)
        if payload.size:
            self.broadcast(torch.as_tensor(payload, device=self.wire))

    def recv_step(self) -> Tuple[int, int, torch.Tensor]:
        """Ranks 1..: (kind, true_len, the int32 payload on the wire's
        device)."""
        header = self.broadcast(torch.zeros(4, dtype=torch.int64,
                                            device=self.wire)).tolist()
        kind, n, true_len = int(header[0]), int(header[1]), int(header[2])
        payload = torch.zeros(n, dtype=torch.int32, device=self.wire)
        if n:
            self.broadcast(payload)
        return kind, true_len, payload

    def keepalive(self) -> None:
        """Rank 0, idle: a no-op step when none went out for a quarter of
        the timeout, so the followers' waits stay inside it."""
        if (self.size > 1 and time.monotonic() - self.last_send
                >= COLLECTIVE_TIMEOUT_S / 4):
            self.send_step(KIND_NOOP)


def split_prefill(payload: torch.Tensor, max_pages: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(padded tokens, page table) of a prefill step's payload."""
    s_pad = payload.numel() - max_pages
    return payload[:s_pad], payload[s_pad:]


def split_decode(payload: torch.Tensor, batch: int, max_pages: int):
    """(tokens, positions, page tables, active) of a decode step's
    payload."""
    b, p = batch, batch * max_pages
    return (payload[:b], payload[b:2 * b],
            payload[2 * b:2 * b + p].view(batch, max_pages),
            payload[2 * b + p:].bool())


def tp_of_mesh(mesh: Optional[Dict[str, int]], config) -> Optional[int]:
    """The replica's tp from an axes dict, or None without a mesh. `dp`
    must be 1 (Serve's replicas are the dp) and any other axis larger
    than 1 raises a ValueError naming it, as does a tp that does not
    divide the model's heads, kv heads, FFN or vocab."""
    if not mesh:
        return None
    from ray_tpu_torch.models.convert import check_tp
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    for axis, size in mesh.items():
        if axis not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {axis!r}; axes are "
                             f"{AXIS_ORDER}")
        if axis == "dp" and size not in (1, -1):
            raise ValueError(f"mesh axis dp={size}: a replica's dp is 1 "
                             f"(Serve's replicas are the dp)")
        if axis not in ("dp", "tp") and size != 1:
            raise ValueError(f"mesh axis {axis}={size}: a serving "
                             f"replica shards over tp only")
    tp = int(mesh.get("tp", 1))
    check_tp(config, tp)
    return tp


def _leader_watch(host: str, pid: int) -> None:
    """Exit this process once rank 0's process (on this host) is gone."""
    if host != socket.gethostname():
        return

    def watch():
        while True:
            time.sleep(0.5)
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                os._exit(1)
            except PermissionError:
                pass
    threading.Thread(target=watch, name="tp-leader-watch",
                     daemon=True).start()


class TPRank:
    """Rank r > 0 of a replica: places itself, joins the group, loads its
    shard of the weights and a cache of its kv heads, then runs rank 0's
    steps until told to stop. Its actor runs two calls at once, so
    `launches` answers while `run` loops."""

    def __init__(self):
        self.device: Optional[torch.device] = None
        self.group: Optional[ReplicaGroup] = None

    def place(self, device: Optional[str]) -> dict:
        """Take this rank's device: the CPU when asked (with one intra-op
        thread), else the card the runtime pinned this actor's process
        to (ranks of `num_gpus` below 1 may share it)."""
        from ray_tpu_torch.ops.dispatch import resolve_device
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        else:
            # on the CPU the ranks share the host's cores: each rank's
            # full OpenMP pool spinning beside the other's slowed a tiny()
            # decode step about 25-fold
            torch.set_num_threads(1)
        return {"host": socket.gethostname(), "pid": os.getpid(),
                "device": device_key(self.device),
                "cards": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def join(self, addr, rank: int, size: int, backend: str,
             leader: Tuple[str, int]) -> int:
        _leader_watch(*leader)
        self.group = ReplicaGroup.join(tuple(addr), rank, size, backend,
                                       self.device)
        return rank

    def setup(self, config: dict, weights, seed: int, num_pages: int,
              page_size: int, max_batch: int) -> int:
        """Load this rank's shard and zero its cache; returns the cache's
        bytes."""
        from ray_tpu_torch.models import decode as _dec
        from ray_tpu_torch.models.config import TransformerConfig
        from ray_tpu_torch.models.transformer import Transformer
        from ray_tpu_torch.serve.llm.kv_cache import pages_needed
        cfg = TransformerConfig(**config)
        g = self.group
        self.model = Transformer(cfg)
        self.params = rank_params(self.model, weights, seed, g.size, g.rank,
                                  self.device)
        kv = self.params["layers"][0]["wk"].shape[1] // cfg.head_dim
        self.cache = _dec.init_paged_cache(cfg, num_pages, page_size,
                                           device=self.device, kv_heads=kv)
        self.page_size, self.max_batch = page_size, max_batch
        self.max_pages = pages_needed(cfg.max_seq_len, page_size)
        return cache_bytes(self.cache)

    @torch.inference_mode()
    def run(self) -> dict:
        """Run rank 0's steps until it sends a stop; returns this rank's
        kernel launches. A failed collective ends the process."""
        from ray_tpu_torch.models import decode as _dec
        try:
            while True:
                kind, true_len, payload = self.group.recv_step()
                if kind == KIND_STOP:
                    break
                if kind == KIND_NOOP:
                    continue
                payload = payload.to(self.device)
                if kind == KIND_PREFILL:
                    tokens, table = split_prefill(payload, self.max_pages)
                    _dec.prefill(self.model, self.params, tokens, true_len,
                                 table, self.cache, self.page_size,
                                 group=self.group)
                else:
                    _dec.decode_step(self.model, self.params, self.cache,
                                     *split_decode(payload, self.max_batch,
                                                   self.max_pages),
                                     self.page_size, group=self.group)
        except BaseException as e:
            # rank 0 is gone, or a collective failed or timed out
            log.error("tp rank %d: %s: %s; exiting", self.group.rank,
                      type(e).__name__, (str(e).splitlines() or [""])[0])
            os._exit(1)
        self.params = self.cache = None
        return self.launches()

    def launches(self) -> dict:
        from ray_tpu_torch.ops.attention import flash_attention
        from ray_tpu_torch.ops.norms import rms_norm
        from ray_tpu_torch.ops.paged_decode import paged_decode_attention
        return {"flash_fwd": flash_attention.launches,
                "rms_norm": rms_norm.launches,
                "paged_decode": paged_decode_attention.launches}


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def rank_params(model, weights, seed: int, tp: int, rank: int,
                device: torch.device):
    """Rank `rank`'s shard on `device`: of an ObjectRef's params (only
    the shard is copied to the device), of a params dict, or made from
    `seed` leaf by leaf (the whole model is never held)."""
    from ray_tpu_torch.models.convert import (init_shard_for_serving,
                                              tp_shard_params)
    if weights is None:
        return init_shard_for_serving(model, seed, tp, rank, device)
    if hasattr(weights, "object_id"):
        import ray_tpu_torch
        weights = ray_tpu_torch.get(weights)
    return tp_shard_params(weights, model.config, tp, rank, device)


class RankGroup:
    """Rank 0's side of a replica over `tp` ranks: starts ranks 1..tp-1
    as `TPRank` actors in a STRICT_PACK placement group, picks the
    backend, joins the group and drives the followers' lifetimes."""

    def __init__(self, tp: int, device: torch.device,
                 actor_options: Optional[dict] = None):
        import ray_tpu_torch
        from ray_tpu_torch.util.placement_group import placement_group
        self.tp, self.device = tp, device
        self.actors: List[Any] = []
        self.cache_bytes: List[int] = []      # ranks 1.., once loaded
        self._runs: List[Any] = []
        self._pg = None
        opts = dict(actor_options or {})
        if "num_gpus" not in opts and device.type == "cuda":
            opts["num_gpus"] = 1
        gpus = float(opts.get("num_gpus") or 0)
        try:
            if tp > 1:
                bundle = {"CPU": float(opts.get("num_cpus") or 0)}
                if gpus:
                    bundle["GPU"] = gpus
                bundle.update(opts.get("resources") or {})
                self._pg = placement_group([dict(bundle)] * (tp - 1),
                                           strategy="STRICT_PACK")
                if not self._pg.wait(timeout_seconds=60):
                    raise TimeoutError(f"no room for {tp - 1} tp ranks "
                                       f"of {bundle} on one node")
                cls = ray_tpu_torch.remote(**{**opts,
                                              "max_concurrency": 2})(TPRank)
                self.actors = [
                    cls.options(placement_group=self._pg,
                                placement_group_bundle_index=i).remote()
                    for i in range(tp - 1)]
            dev_arg = None if device.type == "cuda" else str(device)
            infos = ray_tpu_torch.get(
                [a.place.remote(dev_arg) for a in self.actors],
                timeout=COLLECTIVE_TIMEOUT_S)
            self.pids = [i["pid"] for i in infos]
            self.cards = [i["cards"] for i in infos]
            keys = [device_key(device)] + [i["device"] for i in infos]
            backend = choose_backend(keys)
            log.info("replica over tp=%d: %s process group (devices %s)",
                     tp, backend, keys)
            store = None
            addr = ("", 0)
            if tp > 1:
                host = socket.gethostbyname(socket.gethostname())
                store = dist.TCPStore(
                    host, 0, tp, True, wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
                addr = (host, store.port)
            leader = (socket.gethostname(), os.getpid())
            joins = [a.join.remote(addr, r + 1, tp, backend, leader)
                     for r, a in enumerate(self.actors)]
            self.group = ReplicaGroup.join(addr, 0, tp, backend, device,
                                           store=store)
            ray_tpu_torch.get(joins, timeout=COLLECTIVE_TIMEOUT_S)
        except BaseException:
            self.abort()
            raise

    @property
    def backend(self) -> str:
        return self.group.backend

    def setup(self, config, weights, seed: int, num_pages: int,
              page_size: int, max_batch: int) -> list:
        """Start every follower's load (ObjectRefs; `weights` is an
        ObjectRef or None)."""
        import dataclasses
        cfg = dataclasses.asdict(config)
        return [a.setup.remote(cfg, weights, seed, num_pages, page_size,
                               max_batch) for a in self.actors]

    def start(self) -> None:
        self._runs = [a.run.remote() for a in self.actors]

    def launches(self) -> List[dict]:
        """Each follower's kernel launches, by rank (1..)."""
        import ray_tpu_torch
        return ray_tpu_torch.get([a.launches.remote() for a in self.actors],
                                 timeout=COLLECTIVE_TIMEOUT_S)

    def close(self) -> None:
        """Stop the followers after their current step, then free them."""
        import ray_tpu_torch
        try:
            if self._runs:
                self.group.send_step(KIND_STOP)
                ray_tpu_torch.get(self._runs, timeout=COLLECTIVE_TIMEOUT_S)
        except BaseException:
            pass
        finally:
            self.abort()

    def abort(self) -> None:
        """Kill the followers and free their placement group."""
        import ray_tpu_torch
        actors, self.actors, self._runs = self.actors, [], []
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except BaseException:
                pass
        pg, self._pg = self._pg, None
        if pg is not None:
            from ray_tpu_torch.util.placement_group import \
                remove_placement_group
            try:
                remove_placement_group(pg)
            except BaseException:
                pass
