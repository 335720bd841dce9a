"""PPO Learner + LearnerGroup on torch.

Port of `ray_tpu/rllib/core/learner.py`. Parity: reference
rllib/core/learner/learner.py (update loop), learner_group.py (a group
of learner actors driven through FaultTolerantActorManager) and the PPO
loss of rllib/algorithms/ppo/ppo_torch_learner.py.

The JAX learner compiles the whole update (values, GAE, advantage
normalisation, epochs × minibatches) into one XLA program. Here the same
steps run as a loop over tensors on the learner's device:
- the optimizer is optax's chain, written out: the global-norm clip
  scales by `max_norm / norm` only when the norm exceeds the limit
  (`torch.nn.utils.clip_grad_norm_` divides by `norm + 1e-6` always),
  then `torch.optim.Adam(eps=1e-5)`, which is optax's adam;
- the KL early stop: a minibatch's update is applied only while `stop`
  is false, and `stop` turns true once that minibatch's own KL (taken
  before its update) exceeds `target_kl`; the returned metrics are the
  last minibatch's of the last epoch, on the frozen parameters after a
  stop, as in JAX;
- each epoch's permutation comes from a CPU `torch.Generator` seeded
  from `config.seed`, so a learner on the card and one on the CPU take
  the same minibatches;
- data parallelism (`num_devices > 1`) is a process group of that many
  ranks. Every rank holds the whole batch, draws the same permutation
  and takes its share of every minibatch. The loss divides by the
  minibatch's whole mask count, so the gradients are all-reduced by SUM
  (DDP's average would give another update whenever the shards' masks
  differ), and so are the metrics.
"""
from __future__ import annotations

import dataclasses
import socket
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule

_METRICS = ("policy_loss", "vf_loss", "entropy", "kl", "clip_frac")


@dataclasses.dataclass
class PPOLearnerConfig:
    obs_dim: int = 0
    num_actions: int = 0
    hidden: Sequence[int] = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    vf_clip: float = 10.0
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    num_epochs: int = 4
    num_minibatches: int = 4
    target_kl: float = 0.03   # stop epoch/minibatch SGD when exceeded
    continuous: bool = False  # Box action space (diag-gaussian head)
    seed: int = 0
    # Data-parallel width: the ranks of the process group this learner
    # belongs to (LearnerGroup(num_learners=k) forms it). 1 = no group.
    num_devices: int = 1
    # Learner-side connector pipeline (reference rllib/connectors/
    # learner/): LearnerConnector instances applied to the numpy batch
    # BEFORE the update. A pipeline containing GeneralAdvantageEstimation
    # makes the update consume the connector-computed
    # `advantages`/`value_targets`.
    learner_connectors: Optional[Sequence] = None
    # None = the card (raises where there is none); "cpu" only by name
    device: Optional[str] = None


def _host(tree):
    """A copy of `tree` with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: g / norm * max_norm where the
    norm exceeds max_norm, g itself otherwise."""
    norm = torch.nn.utils.get_total_norm(grads)
    keep = norm < max_norm
    one = torch.ones((), device=norm.device, dtype=norm.dtype)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, one * max_norm)
    for g in grads:
        g.div_(div).mul_(mul)


def descend(opt: torch.optim.Optimizer, params: List[torch.Tensor],
            grads) -> None:
    """One step of `opt` on `params` along `grads`."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def allreduce_sum(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """SUM over the process group of every tensor in `parts`, in one
    call."""
    import torch.distributed as tdist
    flat = torch.cat([p.reshape(-1) for p in parts])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM)
    return [f.view_as(p) for f, p in
            zip(flat.split([p.numel() for p in parts]), parts)]


def dp_world(num_devices: int) -> tuple:
    """(world size, rank) of the process group a learner with
    `num_devices` ranks belongs to; (1, 0) for one."""
    if num_devices <= 1:
        return 1, 0
    import torch.distributed as tdist
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if world != num_devices:
        raise ValueError(
            f"num_devices={num_devices} needs a process group of that "
            f"many ranks (LearnerGroup(num_learners={num_devices}) forms "
            f"one); this process has {world}")
    return world, tdist.get_rank()


class PPOLearner:
    """Holds the module and optimizer state on its device; `update(batch)`
    runs one PPO update.

    Batch layout (time-major, from SingleAgentEnvRunner.sample):
      obs         (T+1, N, obs_dim) — includes bootstrap observation
      actions     (T, N) int32
      logp        (T, N) f32        — behaviour log-probs
      rewards     (T, N) f32
      terminateds (T, N) f32        — true termination (no bootstrap)
      dones       (T, N) f32        — terminated | truncated (GAE cut;
                                      truncation still bootstraps off
                                      the final obs)
      mask        (T, N) f32        — 0 on autoreset filler transitions
    """

    def __init__(self, config: PPOLearnerConfig,
                 module: Optional[nn.Module] = None):
        self.config = config
        self.device = resolve_device(config.device)
        init_seed, perm_seed = (
            int(s) for s in np.random.SeedSequence(
                config.seed).generate_state(2))
        self.module = module or ActorCriticModule(
            config.obs_dim, config.num_actions, tuple(config.hidden),
            continuous=config.continuous)
        # drawn on the CPU, then moved: every device starts alike
        self.module.init(torch.Generator().manual_seed(init_seed))
        self.module.to(self.device)
        self._perm_gen = torch.Generator().manual_seed(perm_seed)
        self._opt = torch.optim.Adam(self.module.parameters(),
                                     lr=config.lr, eps=1e-5)
        from ray_tpu_torch.rllib.connectors import (
            GeneralAdvantageEstimation, LearnerConnectorPipeline)
        self._connectors = (
            LearnerConnectorPipeline(list(config.learner_connectors))
            if config.learner_connectors else None)
        self._precomputed_adv = bool(self._connectors and any(
            isinstance(c, GeneralAdvantageEstimation)
            for c in self._connectors.connectors))
        self._world, self._rank = dp_world(config.num_devices)
        self._timer = {"updates": 0, "update_time": 0.0,
                       "minibatches": 0, "transitions": 0}

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    # ---------------------------------------------------------- update
    def _gae(self, values, rewards, terms, dones):
        # values (T+1, N); recursion runs backwards over time.
        # terminated cuts the bootstrap; done (incl. truncation) cuts
        # only the advantage chain — truncation bootstraps off
        # V(final obs), which gymnasium delivers at the done step.
        c = self.config
        adv = torch.empty_like(rewards)
        carry = torch.zeros_like(values[0])
        for t in range(rewards.shape[0] - 1, -1, -1):
            delta = rewards[t] + c.gamma * values[t + 1] * (1 - terms[t]) \
                - values[t]
            carry = delta + c.gamma * c.gae_lambda * (1 - dones[t]) * carry
            adv[t] = carry
        return adv

    def _loss(self, mb, denom):
        c = self.config
        module = self.module
        logits, value = module(mb["obs"])
        logp = module.dist_log_prob(logits, mb["actions"])
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["adv"]
        pg = -torch.minimum(
            ratio * adv, ratio.clamp(1 - c.clip_eps, 1 + c.clip_eps) * adv)
        v_err = (value - mb["vtarg"]).square()
        v_clipped = mb["vpred"] + (value - mb["vpred"]).clamp(
            -c.vf_clip, c.vf_clip)
        v_err = torch.maximum(v_err, (v_clipped - mb["vtarg"]).square())
        ent = module.dist_entropy(logits)
        m = mb["mask"]
        pg_loss = (pg * m).sum() / denom
        v_loss = 0.5 * (v_err * m).sum() / denom
        ent_loss = (ent * m).sum() / denom
        total = pg_loss + c.vf_coef * v_loss - c.ent_coef * ent_loss
        kl = ((mb["logp"] - logp) * m).sum() / denom
        clipped = (((ratio - 1).abs() > c.clip_eps) * m).sum() / denom
        metrics = torch.stack([pg_loss, v_loss, ent_loss, kl, clipped])
        return total, metrics.detach()

    def _clip_by_global_norm(self, grads: List[torch.Tensor]) -> None:
        clip_by_global_norm_(grads, self.config.max_grad_norm)

    def _allreduce(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        return allreduce_sum(parts)

    def _sgd(self, batch: Dict[str, Any],
             perms: Sequence) -> Dict[str, float]:
        """The update on `batch` with one permutation of its T*N steps
        per epoch (tests pass the JAX learner's own)."""
        c = self.config
        dev = self.device
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        obs, rewards = b["obs"], b["rewards"]
        mask = b["mask"]
        T, N = rewards.shape
        denom = mask.sum().clamp_min(1.0)
        with torch.no_grad():
            _, values = self.module(obs)                    # (T+1, N)
            if self._precomputed_adv:
                # the learner-connector pipeline (GAE + standardize)
                # already produced these on the host
                adv, vtarg = b["advantages"], b["value_targets"]
            else:
                adv = self._gae(values, rewards, b["terminateds"],
                                b["dones"])
                vtarg = adv + values[:-1]
                # Normalise advantages over valid transitions only.
                mu = (adv * mask).sum() / denom
                var = ((adv - mu).square() * mask).sum() / denom
                adv = (adv - mu) * torch.rsqrt(var + 1e-8)
        act = b["actions"]
        B = T * N
        flat = {
            "obs": obs[:-1].reshape((B,) + tuple(obs.shape[2:])),
            "actions": act.reshape((B,) + tuple(act.shape[2:])),
            "logp": b["logp"].reshape(B),
            "adv": adv.reshape(B),
            "vtarg": vtarg.reshape(B),
            "vpred": values[:-1].reshape(B),
            "mask": mask.reshape(B),
        }
        mb_size = B // c.num_minibatches
        params = list(self.module.parameters())
        stop = False
        metrics = None
        for epoch, perm in enumerate(perms):
            idxs = torch.as_tensor(perm)[:mb_size * c.num_minibatches]
            idxs = idxs.reshape(c.num_minibatches, mb_size).to(dev)
            for j in range(c.num_minibatches):
                last = (epoch == len(perms) - 1
                        and j == c.num_minibatches - 1)
                if stop and not last:
                    continue       # nothing it computes would be kept
                mb = {k: v[idxs[j]] for k, v in flat.items()}
                mb_denom = mb["mask"].sum().clamp_min(1.0)
                if self._world > 1:
                    mb = {k: v.tensor_split(self._world)[self._rank]
                          for k, v in mb.items()}
                with torch.set_grad_enabled(not stop):
                    total, metrics = self._loss(mb, mb_denom)
                grads = (list(torch.autograd.grad(total, params))
                         if not stop else [])
                if self._world > 1:
                    *grads, metrics = self._allreduce(grads + [metrics])
                if not stop:
                    self._clip_by_global_norm(grads)
                    descend(self._opt, params, grads)
                stop = stop or abs(metrics[3].item()) > c.target_kl
        vpred = values[:-1]
        explained = 1.0 - (
            ((vtarg - vpred).square() * mask).sum()
            / (((vtarg - (vtarg * mask).sum() / denom).square() * mask)
               .sum().clamp_min(1e-8)))
        out = dict(zip(_METRICS, metrics.tolist()))
        out["vf_explained_var"] = float(explained)
        return out

    def _permutations(self, n: int) -> List[torch.Tensor]:
        """One permutation of the batch's n steps per epoch, from the
        learner's CPU generator."""
        return [torch.randperm(n, generator=self._perm_gen)
                for _ in range(self.config.num_epochs)]

    # ------------------------------------------------------------- api
    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        """Value predictions for a (T+1, N, obs) stack — the module
        query learner connectors (GAE) use."""
        with torch.no_grad():
            _, values = self.module(torch.as_tensor(obs, device=self.device))
        return values.cpu().numpy()

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        t0 = time.perf_counter()
        if self._connectors is not None:
            batch = self._connectors(dict(batch), self)
        T, N = np.shape(batch["rewards"])
        metrics = self._sgd(batch, self._permutations(T * N))
        dt = time.perf_counter() - t0
        self._timer["updates"] += 1
        self._timer["update_time"] += dt
        self._timer["minibatches"] += (self.config.num_epochs
                                       * self.config.num_minibatches)
        self._timer["transitions"] += T * N
        metrics["update_time_s"] = dt
        return metrics

    def sgd_throughput(self) -> Dict[str, float]:
        t = max(self._timer["update_time"], 1e-9)
        return {
            "minibatch_updates_per_s": self._timer["minibatches"] / t,
            "learner_transitions_per_s": (
                self._timer["transitions"] * self.config.num_epochs / t),
        }

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The module's state dict, copied to the host."""
        return _host(self.module.state_dict())

    def set_weights(self, weights) -> None:
        self.module.load_state_dict(
            {k: torch.as_tensor(v) for k, v in weights.items()})

    def get_state(self) -> Dict[str, Any]:
        state = {"params": self.get_weights(),
                 "opt_state": _host(self._opt.state_dict())}
        if self._connectors is not None:
            state["connectors"] = self._connectors.get_state()
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["params"])
        self._opt.load_state_dict(state["opt_state"])
        if self._connectors is not None and "connectors" in state:
            self._connectors.set_state(state["connectors"])

    def ping(self) -> str:
        return "pong"


def _on_card(config: PPOLearnerConfig) -> bool:
    return (config.device is None
            or torch.device(config.device).type == "cuda")


class _LearnerRank:
    """One rank of a remote learner group: it joins the group's process
    group through `parallel/dist.py` (when there is more than one rank),
    then holds a PPOLearner whose methods `call` reaches."""

    def __init__(self):
        self.learner: Optional[PPOLearner] = None

    def ping(self) -> str:
        return "pong"

    def address(self) -> str:
        return socket.gethostbyname(socket.gethostname())

    def free_port(self) -> int:
        with socket.socket() as s:
            s.bind(("", 0))
            return s.getsockname()[1]

    def setup(self, config, coordinator: Optional[str], rank: int,
              learner_cls: Optional[type] = None) -> int:
        if config.num_devices > 1:
            from ray_tpu_torch.parallel.dist import initialize_distributed
            device = None
            if _on_card(config):
                # the card the runtime pinned this learner's process to
                device = torch.device("cuda", torch.cuda.current_device())
                config = dataclasses.replace(config, device=str(device))
            initialize_distributed(
                coordinator, config.num_devices, rank,
                backend="nccl" if device is not None else "gloo",
                device=device)
        self.learner = (learner_cls or PPOLearner)(config)
        return rank

    def call(self, name: str, *args):
        return getattr(self.learner, name)(*args)


class LearnerGroup:
    """The learner scaling unit.

    The reference scales learners by adding DDP-wrapped GPU processes
    (learner_group.py:152-167, torch_learner.py:566). Here
    `num_learners=k` starts k learner actors, one rank each of one
    process group (gloo on the CPU, nccl on cards), whose updates sum
    their shards' gradients; rank 0's results are returned. A learner
    on the card asks the runtime for a `GPU`.

    num_learners=0 -> local learner in this process (reference local
    mode); `remote=True` hosts a single learner in an actor.
    `learner_cls` is the learner each rank holds (PPOLearner by default;
    IMPALA's group holds IMPALALearners).
    """

    def __init__(self, config, num_learners: int = 0,
                 num_cpus_per_learner: float = 1.0,
                 remote: Optional[bool] = None,
                 learner_cls: Optional[type] = None):
        learner_cls = learner_cls or PPOLearner
        if num_learners > 0:
            config = dataclasses.replace(config, num_devices=num_learners)
        self.config = config
        self._remote = (remote if remote is not None else num_learners > 0)
        self._local: Optional[PPOLearner] = None
        self._manager = None
        if not self._remote:
            self._local = learner_cls(config)
            return
        import ray_tpu_torch
        from ray_tpu_torch.rllib.actor_manager import FaultTolerantActorManager

        k = config.num_devices
        on_card = _on_card(config)
        if on_card:
            gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
            if gpus < k:
                raise ValueError(
                    f"{k} learner(s) on the card need {k} GPU(s); the "
                    f"cluster has {gpus} (pass device='cpu' for CPU "
                    f"learners)")
        remote_cls = ray_tpu_torch.remote(
            num_cpus=num_cpus_per_learner,
            num_gpus=1 if on_card else 0)(_LearnerRank)
        actors = [remote_cls.remote() for _ in range(k)]
        coordinator = None
        if k > 1:
            addr, port = ray_tpu_torch.get(
                [actors[0].address.remote(), actors[0].free_port.remote()])
            coordinator = f"{addr}:{port}"
        try:
            ranks = ray_tpu_torch.get(
                [a.setup.remote(config, coordinator, rank, learner_cls)
                 for rank, a in enumerate(actors)], timeout=300)
        except BaseException:
            for a in actors:
                ray_tpu_torch.kill(a)
            raise
        if ranks != list(range(k)):
            raise RuntimeError(f"learner ranks {ranks}, expected 0..{k - 1}")
        self._manager = FaultTolerantActorManager(actors)

    @property
    def is_local(self) -> bool:
        return self._local is not None

    def _call(self, name, *args):
        # every rank takes every call: the ranks step in lockstep
        results = self._manager.foreach_actor("call", args=(name,) + args)
        if results.num_errors or not results:
            raise RuntimeError(f"learner call {name} failed: "
                               f"{[r.error for r in results]}")
        return results[0].value

    def update(self, batch) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update(batch)
        return self._call("update", batch)

    def get_weights(self) -> Dict[str, torch.Tensor]:
        if self._local is not None:
            return self._local.get_weights()
        return self._call("get_weights")

    def set_weights(self, weights) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            self._call("set_weights", weights)

    def get_state(self):
        if self._local is not None:
            return self._local.get_state()
        return self._call("get_state")

    def set_state(self, state) -> None:
        if self._local is not None:
            self._local.set_state(state)
        else:
            self._call("set_state", state)

    def sgd_throughput(self) -> Dict[str, float]:
        if self._local is not None:
            return self._local.sgd_throughput()
        return self._call("sgd_throughput")

    def shutdown(self) -> None:
        if self._manager is not None:
            self._manager.clear()
