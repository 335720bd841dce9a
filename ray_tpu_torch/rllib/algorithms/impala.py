"""IMPALA: asynchronous sampling + V-trace off-policy correction.

Port of `ray_tpu/rllib/algorithms/impala.py`. Parity: reference
rllib/algorithms/impala/impala.py (async env-runner sampling and queued
learner consumption, :580-611) and the V-trace returns of the IMPALA
paper (Espeholt et al. 2018): the driver runs one event loop that (a)
keeps every env-runner actor perpetually sampling through
`foreach_actor_async`, (b) feeds a bounded sample queue, and (c) drains
the queue into V-trace updates on the learner's device (the card unless
`device="cpu"`). Runners act on stale weights by design; rho/c clipping
corrects the off-policy gap. Weights fan out per-runner right before
each resubmission, so a slow runner never blocks a fast one.

The JAX update is one jitted program; here it is one loss, one backward
and one optimizer step on tensors, with one host read of the metrics:
- `vtrace_returns`' reverse `lax.scan` is a backward loop over T;
- the optimizer is optax's `clip_by_global_norm` written out, then
  `torch.optim.Adam(eps=1e-5)`;
- data parallelism (`num_devices=k`) is a process group of k ranks
  (`LearnerGroup(..., learner_cls=IMPALALearner)` forms one). Every rank
  takes its share of the batch's N columns; the loss divides by the
  whole batch's mask count and gradients and metrics are all-reduced by
  SUM. V-trace runs per column, so the split is exact; DDP's average
  would weigh the shards' steps unequally whenever their masks differ.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (LearnerGroup, _host,
                                              allreduce_sum,
                                              clip_by_global_norm_, descend,
                                              dp_world)
from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule, Categorical
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerConfig, env_spaces
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup

_BATCH_KEYS = ("obs", "actions", "logp", "rewards", "terminateds",
               "dones", "mask")


@dataclasses.dataclass
class IMPALAConfig(AlgorithmConfig):
    # a gymnasium id, or a callable num_envs -> vector env
    env: Union[str, Callable[[int], Any]] = "CartPole-v1"
    # --- rollouts (async: runners resample as soon as they finish)
    num_env_runners: int = 2
    num_envs_per_env_runner: int = 16
    rollout_length: int = 32
    # --- model
    hidden: Sequence[int] = (64, 64)
    # --- training
    lr: float = 6e-4
    gamma: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 40.0
    # updates per train() call and queue bound (batches, not bytes)
    num_updates_per_iteration: int = 8
    sample_queue_size: int = 4
    broadcast_interval: int = 1   # push weights every k-th resubmission
    num_devices: int = 1          # learner ranks (see LearnerGroup)
    seed: int = 0
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None

    def env_runners(self, **kw) -> "IMPALAConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown env_runners option {k!r}")
            setattr(self, k, v)
        return self

    def training(self, **kw) -> "IMPALAConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown IMPALA training option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "IMPALA":
        # the bound class: APPOConfig builds APPO (the JAX override
        # returns IMPALA for both)
        return self.algo_class(self)


def vtrace_returns(values, rewards, terms, dones, behaviour_logp,
                   target_logp, gamma, rho_clip, c_clip):
    """V-trace targets vs_t and policy-gradient advantages (no grads).

    values (T+1, N) — bootstrap value included; everything else (T, N).
    Returns (vs (T, N), pg_adv (T, N), rho_clipped (T, N)).
    """
    rho = torch.exp(target_logp - behaviour_logp)
    rho_cl = torch.clamp(rho, max=rho_clip)
    c = torch.clamp(rho, max=c_clip)
    not_term = 1.0 - terms          # termination cuts the bootstrap
    not_done = 1.0 - dones          # any episode end cuts the recursion
    delta = rho_cl * (rewards + gamma * not_term * values[1:]
                      - values[:-1])
    ws = torch.empty_like(delta)
    carry = torch.zeros_like(values[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        carry = delta[t] + gamma * not_done[t] * c[t] * carry
        ws[t] = carry
    vs = values[:-1] + ws
    # vs_{t+1} with the true bootstrap at the end of the fragment
    vs_tp1 = torch.cat([vs[1:], values[-1:]], dim=0)
    vs_tp1 = not_done * vs_tp1 + (1.0 - not_done) * values[1:]
    pg_adv = rho_cl * (rewards + gamma * not_term * vs_tp1 - values[:-1])
    return vs, pg_adv, rho_cl


@dataclasses.dataclass
class IMPALALearnerConfig:
    obs_dim: int = 0
    num_actions: int = 0
    hidden: Sequence[int] = (64, 64)
    lr: float = 6e-4
    gamma: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 40.0
    num_devices: int = 1
    seed: int = 0
    # None = the card (raises where there is none); "cpu" only by name
    device: Optional[str] = None


class IMPALALearner:
    """The V-trace update on the learner's device."""

    METRICS = ("policy_loss", "vf_loss", "entropy", "mean_rho")

    def __init__(self, config: IMPALALearnerConfig):
        self.config = config
        self.device = resolve_device(config.device)
        init_seed = int(np.random.SeedSequence(config.seed)
                        .generate_state(1)[0])
        # drawn on the CPU, then moved: every device starts alike
        self.module = ActorCriticModule(
            config.obs_dim, config.num_actions, tuple(config.hidden),
            generator=torch.Generator().manual_seed(init_seed))
        self.module.to(self.device)
        self._opt = torch.optim.Adam(self.module.parameters(),
                                     lr=config.lr, eps=1e-5)
        self._world, self._rank = dp_world(config.num_devices)
        self.version = 0
        self._timer = {"updates": 0, "update_time": 0.0, "transitions": 0}

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    # ---------------------------------------------------------- update
    def _vtrace_terms(self, b):
        """Logits, values, log-probs of the taken actions, and the
        V-trace targets, advantages and clipped rhos of batch `b`."""
        c = self.config
        logits, value = self.module(b["obs"])
        logits = logits[:-1]                       # (T, N, A)
        logp = Categorical.log_prob(logits, b["actions"])
        vs, pg_adv, rho = vtrace_returns(
            value.detach(), b["rewards"], b["terminateds"], b["dones"],
            b["logp"], logp.detach(), c.gamma, c.vtrace_rho_clip,
            c.vtrace_c_clip)
        return logits, value, logp, vs, pg_adv, rho

    def _loss(self, b, denom):
        c = self.config
        logits, value, logp, vs, pg_adv, rho = self._vtrace_terms(b)
        m = b["mask"]
        pg_loss = -(logp * pg_adv * m).sum() / denom
        v_loss = 0.5 * ((vs - value[:-1]).square() * m).sum() / denom
        ent = (Categorical.entropy(logits) * m).sum() / denom
        total = pg_loss + c.vf_coef * v_loss - c.ent_coef * ent
        mean_rho = (rho * m).sum() / denom
        return total, torch.stack([pg_loss, v_loss, ent, mean_rho]).detach()

    def _step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One update on `batch`; this rank's share of its columns when
        the learner is one of a group."""
        dev = self.device
        b = {k: torch.as_tensor(batch[k], device=dev) for k in _BATCH_KEYS}
        denom = b["mask"].sum().clamp_min(1.0)
        if self._world > 1:
            b = {k: v.tensor_split(self._world, dim=1)[self._rank]
                 for k, v in b.items()}
        params = list(self.module.parameters())
        total, metrics = self._loss(b, denom)
        grads = list(torch.autograd.grad(total, params))
        if self._world > 1:
            *grads, metrics = allreduce_sum(grads + [metrics])
        clip_by_global_norm_(grads, self.config.max_grad_norm)
        descend(self._opt, params, grads)
        return dict(zip(self.METRICS, metrics.tolist()))

    # ------------------------------------------------------------- api
    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        t0 = time.perf_counter()
        metrics = self._step(batch)
        dt = time.perf_counter() - t0
        self.version += 1
        self._timer["updates"] += 1
        self._timer["update_time"] += dt
        self._timer["transitions"] += int(np.prod(np.shape(
            batch["rewards"])))
        metrics["update_time_s"] = dt
        return metrics

    def sgd_throughput(self) -> Dict[str, float]:
        t = max(self._timer["update_time"], 1e-9)
        return {"learner_transitions_per_s": self._timer["transitions"] / t,
                "updates_per_s": self._timer["updates"] / t}

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """The module's state dict, copied to the host."""
        return _host(self.module.state_dict())

    def set_weights(self, weights) -> None:
        self.module.load_state_dict(
            {k: torch.as_tensor(v) for k, v in weights.items()})

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.get_weights(),
                "opt_state": _host(self._opt.state_dict()),
                "version": self.version}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["params"])
        self._opt.load_state_dict(state["opt_state"])
        self.version = int(state.get("version", self.version))

    def get_version(self) -> int:
        return self.version

    def ping(self) -> str:
        return "pong"


class _LearnerGroupClient:
    """A learner group of `num_devices` ranks behind the learner surface
    IMPALA reads (update, version, weights, state, throughput)."""

    def __init__(self, learner_cls, config):
        self._group = LearnerGroup(config, num_learners=config.num_devices,
                                   learner_cls=learner_cls)
        self.version = 0

    def update(self, batch):
        metrics = self._group.update(batch)
        self.version = self._group._call("get_version")
        return metrics

    def get_weights(self):
        return self._group.get_weights()

    def get_state(self):
        return self._group.get_state()

    def set_state(self, state):
        self._group.set_state(state)
        self.version = self._group._call("get_version")

    def sgd_throughput(self):
        return self._group.sgd_throughput()

    def shutdown(self):
        self._group.shutdown()


class IMPALA:
    """Asynchronous trainer: runners sample continuously; each `train()`
    performs `num_updates_per_iteration` V-trace updates off the queue."""

    def __init__(self, config: IMPALAConfig):
        if config.num_env_runners < 1:
            raise ValueError("IMPALA is asynchronous: needs >=1 remote "
                             "env runner (use PPO for local debugging)")
        self.config = config
        self._probe_env()
        self.env_runner_group = EnvRunnerGroup(
            EnvRunnerConfig(
                env=config.env,
                num_envs=config.num_envs_per_env_runner,
                rollout_length=config.rollout_length,
                hidden=tuple(config.hidden),
                seed=config.seed),
            num_env_runners=config.num_env_runners)
        self.learner = self._make_learner()
        self._queue: deque = deque(maxlen=config.sample_queue_size)
        self._mgr = self.env_runner_group.manager
        self._runner_version: Dict[int, int] = {}
        self._resubmits: Dict[int, int] = {}
        self.iteration = 0
        self._total_env_steps = 0
        self._dropped_batches = 0
        self._broadcast_count = 0
        self._last_restore_probe = 0.0
        # prime the pipeline: everyone gets weights and starts sampling
        self.env_runner_group.sync_weights(self.learner.get_weights())
        for aid in self._mgr.healthy_actor_ids():
            self._runner_version[aid] = 0
            self._resubmits[aid] = 0
        self._mgr.foreach_actor_async("sample", tag="s")

    LEARNER_CLS = IMPALALearner
    LEARNER_CONFIG_CLS = IMPALALearnerConfig

    def _make_learner(self):
        """Factory hook: learner-config fields mirror algorithm-config
        fields by name (APPO only swaps the two classes). More than one
        device makes a learner group of that many ranks."""
        kw = {f.name: getattr(self.config, f.name)
              for f in dataclasses.fields(self.LEARNER_CONFIG_CLS)
              if hasattr(self.config, f.name)}
        kw.update(obs_dim=self._obs_dim,
                  num_actions=self._num_actions,
                  hidden=tuple(self.config.hidden))
        config = self.LEARNER_CONFIG_CLS(**kw)
        if config.num_devices > 1:
            return _LearnerGroupClient(self.LEARNER_CLS, config)
        return self.LEARNER_CLS(config)

    def _probe_env(self) -> None:
        obs_space, space = env_spaces(self.config.env)
        self._obs_dim = int(np.prod(obs_space.shape))
        self._num_actions = int(space.n)

    # ---------------------------------------------------------- async
    def _pump(self, timeout: float = 0.0) -> None:
        """Collect finished rollouts into the queue, then keep every
        healthy runner saturated: push fresh weights (actor-call
        ordering guarantees they apply before the next rollout) and
        re-submit `sample` to any runner with nothing in flight."""
        import ray_tpu_torch
        # Dead-runner recovery must not depend on the queue running
        # dry (a healthy majority can keep it fed forever): probe
        # unhealthy actors on a 1s cadence from the pump itself.
        if (self._mgr.num_healthy_actors < self._mgr.num_actors
                and time.time() - self._last_restore_probe > 1.0):
            self._last_restore_probe = time.time()
            self._restore_runners()
        results = self._mgr.fetch_ready_async_reqs(
            timeout_seconds=timeout, tags=["s"])
        for r in results:
            if r.ok:
                if len(self._queue) == self._queue.maxlen:
                    self._dropped_batches += 1
                self._queue.append(r.value)
        # drain completed weight-push acks so they don't pin in-flight
        self._mgr.fetch_ready_async_reqs(timeout_seconds=0.0, tags=["w"])
        weights_ref = None
        for aid in self._mgr.healthy_actor_ids():
            if self._mgr.num_in_flight(aid, tag="s") > 0:
                continue
            self._resubmits[aid] = self._resubmits.get(aid, 0) + 1
            if (self._runner_version.get(aid, -1) < self.learner.version
                    and self._resubmits[aid]
                    % self.config.broadcast_interval == 0):
                if weights_ref is None:
                    weights_ref = ray_tpu_torch.put(
                        self.learner.get_weights())
                n = self._mgr.foreach_actor_async(
                    "set_weights", args=(weights_ref,),
                    remote_actor_ids=[aid], tag="w")
                if n:        # skipped at in-flight cap -> retry next pump
                    self._runner_version[aid] = self.learner.version
                    self._broadcast_count += 1
            self._mgr.foreach_actor_async("sample", remote_actor_ids=[aid],
                                          tag="s")

    def _restore_runners(self) -> None:
        restored = self.env_runner_group.probe_unhealthy_env_runners()
        for aid in restored:
            self._runner_version[aid] = -1   # full weight push next pump

    # ------------------------------------------------------------ api
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        updates = 0
        learner_metrics: Dict[str, float] = {}
        # stall = 120s WITHOUT A SAMPLE, not 120s of train() wall time:
        # reset whenever the pump delivers, so long legitimate
        # iterations never trip it.
        stall_deadline = time.time() + 120.0
        while updates < self.config.num_updates_per_iteration:
            if not self._queue:
                self._pump(timeout=0.02)
                if not self._queue:
                    if time.time() > stall_deadline:
                        raise TimeoutError(
                            "IMPALA: no samples for 120s — all env "
                            "runners dead?")
                    self._restore_runners()
                    continue
                stall_deadline = time.time() + 120.0
            self._pump(timeout=0.0)      # opportunistic, non-blocking
            batch = self._queue.popleft()
            stall_deadline = time.time() + 120.0
            learner_metrics = self.learner.update(batch)
            self._total_env_steps += int(batch["mask"].sum())
            updates += 1
        self.iteration += 1
        metrics = self.env_runner_group.aggregate_metrics()
        metrics.update(learner_metrics)
        metrics.update(self.learner.sgd_throughput())
        metrics.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "num_learner_updates": self.learner.version,
            "num_weight_broadcasts": self._broadcast_count,
            "sample_queue_len": len(self._queue),
            "dropped_batches_lifetime": self._dropped_batches,
            "time_iteration_s": time.perf_counter() - t0,
        })
        return metrics

    def get_state(self) -> Dict[str, Any]:
        """The learner's state (params, opt_state, version; APPO's also
        its target network) and the trainer's counters."""
        return {**self.learner.get_state(),
                "iteration": self.iteration,
                "total_env_steps": self._total_env_steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner.set_state(state)
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("total_env_steps", 0)
        self.env_runner_group.sync_weights(self.learner.get_weights())

    def stop(self) -> None:
        self.env_runner_group.stop()
        if isinstance(self.learner, _LearnerGroupClient):
            self.learner.shutdown()


IMPALAConfig.algo_class = IMPALA
