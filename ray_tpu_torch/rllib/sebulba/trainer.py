"""Sebulba orchestration: config + trainer wiring the split together
(r20).

Port of `ray_tpu/rllib/sebulba/trainer.py`, over the port's runtime.
The learner runs on its device (`device`: None = the card, "cpu" only
by name); the env is a gymnasium id or a callable `env(num_envs)`;
`module_factory` (optional) is handed to every inference actor, e.g.
`functools.partial(TorchPolicy, obs_dim, num_actions, device="cuda")`
to run their forwards on a card.

Topology per `SebulbaConfig`: N env-runner actors act against M
inference actors over the direct call plane and stream trajectory
shards into per-runner wire-channel rings; ONE learner (driver-side)
round-robins the rings, V-trace-updates on each shard, and publishes
refreshed weights on a version clock: `ray_tpu_torch.put` once,
broadcast-tree fanout to the hosting nodes, then a versioned
`set_weights` per inference actor (stale versions dropped actor-side,
dead actors tolerated — their runners fail over on the next act()).

`local=True` swaps every actor for an in-process object with the same
surface — the full data path (admission batching, rings, staleness,
failover) runs in one process in tier-1 test time; only put/broadcast
are skipped.

Checkpoint/restore rides ray_tpu_torch.train.Checkpoint: restore force-publishes the restored version so inference
actors that saw newer pre-crash weights are fenced back onto the
restored line.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.rllib.algorithms.impala import IMPALALearnerConfig
from ray_tpu_torch.rllib.env.env_runner import env_spaces
from ray_tpu_torch.rllib.sebulba.env_runner import (SebulbaEnvRunner,
                                                    SebulbaRunnerConfig)
from ray_tpu_torch.rllib.sebulba.inference import InferenceActor
from ray_tpu_torch.rllib.sebulba.learner import SebulbaLearner
from ray_tpu_torch.rllib.sebulba.stats import RL_STATS


@dataclasses.dataclass
class SebulbaConfig:
    # a gymnasium id, or a callable num_envs -> vector env
    env: Union[str, Callable[[int], Any]] = "CartPole-v1"
    # --- topology
    num_env_runners: int = 4
    num_inference_actors: int = 2
    num_envs_per_runner: int = 8
    rollout_length: int = 16
    local: bool = False              # in-process objects, no cluster
    # --- model / training (IMPALA V-trace)
    hidden: Sequence[int] = (64, 64)
    lr: float = 6e-4
    gamma: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 40.0
    num_updates_per_iteration: int = 8
    num_devices: int = 1             # learner ranks (process group)
    seed: int = 0
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None
    # each inference actor's module (None: the numpy MLP)
    module_factory: Optional[Callable[[], Any]] = None
    # --- plumbing
    ring_depth: Optional[int] = None       # None -> CONFIG.rl_ring_depth
    publish_interval: Optional[int] = None  # None -> CONFIG.rl_publish_interval
    broadcast_weights: bool = True         # tree fanout before set_weights
    read_timeout_s: float = 120.0          # no shard anywhere -> error
    act_timeout_s: float = 30.0
    infer_max_concurrency: int = 16
    # actor placement/options passed straight to ray_tpu_torch.remote(...)
    inference_options: Optional[Dict[str, Any]] = None
    runner_options: Optional[Dict[str, Any]] = None

    def build(self) -> "Sebulba":
        return Sebulba(self)


class Sebulba:
    """The actor/learner-split trainer."""

    def __init__(self, config: SebulbaConfig):
        if config.num_env_runners < 1 or config.num_inference_actors < 1:
            raise ValueError("need >=1 env runner and inference actor")
        self.config = config
        self._probe_env()
        self.learner = SebulbaLearner(IMPALALearnerConfig(
            obs_dim=self._obs_dim, num_actions=self._num_actions,
            hidden=tuple(config.hidden), lr=config.lr,
            gamma=config.gamma, vtrace_rho_clip=config.vtrace_rho_clip,
            vtrace_c_clip=config.vtrace_c_clip, vf_coef=config.vf_coef,
            ent_coef=config.ent_coef,
            max_grad_norm=config.max_grad_norm,
            num_devices=config.num_devices, seed=config.seed,
            device=config.device))
        self._publish_interval = (
            config.publish_interval if config.publish_interval is not None
            else CONFIG.rl_publish_interval)
        self.iteration = 0
        self._t_started = time.perf_counter()
        self._build_fleet()
        # version 0 everywhere before the first rollout: actors boot at
        # version -1 (factory weights), so the initial publish applies
        self._publish()
        self._start_runners()
        self._readers = self._dial_rings()
        self._rr = 0

    # ----------------------------------------------------------- setup
    def _probe_env(self) -> None:
        obs_space, space = env_spaces(self.config.env)
        self._obs_dim = int(np.prod(obs_space.shape))
        self._num_actions = int(space.n)

    def _runner_config(self) -> SebulbaRunnerConfig:
        c = self.config
        return SebulbaRunnerConfig(
            env=c.env, num_envs=c.num_envs_per_runner,
            rollout_length=c.rollout_length, ring_depth=c.ring_depth,
            seed=c.seed, act_timeout_s=c.act_timeout_s)

    def _build_fleet(self) -> None:
        c = self.config
        if c.local:
            self._infer = [
                InferenceActor(self._obs_dim, self._num_actions,
                               tuple(c.hidden), seed=c.seed + i,
                               module_factory=c.module_factory)
                for i in range(c.num_inference_actors)]
            rc = self._runner_config()
            self._runners = [
                SebulbaEnvRunner(rc, i, self._infer)
                for i in range(c.num_env_runners)]
            return
        import ray_tpu_torch
        iopts = dict(c.inference_options or {})
        iopts.setdefault("num_cpus", 1)
        iopts.setdefault("max_concurrency", c.infer_max_concurrency)
        InferCls = ray_tpu_torch.remote(**iopts)(InferenceActor)
        self._infer = [
            InferCls.remote(self._obs_dim, self._num_actions,
                            tuple(c.hidden), seed=c.seed + i,
                            module_factory=c.module_factory)
            for i in range(c.num_inference_actors)]
        ray_tpu_torch.get([h.ping.remote() for h in self._infer])
        ropts = dict(c.runner_options or {})
        ropts.setdefault("num_cpus", 1)
        RunnerCls = ray_tpu_torch.remote(**ropts)(SebulbaEnvRunner)
        rc = self._runner_config()
        # runner i's primary is handle i % M; failover rotates from there
        self._runners = [
            RunnerCls.remote(rc, i, self._infer)
            for i in range(c.num_env_runners)]
        ray_tpu_torch.get([r.ping.remote() for r in self._runners])

    def _start_runners(self) -> None:
        if self.config.local:
            for r in self._runners:
                r.start()
            return
        import ray_tpu_torch
        ray_tpu_torch.get([r.start.remote() for r in self._runners])

    def _dial_rings(self) -> List[Any]:
        if self.config.local:
            chans = [r.channel() for r in self._runners]
        else:
            import ray_tpu_torch
            chans = ray_tpu_torch.get(
                [r.channel.remote() for r in self._runners])
        return [ch.reader(0) for ch in chans]

    # --------------------------------------------------------- publish
    def _publish(self, force: bool = False) -> None:
        """put-once + broadcast-tree fanout + versioned set_weights."""
        weights = self.learner.get_weights()
        version = self.learner.version
        RL_STATS["weight_publishes"] += 1
        if self.config.local:
            for h in self._infer:
                h.set_weights(weights, version, force=force)
            return
        import ray_tpu_torch
        ref = ray_tpu_torch.put(weights)
        if self.config.broadcast_weights:
            try:
                ray_tpu_torch.broadcast(ref, timeout=10.0)
            except Exception:
                pass           # fanout is an optimization, not a gate
        futs = [h.set_weights.remote(ref, version, force=force)
                for h in self._infer]
        for f in futs:
            try:
                ray_tpu_torch.get(f, timeout=10.0)
            except Exception:
                pass           # dead actor: its runners fail over

    # ---------------------------------------------------------- shards
    def _next_shard(self) -> Dict[str, Any]:
        """Round-robin the rings; a closed ring (dead runner) is
        dropped, an empty one is skipped — the learner never blocks on
        one slow producer."""
        from ray_tpu_torch.experimental.channel import (ChannelClosed,
                                                        ChannelTimeout)
        deadline = time.monotonic() + self.config.read_timeout_s
        while True:
            live = [r for r in self._readers if r is not None]
            if not live:
                raise RuntimeError("sebulba: every trajectory ring "
                                   "closed — all env runners gone")
            for _ in range(len(self._readers)):
                i = self._rr % len(self._readers)
                self._rr += 1
                rd = self._readers[i]
                if rd is None:
                    continue
                try:
                    return rd.read(timeout=0.25)
                except ChannelTimeout:
                    continue
                except ChannelClosed:
                    self._readers[i] = None
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"sebulba: no trajectory shard in "
                    f"{self.config.read_timeout_s}s")

    # ------------------------------------------------------------- api
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        learner_metrics: Dict[str, float] = {}
        for _ in range(self.config.num_updates_per_iteration):
            shard = self._next_shard()
            learner_metrics = self.learner.update_shard(shard)
            if self.learner.version % self._publish_interval == 0:
                self._publish()
        self.iteration += 1
        wall = time.perf_counter() - self._t_started
        metrics = dict(learner_metrics)
        metrics.update(self.learner.staleness_quantiles())
        metrics.update({
            "training_iteration": self.iteration,
            "num_learner_updates": self.learner.version,
            "shards_consumed": self.learner.shards_consumed,
            "env_steps_consumed": self.learner.steps_consumed,
            "env_steps_per_s": self.learner.steps_consumed / max(wall, 1e-9),
            "seq_gaps": self.learner.seq_gaps,
            "time_iteration_s": time.perf_counter() - t0,
        })
        return metrics

    def fit(self, num_iterations: int,
            checkpoint_dir: Optional[str] = None) -> Dict[str, Any]:
        metrics: Dict[str, Any] = {}
        for _ in range(num_iterations):
            metrics = self.train()
            if checkpoint_dir is not None:
                self.save_checkpoint(checkpoint_dir)
        return metrics

    # ------------------------------------------------------ checkpoint
    def get_state(self) -> Dict[str, Any]:
        state = self.learner.get_state()
        return {"params": state["params"],
                "opt_state": state["opt_state"],
                "version": self.learner.version,
                "iteration": self.iteration}

    def save_checkpoint(self, path: str):
        from ray_tpu_torch.train.checkpoint import Checkpoint
        return Checkpoint.from_state(path, self.get_state())

    def restore_from_checkpoint(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import Checkpoint
        state = Checkpoint.from_directory(path).load_state()
        self.learner.set_state({"params": state["params"],
                                "opt_state": state["opt_state"],
                                "version": int(state["version"])})
        self.iteration = int(state.get("iteration", 0))
        # fence: actors that saw newer pre-crash versions must rejoin
        # the restored line, so this publish overrides monotonicity
        self._publish(force=True)

    # ------------------------------------------------------------ stop
    def stop(self) -> None:
        if self.config.local:
            for r in self._runners:
                try:
                    r.stop()
                except Exception:
                    pass
            for h in self._infer:
                try:
                    h.close()
                except Exception:
                    pass
        else:
            import ray_tpu_torch
            for r in self._runners:
                try:
                    ray_tpu_torch.get(r.stop.remote(), timeout=10.0)
                except Exception:
                    pass
            for h in list(self._infer) + list(self._runners):
                try:
                    ray_tpu_torch.kill(h)
                except Exception:
                    pass
        for rd in self._readers:
            if rd is not None:
                try:
                    rd.release()
                except Exception:
                    pass
