"""PPO: GAE + clipped-surrogate on the new-stack component layout.

Port of `ray_tpu/rllib/algorithms/ppo.py`. Parity: reference
rllib/algorithms/ppo/ppo.py:411 (training_step :420-489 —
synchronous_parallel_sample over the EnvRunnerGroup, then
learner_group.update, then weight sync) and algorithm_config.py's
builder pattern: one learner update per iteration on the learner's
device (the card unless `device="cpu"`), CPU env-runner actors, weights
fanned out through the object store. `env` is a gymnasium id or a
callable `env(num_envs)` returning a vector env (see
`env/env_runner.py`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np

from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup, PPOLearnerConfig
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerConfig, env_spaces
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup


@dataclasses.dataclass
class PPOConfig(AlgorithmConfig):
    env: Union[str, Callable[[int], Any]] = "CartPole-v1"
    # --- rollouts
    num_env_runners: int = 0           # 0 = local in-process runner
    num_envs_per_env_runner: int = 32
    rollout_length: int = 64
    # --- model
    hidden: Sequence[int] = (64, 64)
    # --- training
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    vf_clip: float = 10.0
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    num_epochs: int = 4
    num_minibatches: int = 8
    target_kl: float = 0.05
    num_learners: int = 0              # 0 = local in-process learner
    seed: int = 0
    # learner-side connector pipeline (reference rllib/connectors/
    # learner/): e.g. [GeneralAdvantageEstimation(...),
    # StandardizeAdvantages()] moves GAE out of the update into a
    # composable host-side pipeline
    learner_connectors: Optional[Sequence] = None
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None


class PPO:
    """Iterative trainer: each `train()` = sample -> update -> sync."""

    def __init__(self, config: PPOConfig):
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
        self.learner_group = LearnerGroup(
            PPOLearnerConfig(
                obs_dim=self._obs_dim, num_actions=self._num_actions,
                hidden=tuple(config.hidden), lr=config.lr,
                gamma=config.gamma, gae_lambda=config.gae_lambda,
                clip_eps=config.clip_eps, vf_coef=config.vf_coef,
                vf_clip=config.vf_clip, ent_coef=config.ent_coef,
                max_grad_norm=config.max_grad_norm,
                num_epochs=config.num_epochs,
                num_minibatches=config.num_minibatches,
                target_kl=config.target_kl,
                continuous=self._continuous,
                seed=config.seed,
                learner_connectors=config.learner_connectors,
                device=config.device),
            num_learners=config.num_learners)
        self.iteration = 0
        self._total_env_steps = 0
        # Runners start from the learner's weights.
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def _probe_env(self) -> None:
        obs_space, space = env_spaces(self.config.env)
        self._obs_dim = int(np.prod(obs_space.shape))
        self._continuous = not hasattr(space, "n")
        self._num_actions = (int(np.prod(space.shape))
                             if self._continuous else int(space.n))

    # ------------------------------------------------------------ api
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        batches = self.env_runner_group.sample()
        t_sample = time.perf_counter() - t0
        # Concatenate runner batches on the env axis (all time-major).
        batch = {k: np.concatenate([b[k] for b in batches], axis=1)
                 for k in batches[0]}
        t1 = time.perf_counter()
        learner_metrics = self.learner_group.update(batch)
        t_update = time.perf_counter() - t1
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights())
        self.env_runner_group.probe_unhealthy_env_runners()
        self.iteration += 1
        self._total_env_steps += int(batch["mask"].sum())
        metrics = self.env_runner_group.aggregate_metrics()
        metrics.update(learner_metrics)
        metrics.update(self.learner_group.sgd_throughput())
        metrics.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "time_sample_s": t_sample,
            "time_update_s": t_update,
            "env_steps_per_s": batch["mask"].sum() / max(
                time.perf_counter() - t0, 1e-9),
        })
        return metrics

    def get_state(self) -> Dict[str, Any]:
        return {"learner": self.learner_group.get_state(),
                "iteration": self.iteration,
                "total_env_steps": self._total_env_steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner_group.set_state(state["learner"])
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("total_env_steps", 0)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights())

    def stop(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.shutdown()


PPOConfig.algo_class = PPO
