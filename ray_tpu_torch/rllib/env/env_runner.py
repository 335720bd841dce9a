"""Env runners: vectorized env sampling with a numpy policy.

Port of `ray_tpu/rllib/env/env_runner.py`. Parity: reference
rllib/env/single_agent_env_runner.py:63 (vector env :86, sample :133) —
on CPU, the policy step in numpy and the rollout returned as time-major
numpy arrays ready for the learner's PPO update. Handles gymnasium
>=1.0 next-step autoreset by masking the filler transition that follows
each episode end.

`EnvRunnerConfig.env` is a gymnasium id, made with
`gym.make_vec(..., vectorization_mode="sync")` as in the JAX package
(gymnasium is imported in `make_env` and nowhere else), or a callable
`env(num_envs)` that returns a vector env with gymnasium's vector API:
`reset(seed=)`, `step`, `close`, `single_action_space` and
`single_observation_space`, autoresetting on the step after an episode
ends.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import (ActorCriticModule,
                                                from_jax_params,
                                                to_numpy_params)


def make_env(env: Union[str, Callable[[int], Any]], num_envs: int):
    """The env seam of every runner: a callable `env(num_envs)` returns
    its own vector env; a gymnasium id is made with
    `gym.make_vec(..., vectorization_mode="sync")`, the one place the
    port imports gymnasium."""
    if callable(env):
        return env(num_envs)
    import gymnasium as gym
    return gym.make_vec(env, num_envs=num_envs, vectorization_mode="sync")


def env_spaces(env: Union[str, Callable[[int], Any]]) -> tuple:
    """(observation space, action space) of one env of `env`."""
    envs = make_env(env, 1)
    try:
        return envs.single_observation_space, envs.single_action_space
    finally:
        envs.close()


@dataclasses.dataclass
class EnvRunnerConfig:
    # a gymnasium id, or a callable num_envs -> vector env
    env: Union[str, Callable[[int], Any]] = "CartPole-v1"
    # ConnectorV2 pipelines (rllib/connectors.py): obs transforms run
    # before policy inference (and are what gets STORED, so the learner
    # sees the same inputs); action transforms run before env.step.
    # None = defaults (identity obs; Box-bound clipping for actions).
    env_to_module: Optional[list] = None
    module_to_env: Optional[list] = None
    # Wide-and-short default (32x32 rather than the GPU-classic 8x128):
    # each rollout step costs one policy call, so for cheap CPU envs
    # more parallel envs per step is strictly better.
    num_envs: int = 32
    rollout_length: int = 64
    hidden: Sequence[int] = (64, 64)
    seed: int = 0
    episode_metric_window: int = 100


class SingleAgentEnvRunner:
    """Owns a vector env + policy params; `sample()` one rollout."""

    @staticmethod
    def _f32(obs: np.ndarray) -> np.ndarray:
        """Integer (pixel) observations are scaled to [0,1] HERE, in
        numpy, keyed on the raw env dtype — downstream buffers and
        modules only ever see pre-scaled float32 (the module's own
        dtype-keyed /255 covers direct uint8 callers only)."""
        if np.issubdtype(obs.dtype, np.integer):
            return obs.astype(np.float32) / 255.0
        return obs.astype(np.float32)

    def __init__(self, config: EnvRunnerConfig, worker_index: int = 0):
        self.config = config
        self.worker_index = worker_index
        seed = config.seed + 1000 * worker_index
        self._envs = make_env(config.env, config.num_envs)
        act_space = self._envs.single_action_space
        self._continuous = not hasattr(act_space, "n")
        if self._continuous:
            self._act_dim = int(np.prod(act_space.shape))
            self._act_low = np.asarray(act_space.low, np.float32)
            self._act_high = np.asarray(act_space.high, np.float32)
        self._rng = np.random.default_rng(seed + 1)
        self._obs, _ = self._envs.reset(seed=seed)
        self._prev_done = np.zeros(config.num_envs, bool)
        self._ep_return = np.zeros(config.num_envs, np.float64)
        self._ep_len = np.zeros(config.num_envs, np.int64)
        from ray_tpu_torch.rllib.connectors import (ClipActions,
                                                     ConnectorPipeline)
        self._env_to_module = ConnectorPipeline(config.env_to_module)
        self._module_to_env = ConnectorPipeline(
            config.module_to_env if config.module_to_env is not None
            else [ClipActions()])
        # probe the pipeline with the real initial obs (counts once in
        # stateful connectors and is reused as the first sample step):
        # the MODULE is sized from the TRANSFORMED obs, which connectors
        # may reshape (FlattenObs, frame stacking, ...)
        self._proc_obs = self._env_to_module(self._f32(self._obs), self)
        obs_dim = int(np.prod(self._proc_obs.shape[1:]))
        gen = torch.Generator().manual_seed(seed)
        if self._continuous:
            self.module = ActorCriticModule(
                obs_dim, self._act_dim, tuple(config.hidden),
                continuous=True, generator=gen)
        else:
            self.module = ActorCriticModule(
                obs_dim, int(act_space.n), tuple(config.hidden),
                generator=gen)
        self.set_weights(self.module.state_dict())
        self._recent_returns: deque = deque(
            maxlen=config.episode_metric_window)
        self._recent_lens: deque = deque(
            maxlen=config.episode_metric_window)
        self._total_steps = 0

    # ------------------------------------------------------------ rpc
    def ping(self) -> str:
        return "pong"

    def apply(self, fn, *args, **kwargs):
        return fn(self, *args, **kwargs)

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return from_jax_params(self.module, self.params)

    def set_weights(self, weights) -> None:
        # Stored as host numpy in the (din, dout) layout: sampling
        # inference is numpy (see ActorCriticModule.forward_policy_np).
        self.params = to_numpy_params(self.module, weights)

    # --------------------------------------------------------- sample
    def sample(self, rollout_length: Optional[int] = None
               ) -> Dict[str, np.ndarray]:
        """Collect one time-major rollout batch.

        Returns obs (T+1, N, D) f32, actions (T, N) i32, logp/rewards/
        dones/mask (T, N) f32. mask is 0 on gymnasium next-step
        autoreset filler transitions (the env ignored our action and
        reset instead), which the learner excludes from GAE/losses.
        """
        T = rollout_length or self.config.rollout_length
        N = self.config.num_envs
        # each raw observation is transformed EXACTLY once: the rollout
        # boundary obs is cached so batch k's bootstrap row and batch
        # k+1's first row are the same array (stateful connectors like
        # NormalizeObs must not double-count it), and buffers take the
        # TRANSFORMED shape (connectors may reshape, e.g. FlattenObs).
        if self._proc_obs is None:
            self._proc_obs = self._env_to_module(self._f32(self._obs),
                                                 self)
        proc = self._proc_obs
        obs_buf = np.empty((T + 1, N) + proc.shape[1:], np.float32)
        act_buf = (np.empty((T, N, self._act_dim), np.float32)
                   if self._continuous else np.empty((T, N), np.int32))
        logp_buf = np.empty((T, N), np.float32)
        rew_buf = np.empty((T, N), np.float32)
        term_buf = np.empty((T, N), np.float32)
        done_buf = np.empty((T, N), np.float32)
        mask_buf = np.empty((T, N), np.float32)

        for t in range(T):
            obs_buf[t] = proc
            logits = self.module.forward_policy_np(self.params, proc)
            action, logp = self.module.sample_np(logits, self._rng,
                                                 self.params)
            # learner sees the RAW action (its logp is exact); the env
            # gets the connector-transformed one (clipping by default)
            env_action = self._module_to_env(action, self)
            nobs, reward, term, trunc, _ = self._envs.step(env_action)
            done = np.logical_or(term, trunc)
            act_buf[t] = action
            logp_buf[t] = np.asarray(logp)
            rew_buf[t] = reward
            # terminated zeroes the bootstrap; truncation does NOT — the
            # obs gymnasium returns at the truncating step is the true
            # final observation, so V(obs_{t+1}) is the right bootstrap.
            term_buf[t] = term.astype(np.float32)
            done_buf[t] = done.astype(np.float32)
            # Transition t is filler if the env was resetting (episode
            # ended at t-1): obs_buf[t] is the dead episode's final obs
            # and the env ignored action[t].
            mask_buf[t] = (~self._prev_done).astype(np.float32)
            valid = ~self._prev_done
            self._ep_return[valid] += reward[valid]
            self._ep_len[valid] += 1
            for i in np.nonzero(done & valid)[0]:
                self._recent_returns.append(float(self._ep_return[i]))
                self._recent_lens.append(int(self._ep_len[i]))
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
            self._prev_done = done
            self._obs = nobs
            proc = self._env_to_module(self._f32(nobs), self)
        obs_buf[T] = proc
        self._proc_obs = proc
        self._total_steps += int(mask_buf.sum())
        return {"obs": obs_buf, "actions": act_buf, "logp": logp_buf,
                "rewards": rew_buf, "terminateds": term_buf,
                "dones": done_buf, "mask": mask_buf}

    # -------------------------------------------------------- metrics
    def get_metrics(self) -> Dict[str, Any]:
        returns = list(self._recent_returns)
        return {
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else float("nan")),
            "episode_len_mean": (float(np.mean(self._recent_lens))
                                 if self._recent_lens else float("nan")),
            "num_episodes": len(returns),
            "num_env_steps_sampled": self._total_steps,
        }

    def get_state(self) -> Dict[str, Any]:
        return {"weights": self.get_weights(),
                "connectors": {
                    "env_to_module": self._env_to_module.get_state(),
                    "module_to_env": self._module_to_env.get_state()}}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        conn = state.get("connectors") or {}
        self._env_to_module.set_state(conn.get("env_to_module", {}))
        self._module_to_env.set_state(conn.get("module_to_env", {}))

    def stop(self) -> None:
        self._envs.close()
