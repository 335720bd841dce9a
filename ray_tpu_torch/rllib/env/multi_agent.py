"""Multi-agent environments, runner, and PPO trainer.

Parity: reference rllib/env/multi_agent_env.py (dict-keyed MultiAgentEnv
API with "__all__" termination), rllib/env/multi_agent_env_runner.py
(sampling with per-agent -> policy routing), and the multi-policy wiring
of MultiRLModule / policy_mapping_fn — re-designed for this stack:

- a MultiAgentEnv steps ALL live agents each tick with dict obs/action
  payloads (simultaneous-move subset: agents share the episode clock,
  which covers the reference's matrix-game / co-existing-agents tests);
- MultiAgentEnvRunner vectorizes E env copies, routes each (env, agent)
  column to its policy via policy_mapping_fn, and emits ONE time-major
  single-agent-format batch PER POLICY, so the unchanged PPOLearner
  trains each policy;
- MultiAgentPPO runs one PPOLearner per policy over those batches.

Port of `ray_tpu/rllib/env/multi_agent.py`: each policy's learner runs
on the configured device (the card unless `device="cpu"`), and its
initial weights and seed still come from `zlib.crc32` of the policy id.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import (ActorCriticModule,
                                                to_numpy_params)


class MultiAgentEnv:
    """Dict-keyed environment (reference rllib/env/multi_agent_env.py).

    Subclasses define `agents` (ids stable for the episode), and
    reset/step with per-agent dicts; step's terminated/truncated dicts
    carry the special "__all__" key ending the episode for everyone.
    """

    agents: Sequence[str] = ()

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        """-> (obs, rewards, terminateds, truncateds, infos) dicts;
        terminateds/truncateds include "__all__"."""
        raise NotImplementedError

    def close(self) -> None:
        pass


@dataclasses.dataclass
class PolicySpec:
    """Per-policy module shape (reference PolicySpec)."""
    obs_dim: int
    num_actions: int
    continuous: bool = False
    hidden: Sequence[int] = (64, 64)


@dataclasses.dataclass
class MultiAgentEnvRunnerConfig:
    env_fn: Callable[[], MultiAgentEnv] = None
    policies: Dict[str, PolicySpec] = None
    policy_mapping_fn: Callable[[str], str] = None
    num_envs: int = 8
    rollout_length: int = 64
    seed: int = 0


class MultiAgentEnvRunner:
    """Vectorized multi-agent sampler: E env copies; each (env, agent)
    pair is one batch column of the agent's policy."""

    def __init__(self, config: MultiAgentEnvRunnerConfig,
                 worker_index: int = 0):
        self.config = config
        seed = config.seed + 1000 * worker_index
        self._envs: List[MultiAgentEnv] = [
            config.env_fn() for _ in range(config.num_envs)]
        self._agents = list(self._envs[0].agents)
        self.mapping = {a: config.policy_mapping_fn(a)
                        for a in self._agents}
        unknown = set(self.mapping.values()) - set(config.policies)
        if unknown:
            raise ValueError(f"policy_mapping_fn returned unknown "
                             f"policies {sorted(unknown)}")
        self.modules: Dict[str, ActorCriticModule] = {}
        self.params: Dict[str, Any] = {}
        for pid, spec in config.policies.items():
            self.modules[pid] = ActorCriticModule(
                spec.obs_dim, spec.num_actions, tuple(spec.hidden),
                continuous=spec.continuous,
                generator=torch.Generator().manual_seed(
                    seed + zlib.crc32(pid.encode()) % 10_000))
            self.params[pid] = to_numpy_params(
                self.modules[pid], self.modules[pid].state_dict())
        # column layout per policy: [(env_idx, agent_id), ...]
        self.columns: Dict[str, List[Tuple[int, str]]] = {
            pid: [] for pid in config.policies}
        for e in range(config.num_envs):
            for a in self._agents:
                self.columns[self.mapping[a]].append((e, a))
        self._col_index = {
            pid: {col: i for i, col in enumerate(cols)}
            for pid, cols in self.columns.items()}
        self._rng = np.random.default_rng(seed + 1)
        self._obs: List[Dict[str, Any]] = []
        for i, env in enumerate(self._envs):
            obs, _ = env.reset(seed=seed + i)
            self._obs.append(obs)
        self._ep_ret = {(e, a): 0.0 for e in range(config.num_envs)
                        for a in self._agents}
        # an agent that terminated before "__all__" idles masked-out
        # until its env resets
        self._agent_done = {(e, a): False for e in range(config.num_envs)
                            for a in self._agents}
        self._recent: Dict[str, list] = {a: [] for a in self._agents}
        self._total_steps = 0

    def ping(self) -> str:
        return "pong"

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for pid, w in weights.items():
            self.params[pid] = to_numpy_params(self.modules[pid], w)

    # ------------------------------------------------------------ sample
    def sample(self, rollout_length: Optional[int] = None
               ) -> Dict[str, Dict[str, np.ndarray]]:
        """-> {policy_id: single-agent-format time-major batch}."""
        T = rollout_length or self.config.rollout_length
        bufs: Dict[str, Dict[str, np.ndarray]] = {}
        for pid, cols in self.columns.items():
            spec = self.config.policies[pid]
            n = len(cols)
            bufs[pid] = {
                "obs": np.empty((T + 1, n, spec.obs_dim), np.float32),
                "actions": (np.empty((T, n, spec.num_actions), np.float32)
                            if spec.continuous
                            else np.empty((T, n), np.int32)),
                "logp": np.empty((T, n), np.float32),
                "rewards": np.zeros((T, n), np.float32),
                "terminateds": np.zeros((T, n), np.float32),
                "dones": np.zeros((T, n), np.float32),
                "mask": np.ones((T, n), np.float32),
            }

        def stack_obs(pid):
            cols = self.columns[pid]
            return np.stack([
                np.asarray(self._obs[e][a], np.float32).ravel()
                for e, a in cols])

        for t in range(T):
            actions_by_col: Dict[Tuple[int, str], Any] = {}
            for pid, cols in self.columns.items():
                obs = stack_obs(pid)
                bufs[pid]["obs"][t] = obs
                mod = self.modules[pid]
                logits = mod.forward_policy_np(self.params[pid], obs)
                action, logp = mod.sample_np(logits, self._rng,
                                             self.params[pid])
                bufs[pid]["actions"][t] = action
                bufs[pid]["logp"][t] = logp
                for ci, (e, a) in enumerate(cols):
                    actions_by_col[(e, a)] = action[ci]
            for e, env in enumerate(self._envs):
                acts = {a: actions_by_col[(e, a)] for a in self._agents}
                obs, rew, term, trunc, _ = env.step(acts)
                done_all = bool(term.get("__all__", False)
                                or trunc.get("__all__", False))
                for a in self._agents:
                    pid = self.mapping[a]
                    ci = self._col_index[pid][(e, a)]
                    was_done = self._agent_done[(e, a)]
                    r = float(rew.get(a, 0.0))
                    bufs[pid]["rewards"][t, ci] = r
                    term_a = bool(term.get(a, False)) or (
                        bool(term.get("__all__", False)))
                    trunc_a = bool(trunc.get(a, False)) or (
                        bool(trunc.get("__all__", False)))
                    bufs[pid]["terminateds"][t, ci] = float(term_a)
                    bufs[pid]["dones"][t, ci] = float(term_a or trunc_a)
                    if was_done:
                        # idle filler while peers finish: exclude from
                        # losses/GAE and from episode metrics
                        bufs[pid]["mask"][t, ci] = 0.0
                        continue
                    self._ep_ret[(e, a)] += r
                    if term_a or trunc_a:
                        self._recent[a].append(self._ep_ret[(e, a)])
                        self._recent[a] = self._recent[a][-100:]
                        self._ep_ret[(e, a)] = 0.0
                        self._agent_done[(e, a)] = True
                if done_all:
                    obs, _ = env.reset()
                    for a in self._agents:
                        self._agent_done[(e, a)] = False
                self._obs[e] = obs
            self._total_steps += len(self._envs)
        for pid in self.columns:
            bufs[pid]["obs"][T] = stack_obs(pid)
        return bufs

    def get_metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"num_env_steps_sampled": self._total_steps}
        by_policy: Dict[str, list] = {}
        for a, rets in self._recent.items():
            by_policy.setdefault(self.mapping[a], []).extend(rets)
            out[f"episode_return_mean/{a}"] = (
                float(np.mean(rets)) if rets else float("nan"))
        for pid, rets in by_policy.items():
            out[f"episode_return_mean/policy/{pid}"] = (
                float(np.mean(rets)) if rets else float("nan"))
        return out

    def stop(self) -> None:
        for env in self._envs:
            env.close()


# ---------------------------------------------------------------- PPO
@dataclasses.dataclass
class MultiAgentPPOConfig:
    env_fn: Callable[[], MultiAgentEnv] = None
    policies: Dict[str, PolicySpec] = None
    policy_mapping_fn: Callable[[str], str] = None
    num_env_runners: int = 0             # 0 = local
    num_envs_per_env_runner: int = 8
    rollout_length: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    num_epochs: int = 4
    num_minibatches: int = 4
    seed: int = 0
    # the learners' device: None = the card, "cpu" only by name
    device: Optional[str] = None

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """One PPOLearner per policy; runner fans samples per policy
    (reference Algorithm + MultiRLModule training path)."""

    def __init__(self, config: MultiAgentPPOConfig):
        from ray_tpu_torch.rllib.core.learner import (PPOLearner,
                                                      PPOLearnerConfig)
        self.config = config
        c = config
        runner_cfg = MultiAgentEnvRunnerConfig(
            env_fn=c.env_fn, policies=c.policies,
            policy_mapping_fn=c.policy_mapping_fn,
            num_envs=c.num_envs_per_env_runner,
            rollout_length=c.rollout_length, seed=c.seed)
        if c.num_env_runners == 0:
            self._runners = [MultiAgentEnvRunner(runner_cfg)]
            self._remote = False
        else:
            import ray_tpu_torch
            cls = ray_tpu_torch.remote(num_cpus=1)(MultiAgentEnvRunner)
            self._runners = [cls.remote(runner_cfg, worker_index=i + 1)
                             for i in range(c.num_env_runners)]
            self._remote = True
        self.learners: Dict[str, PPOLearner] = {}
        for pid, spec in c.policies.items():
            self.learners[pid] = PPOLearner(PPOLearnerConfig(
                obs_dim=spec.obs_dim, num_actions=spec.num_actions,
                hidden=tuple(spec.hidden), lr=c.lr, gamma=c.gamma,
                gae_lambda=c.gae_lambda, clip_eps=c.clip_eps,
                vf_coef=c.vf_coef, ent_coef=c.ent_coef,
                num_epochs=c.num_epochs,
                num_minibatches=c.num_minibatches,
                continuous=spec.continuous,
                seed=c.seed + zlib.crc32(pid.encode()) % 10_000,
                device=c.device))
        self.iteration = 0
        self._sync_weights()

    def _weights(self) -> Dict[str, Any]:
        return {pid: ln.get_weights()
                for pid, ln in self.learners.items()}

    def _sync_weights(self) -> None:
        w = self._weights()
        if self._remote:
            import ray_tpu_torch
            ref = ray_tpu_torch.put(w)
            for r in self._runners:
                r.set_weights.remote(ref)
        else:
            self._runners[0].set_weights(w)

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch
        t0 = time.perf_counter()
        if self._remote:
            per_runner = ray_tpu_torch.get(
                [r.sample.remote() for r in self._runners])
        else:
            per_runner = [self._runners[0].sample()]
        metrics: Dict[str, Any] = {}
        for pid in self.config.policies:
            batch = {k: np.concatenate([b[pid][k] for b in per_runner],
                                       axis=1)
                     for k in per_runner[0][pid]}
            lm = self.learners[pid].update(batch)
            metrics.update({f"{k}/policy/{pid}": v
                            for k, v in lm.items()})
        self._sync_weights()
        self.iteration += 1
        if self._remote:
            metrics.update(ray_tpu_torch.get(
                self._runners[0].get_metrics.remote()))
        else:
            metrics.update(self._runners[0].get_metrics())
        metrics["training_iteration"] = self.iteration
        metrics["time_iteration_s"] = time.perf_counter() - t0
        return metrics

    def get_state(self) -> Dict[str, Any]:
        return {"learners": {pid: ln.get_state()
                             for pid, ln in self.learners.items()},
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        for pid, st in state["learners"].items():
            self.learners[pid].set_state(st)
        self.iteration = state.get("iteration", 0)
        self._sync_weights()

    def stop(self) -> None:
        import ray_tpu_torch
        for r in self._runners:
            try:
                if self._remote:
                    ray_tpu_torch.kill(r)
                else:
                    r.stop()
            except BaseException:
                pass
