"""Offline RL: experience recording + behavior cloning on ray_tpu_torch.

Port of `ray_tpu/rllib/offline.py`. Parity: reference rllib/offline
(offline_data.py readers/writers feeding the learner; the BC/MARWIL
family trains from recorded episodes): experiences are
`ray_tpu_torch.data` Datasets (jsonl), and BC, MARWIL and CQL each run
one supervised or TD update per batch on the learner's device (the card
unless `device="cpu"`). The env is a gymnasium id or a callable
`env(num_envs)` (`env/env_runner.py::make_env`); `evaluate` runs one env
of it, reset with `seed + ep` at every episode and stopped at that
episode's first termination or truncation, as the JAX `evaluate` runs
`gym.make`'s.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import _host, descend
from ray_tpu_torch.rllib.core.rl_module import (ActorCriticModule,
                                                to_numpy_params)
from ray_tpu_torch.rllib.env.env_runner import env_spaces, make_env

Env = Union[str, Callable[[int], Any]]


def record_transitions(env: Env, policy_fn: Callable, path: str,
                       num_steps: int = 5000, num_envs: int = 8,
                       seed: int = 0) -> str:
    """Roll a policy (obs_batch -> action_batch) and write transitions
    as jsonl rows {obs, action, reward, terminated} (reference offline
    output writer shape). Returns the written path."""
    from ray_tpu_torch import data as rd
    envs = make_env(env, num_envs)
    obs, _ = envs.reset(seed=seed)
    prev_done = np.zeros(num_envs, bool)
    eps_counter = np.arange(num_envs)        # episode ids per env lane
    next_eps = num_envs
    rows = []
    while len(rows) < num_steps:
        action = np.asarray(policy_fn(obs.astype(np.float32)))
        nobs, reward, term, trunc, _ = envs.step(action)
        done = term | trunc
        valid = ~prev_done
        for i in np.nonzero(valid)[0]:
            rows.append({"obs": obs[i].astype(np.float32),
                         "action": action[i],
                         "reward": float(reward[i]),
                         "new_obs": nobs[i].astype(np.float32),
                         "terminated": bool(term[i]),
                         "eps_id": int(eps_counter[i])})
        for i in np.nonzero(done)[0]:
            eps_counter[i] = next_eps
            next_eps += 1
        prev_done = done
        obs = nobs
    envs.close()
    ds = rd.from_items(rows, override_num_blocks=8)
    ds.write_jsonl(path)
    return path


class _OfflineConfigMixin(AlgorithmConfig):
    """Offline configs share the unified AlgorithmConfig surface, plus
    the offline-data source group (reference config.offline_data())."""

    # legacy alias: subclasses may still set _ALGO
    _ALGO: type = None

    def offline_data(self, input_path: str):
        self.input_path = input_path
        return self

    def build(self):
        return (self.algo_class or self._ALGO)(self)


def _spaces(env: Env) -> tuple:
    """(obs_dim, continuous, num_actions) of `env`."""
    obs_space, space = env_spaces(env)
    continuous = not hasattr(space, "n")
    return (int(np.prod(obs_space.shape)), continuous,
            int(np.prod(space.shape)) if continuous else int(space.n))


def _evaluate(env: Env, act: Callable, num_episodes: int,
              seed: int) -> Dict[str, float]:
    """Mean return of `act` (obs (1, D) -> action batch) over
    `num_episodes` episodes of one env of `env`."""
    envs = make_env(env, 1)
    returns = []
    for ep in range(num_episodes):
        obs, _ = envs.reset(seed=seed + ep)
        total = 0.0
        while True:
            obs, r, term, trunc, _ = envs.step(
                act(obs.astype(np.float32)))
            total += float(r[0])
            if term[0] or trunc[0]:
                break
        returns.append(total)
    envs.close()
    return {"episode_return_mean": float(np.mean(returns)),
            "num_episodes": num_episodes}


class _ActorCriticOffline:
    """The module, optimizer and greedy evaluation BC and MARWIL share."""

    def _build(self, config) -> None:
        self.config = config
        self.device = resolve_device(config.device)
        obs_dim, self._continuous, num_actions = _spaces(config.env)
        self.module = ActorCriticModule(
            obs_dim, num_actions, tuple(config.hidden),
            continuous=self._continuous,
            generator=torch.Generator().manual_seed(config.seed)
        ).to(self.device)
        self._opt = torch.optim.Adam(self.module.parameters(), lr=config.lr)
        self.iteration = 0

    def _descend(self, loss) -> None:
        # BC's loss leaves the value head out: its gradient is zeros, as
        # JAX's is, so Adam steps its moments alike
        params = list(self.module.parameters())
        descend(self._opt, params, torch.autograd.grad(
            loss, params, allow_unused=True, materialize_grads=True))

    def _tensors(self, *arrays):
        dtype = next(self.module.parameters()).dtype
        out = []
        for a in arrays:
            t = torch.as_tensor(a, device=self.device)
            out.append(t.to(dtype) if t.is_floating_point() else t)
        return out

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return _host(self.module.state_dict())

    def evaluate(self, num_episodes: int = 10,
                 seed: int = 123) -> Dict[str, float]:
        """Greedy rollout return of the cloned policy."""
        params_np = to_numpy_params(self.module, self.module.state_dict())

        def act(obs):
            pi_out = self.module.forward_policy_np(params_np, obs)
            return pi_out if self._continuous else np.argmax(pi_out, -1)
        return _evaluate(self.config.env, act, num_episodes, seed)


@dataclasses.dataclass
class BCConfig(_OfflineConfigMixin):
    env: Env = "CartPole-v1"
    input_path: str = ""                 # jsonl dir/file of transitions
    hidden: Sequence[int] = (64, 64)
    lr: float = 1e-3
    train_batch_size: int = 256
    num_batches_per_iteration: int = 50
    seed: int = 0
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None


class BC(_ActorCriticOffline):
    """Behavior cloning: maximize log pi(a|s) over the offline dataset."""

    def __init__(self, config: BCConfig):
        if not config.input_path:
            raise ValueError("BC needs offline_data(input_path=...)")
        from ray_tpu_torch import data as rd
        self._build(config)
        self._dataset = rd.read_json(config.input_path)

    def _update(self, obs, actions) -> torch.Tensor:
        obs, actions = self._tensors(obs, actions)
        logits, _ = self.module(obs)
        loss = -self.module.dist_log_prob(logits, actions).mean()
        self._descend(loss)
        return loss.detach()

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        losses = []
        batches = self._dataset.iter_batches(
            batch_size=c.train_batch_size, drop_last=True,
            local_shuffle_buffer_size=4 * c.train_batch_size,
            seed=c.seed + self.iteration)
        for _, batch in zip(range(c.num_batches_per_iteration), batches):
            obs = np.stack([np.asarray(o, np.float32)
                            for o in batch["obs"]])
            if self._continuous:
                actions = np.stack([np.asarray(a, np.float32)
                                    for a in batch["action"]])
            else:
                actions = np.asarray(batch["action"], np.int64)
            losses.append(float(self._update(obs, actions)))
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "bc_loss": float(np.mean(losses)) if losses else
                float("nan"),
                "num_batches": len(losses),
                "time_iteration_s": time.perf_counter() - t0}


BCConfig._ALGO = BC


def _load_transitions(input_path: str):
    """Load an offline jsonl dataset into flat arrays (rows keep
    insertion order, so per-eps_id sequences are time-ordered)."""
    from ray_tpu_torch import data as rd
    rows = rd.read_json(input_path).take_all()
    obs = np.stack([np.asarray(r["obs"], np.float32) for r in rows])
    actions = np.asarray([r["action"] for r in rows])
    rewards = np.asarray([r["reward"] for r in rows], np.float32)
    terms = np.asarray([r["terminated"] for r in rows], np.float32)
    new_obs = (np.stack([np.asarray(r["new_obs"], np.float32)
                         for r in rows])
               if "new_obs" in rows[0] else None)
    eps_ids = (np.asarray([r["eps_id"] for r in rows])
               if "eps_id" in rows[0] else None)
    return obs, actions, rewards, new_obs, terms, eps_ids


def _returns_to_go(rewards, eps_ids, gamma: float) -> np.ndarray:
    """Discounted return-to-go per episode (reference
    postprocessing compute advantages for MARWIL)."""
    if eps_ids is None:
        raise ValueError(
            "dataset lacks eps_id column (re-record with this version's "
            "record_transitions) — MARWIL needs episode boundaries")
    rtg = np.zeros_like(rewards)
    for eid in np.unique(eps_ids):
        idx = np.nonzero(eps_ids == eid)[0]       # time-ordered
        acc = 0.0
        for j in idx[::-1]:
            acc = rewards[j] + gamma * acc
            rtg[j] = acc
    return rtg


@dataclasses.dataclass
class MARWILConfig(_OfflineConfigMixin):
    """Reference rllib/algorithms/marwil/marwil.py: exponentially
    advantage-weighted imitation (beta=0 reduces to BC)."""
    env: Env = "CartPole-v1"
    input_path: str = ""
    hidden: Sequence[int] = (64, 64)
    lr: float = 1e-3
    beta: float = 1.0
    vf_coef: float = 1.0
    gamma: float = 0.99
    train_batch_size: int = 256
    num_batches_per_iteration: int = 50
    seed: int = 0
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None


class MARWIL(_ActorCriticOffline):
    """Advantage-weighted behavior cloning: maximize
    exp(beta * Â(s, a)) * log pi(a|s) with a monte-carlo value baseline
    (reference marwil_torch_learner loss)."""

    def __init__(self, config: MARWILConfig):
        if not config.input_path:
            raise ValueError("MARWIL needs offline_data(input_path=...)")
        self._build(config)
        obs, actions, rewards, _nobs, _terms, eps_ids = \
            _load_transitions(config.input_path)
        self._obs = obs
        self._actions = (actions.astype(np.float32) if self._continuous
                         else actions.astype(np.int32))
        self._rtg = _returns_to_go(rewards, eps_ids, config.gamma)
        self._rng = np.random.default_rng(config.seed)

    def _loss(self, obs, actions, rtg) -> tuple:
        c = self.config
        logits, value = self.module(obs)
        logp = self.module.dist_log_prob(logits, actions)
        adv = rtg - value
        # batch-normalized advantage inside the exp weight; jnp.std is
        # the population std
        adv_n = adv / (adv.detach().std(correction=0) + 1e-6)
        w = torch.clamp(torch.exp(c.beta * adv_n.detach()), max=20.0)
        pi_loss = -(w * logp).mean()
        vf_loss = adv.square().mean()
        return pi_loss + c.vf_coef * vf_loss, pi_loss, vf_loss

    def _update(self, obs, actions, rtg) -> torch.Tensor:
        loss, pi_l, vf_l = self._loss(*self._tensors(obs, actions, rtg))
        self._descend(loss)
        return torch.stack([loss, pi_l, vf_l]).detach()

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        n = len(self._obs)
        out = []
        for _ in range(c.num_batches_per_iteration):
            idx = self._rng.integers(0, n, c.train_batch_size)
            out.append(self._update(self._obs[idx], self._actions[idx],
                                    self._rtg[idx]).tolist())
        losses, pi_ls, vf_ls = zip(*out)
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "marwil_loss": float(np.mean(losses)),
                "policy_loss": float(np.mean(pi_ls)),
                "vf_loss": float(np.mean(vf_ls)),
                "time_iteration_s": time.perf_counter() - t0}


@dataclasses.dataclass
class CQLConfig(_OfflineConfigMixin):
    """Discrete conservative Q-learning (reference
    rllib/algorithms/cql: CQL(H) regularizer over a Q-learning core)."""
    env: Env = "CartPole-v1"
    input_path: str = ""
    hidden: Sequence[int] = (64, 64)
    lr: float = 5e-4
    gamma: float = 0.99
    cql_alpha: float = 1.0
    target_network_update_freq: int = 100
    train_batch_size: int = 256
    num_batches_per_iteration: int = 50
    seed: int = 0
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None


class CQL:
    """Offline Q-learning with the conservative penalty
    E[logsumexp Q(s,·) - Q(s, a_data)] that pushes down out-of-
    distribution action values (CQL(H), Kumar et al. 2020)."""

    def __init__(self, config: CQLConfig):
        if not config.input_path:
            raise ValueError("CQL needs offline_data(input_path=...)")
        from ray_tpu_torch.rllib.algorithms.dqn import QModule
        self.config = config
        self.device = resolve_device(config.device)
        obs_dim, continuous, num_actions = _spaces(config.env)
        if continuous:
            raise ValueError("discrete CQL needs a Discrete action "
                             "space (continuous CQL rides SAC)")
        self.module = QModule(
            obs_dim, num_actions, tuple(config.hidden),
            generator=torch.Generator().manual_seed(config.seed)
        ).to(self.device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._opt = torch.optim.Adam(self.module.parameters(), lr=config.lr)
        obs, actions, rewards, new_obs, terms, _eps = \
            _load_transitions(config.input_path)
        if new_obs is None:
            raise ValueError(
                "dataset lacks new_obs (re-record with this version's "
                "record_transitions) — CQL needs next observations")
        self._data = (obs, actions.astype(np.int32), rewards, new_obs,
                      terms)
        self._rng = np.random.default_rng(config.seed)
        self._num_updates = 0
        self.iteration = 0

    def _loss(self, obs, actions, rewards, new_obs, terms) -> tuple:
        c = self.config
        q = self.module(obs)
        q_sa = q.gather(-1, actions.long()[:, None])[:, 0]
        with torch.no_grad():
            q_next_t = self.target(new_obs)
            a_star = self.module(new_obs).argmax(-1)
            q_next = q_next_t.gather(-1, a_star[:, None])[:, 0]
            target = rewards + c.gamma * (1 - terms) * q_next
        td = (q_sa - target).square().mean()
        # conservative term: push down OOD actions, up dataset ones
        cql = (torch.logsumexp(q, -1) - q_sa).mean()
        return td + c.cql_alpha * cql, td, cql

    def _update(self, *batch) -> torch.Tensor:
        dtype = self.module.q[0].weight.dtype
        t = [torch.as_tensor(a, device=self.device) for a in batch]
        t = [x.to(dtype) if x.is_floating_point() else x for x in t]
        loss, td, cql = self._loss(*t)
        params = list(self.module.parameters())
        descend(self._opt, params, torch.autograd.grad(loss, params))
        return torch.stack([loss, td, cql]).detach()

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return _host(self.module.state_dict())

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        obs, actions, rewards, new_obs, terms = self._data
        n = len(obs)
        tds, cqls = [], []
        for _ in range(c.num_batches_per_iteration):
            idx = self._rng.integers(0, n, c.train_batch_size)
            _loss, td, cql = self._update(
                obs[idx], actions[idx], rewards[idx], new_obs[idx],
                terms[idx]).tolist()
            tds.append(td)
            cqls.append(cql)
            self._num_updates += 1
            if self._num_updates % c.target_network_update_freq == 0:
                self.target.load_state_dict(self.module.state_dict())
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "td_loss": float(np.mean(tds)),
                "cql_loss": float(np.mean(cqls)),
                "num_updates_lifetime": self._num_updates,
                "time_iteration_s": time.perf_counter() - t0}

    def evaluate(self, num_episodes: int = 10,
                 seed: int = 123) -> Dict[str, float]:
        """Greedy Q rollout."""
        params_np = to_numpy_params(self.module, self.module.state_dict())

        def act(obs):
            return np.argmax(self.module.forward_np(params_np, obs), -1)
        return _evaluate(self.config.env, act, num_episodes, seed)


MARWILConfig._ALGO = MARWIL
CQLConfig._ALGO = CQL
