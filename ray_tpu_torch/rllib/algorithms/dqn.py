"""DQN: replay-buffer off-policy Q-learning (double-DQN update).

Port of `ray_tpu/rllib/algorithms/dqn.py`. Parity: reference
rllib/algorithms/dqn (new-stack DQN with prioritized replay, target
network, double-Q): one update (double-DQN TD loss or C51's projected
cross-entropy, importance weights, Adam) on the learner's device (the
card unless `device="cpu"`), epsilon-greedy numpy env runners on a
linear schedule, target-network sync every `target_network_update_freq`
updates, uniform or prioritized buffer from rllib.utils.replay_buffers.

Where the JAX update splits a key per call, this one takes its NoisyNet
draws as an argument (`QModule.draw_noise` from the learner's CPU
generator, three per update: the online net on `obs`, the target on
`new_obs`, the online net's action choice on `new_obs`), so a learner on
the card and one on the CPU, or a test feeding the JAX draws, see the
same noise. C51's projection keeps the JAX dense one-hot form
(deterministic on the card, where a scatter-add would use atomics).
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import _host, descend
from ray_tpu_torch.rllib.core.rl_module import to_numpy_params
from ray_tpu_torch.rllib.env.env_runner import env_spaces, make_env
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)
from ray_tpu_torch.rllib.utils.schedules import LinearSchedule


# ------------------------------------------------------------ q module
def _fnoise(x):
    """Factorized-noise squash f(x) = sign(x)·sqrt(|x|) (NoisyNet)."""
    return torch.sign(x) * torch.sqrt(torch.abs(x))


class NoisyLinear(nn.Linear):
    """A dense layer with factorized-Gaussian parameter noise: weight
    `(dout, din)` plus sigmas `w_sig` `(dout, din)` and `b_sig` `(dout,)`
    (w = mu + sigma·f(eps_out)⊗f(eps_in))."""

    def __init__(self, din: int, dout: int):
        super().__init__(din, dout, device="meta")
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.empty(dout))
        self.w_sig = nn.Parameter(torch.empty(dout, din))
        self.b_sig = nn.Parameter(torch.empty(dout))

    def forward(self, x, noise=None):
        """`noise` = (e_in, e_out), raw standard-normal draws; None is
        the mu-only (deterministic, eval) path."""
        w, b = self.weight, self.bias
        if noise is not None:
            e_in, e_out = (_fnoise(e.to(device=w.device, dtype=w.dtype))
                           for e in noise)
            w = w + self.w_sig * (e_out[:, None] * e_in[None, :])
            b = b + self.b_sig * e_out
        return F.linear(x, w, b)


class QModule(nn.Module):
    """MLP Q-network: obs -> Q(s, ·) or a return DISTRIBUTION.

    Rainbow components (reference rllib/algorithms/dqn — dueling heads,
    distributional C51, noisy nets):
    - dueling: torso feeds separate value/advantage heads combined as
      V + A - mean(A) (per-atom in distributional mode).
    - num_atoms > 1: C51 — heads emit logits over a fixed support
      linspace(v_min, v_max, num_atoms); Q(s,a) = E_p[z].
    - noisy: head layers carry factorized-Gaussian parameter noise;
      sampling a fresh eps per forward IS the exploration, replacing
      epsilon-greedy.

    Torso layers are `q.0 … q.{L-1}`; the head is `q.L`, or `adv.0` and
    `val.0` when dueling (the JAX nest's `q`, `adv`, `val` lists)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), dueling: bool = False,
                 num_atoms: int = 1, v_min: float = -10.0,
                 v_max: float = 10.0, noisy: bool = False,
                 sigma0: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim, self.num_actions = obs_dim, num_actions
        self.hidden, self.dueling = tuple(hidden), dueling
        self.num_atoms, self.v_min, self.v_max = num_atoms, v_min, v_max
        self.noisy, self.sigma0 = noisy, sigma0
        head = NoisyLinear if noisy else (
            lambda a, b: nn.utils.skip_init(nn.Linear, a, b))
        dims = (obs_dim,) + self.hidden
        layers = [nn.utils.skip_init(nn.Linear, a, b)
                  for a, b in zip(dims[:-1], dims[1:])]
        din, K = dims[-1], num_atoms
        if dueling:
            self.q = nn.ModuleList(layers)
            self.adv = nn.ModuleList([head(din, num_actions * K)])
            self.val = nn.ModuleList([head(din, K)])
        else:
            self.q = nn.ModuleList(layers + [head(din, num_actions * K)])
        self.init(generator)

    def _heads(self):
        """(name, layer, output scale) of the head layers."""
        if self.dueling:
            return [("adv", self.adv[0], 0.01), ("val", self.val[0], 1.0)]
        return [("q", self.q[-1], 0.01)]

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "QModule":
        """Orthogonal weights (gain √2 in the torso, 0.01 on the
        advantage/Q head, 1.0 on the value head), zero biases, sigmas
        sigma0/√din, drawn from `generator` (seed 0 when None)."""
        gen = generator or torch.Generator().manual_seed(0)
        torso = self.q if self.dueling else self.q[:-1]
        for layer, gain in [(l, math.sqrt(2.0)) for l in torso] + [
                (l, g) for _, l, g in self._heads()]:
            w = torch.empty(layer.weight.shape)
            nn.init.orthogonal_(w, gain, generator=gen)
            layer.weight.copy_(w)
            layer.bias.zero_()
            if isinstance(layer, NoisyLinear):
                s = self.sigma0 / math.sqrt(layer.weight.shape[1])
                layer.w_sig.fill_(s)
                layer.b_sig.fill_(s)
        return self

    def dense_layout(self):
        """(JAX nest path, state-dict prefix) of every dense layer."""
        out = [(("q", i), f"q.{i}") for i in range(len(self.q))]
        if self.dueling:
            out += [(("adv", 0), "adv.0"), (("val", 0), "val.0")]
        return out

    @property
    def support(self) -> torch.Tensor:
        p = self.q[0].weight
        return torch.linspace(self.v_min, self.v_max, self.num_atoms,
                              device=p.device, dtype=p.dtype)

    def draw_noise(self, generator: torch.Generator
                   ) -> Optional[Dict[str, Tuple[torch.Tensor, ...]]]:
        """One forward's raw NoisyNet draws (standard normals, on the
        CPU): head name -> (e_in (din,), e_out (dout,)); None when the
        module is not noisy."""
        if not self.noisy:
            return None
        out = {}
        for name, layer, _ in self._heads():
            dout, din = layer.weight.shape
            out[name] = (torch.randn(din, generator=generator),
                         torch.randn(dout, generator=generator))
        return out

    def _head_out(self, obs, noise=None):
        """Raw head output: (B, A) for scalar Q, (B, A, K) logits for
        distributional."""
        x = obs
        torso = self.q if self.dueling else self.q[:-1]
        for layer in torso:
            x = torch.tanh(layer(x))
        A, K = self.num_actions, self.num_atoms

        def apply(name, layer, x):
            if isinstance(layer, NoisyLinear):
                return layer(x, None if noise is None else noise[name])
            return layer(x)

        if self.dueling:
            a = apply("adv", self.adv[0], x)
            v = apply("val", self.val[0], x)
            if K == 1:
                return v + a - a.mean(-1, keepdim=True)
            a = a.reshape(a.shape[0], A, K)
            v = v.reshape(v.shape[0], 1, K)
            return v + a - a.mean(1, keepdim=True)
        out = apply("q", self.q[-1], x)
        return out if K == 1 else out.reshape(out.shape[0], A, K)

    def forward_dist(self, obs, noise=None) -> torch.Tensor:
        """(B, A, K) return-distribution logits (num_atoms > 1 only)."""
        return self._head_out(obs, noise)

    def forward(self, obs, noise=None) -> torch.Tensor:
        """(B, A) Q-values (expectation over the support in C51)."""
        out = self._head_out(obs, noise)
        if self.num_atoms == 1:
            return out
        return (torch.softmax(out, -1) * self.support).sum(-1)

    def forward_np(self, params_np: dict, obs,
                   rng: Optional[np.random.Generator] = None
                   ) -> np.ndarray:
        """Numpy action-value path for env runners, on the nest
        `to_numpy_params` makes; `rng` samples the NoisyNet exploration
        noise."""
        x = obs
        torso = (params_np["q"] if self.dueling
                 else params_np["q"][:-1])
        for layer in torso:
            x = np.tanh(x @ layer["w"] + layer["b"])

        def apply(layer, x):
            w, b = layer["w"], layer["b"]
            if "w_sig" in layer and rng is not None:
                e_in = rng.standard_normal(w.shape[0])
                e_out = rng.standard_normal(w.shape[1])
                f = lambda v: np.sign(v) * np.sqrt(np.abs(v))
                e_in, e_out = f(e_in), f(e_out)
                w = w + layer["w_sig"] * (e_in[:, None] * e_out[None, :])
                b = b + layer["b_sig"] * e_out
            return x @ w + b

        A, K = self.num_actions, self.num_atoms
        if self.dueling:
            a = apply(params_np["adv"][0], x)
            v = apply(params_np["val"][0], x)
            if K == 1:
                return v + a - a.mean(axis=-1, keepdims=True)
            a = a.reshape(len(a), A, K)
            v = v.reshape(len(v), 1, K)
            logits = v + a - a.mean(axis=1, keepdims=True)
        else:
            out = apply(params_np["q"][-1], x)
            if K == 1:
                return out
            logits = out.reshape(len(out), A, K)
        z = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        support = np.linspace(self.v_min, self.v_max, K)
        return (p * support).sum(axis=-1)


def _q_module(config: "DQNConfig", obs_dim: int, num_actions: int,
              generator: Optional[torch.Generator] = None) -> QModule:
    c = config
    return QModule(obs_dim, num_actions, tuple(c.hidden), dueling=c.dueling,
                   num_atoms=c.num_atoms, v_min=c.v_min, v_max=c.v_max,
                   noisy=c.noisy, sigma0=c.noisy_sigma0, generator=generator)


class QEnvRunner:
    """Epsilon-greedy vectorized sampler emitting FLAT transitions
    (s, a, r, s', done) — the off-policy contract, unlike the
    time-major on-policy runner. The policy runs in numpy."""

    def __init__(self, config: "DQNConfig", worker_index: int = 0):
        self.config = config
        seed = config.seed + 1000 * worker_index
        self._envs = make_env(config.env, config.num_envs_per_env_runner)
        space = self._envs.single_action_space
        if not hasattr(space, "n"):
            raise ValueError("DQN needs a discrete action space")
        self.module = _q_module(
            config, int(np.prod(self._envs.single_observation_space.shape)),
            int(space.n), torch.Generator().manual_seed(seed))
        # n-step returns: per-env pending transition windows (reference
        # rainbow n_step; horizon shortens at episode end)
        self._nstep = max(1, int(config.n_step))
        self._pending = [[] for _ in
                         range(config.num_envs_per_env_runner)]
        self.set_weights(self.module.state_dict())
        self._rng = np.random.default_rng(seed + 1)
        self._obs, _ = self._envs.reset(seed=seed)
        self._prev_done = np.zeros(config.num_envs_per_env_runner, bool)
        self._eps = LinearSchedule(config.epsilon_timesteps,
                                   config.final_epsilon,
                                   config.initial_epsilon)
        self._steps = 0
        self._ep_ret = np.zeros(config.num_envs_per_env_runner)
        self._recent: list = []

    def ping(self):
        return "pong"

    def set_weights(self, weights) -> None:
        """`weights`: the learner's state dict (tensors or arrays)."""
        self.params = to_numpy_params(self.module, weights)

    def _emit_nstep(self, rows, env_i: int, flush: bool) -> None:
        """Pop matured windows: (s0, a0, sum gamma^k r_k, s_h, term_h,
        horizon h). On flush (episode boundary) every remaining entry
        emits with its shortened horizon."""
        g = self.config.gamma
        buf = self._pending[env_i]
        while buf and (flush or len(buf) >= self._nstep):
            horizon = min(len(buf), self._nstep)
            R = 0.0
            for k in range(horizon):
                R += (g ** k) * buf[k][2]
            o0, a0 = buf[0][0], buf[0][1]
            nobs_h, term_h = buf[horizon - 1][3], buf[horizon - 1][4]
            rows["obs"].append(o0)
            rows["actions"].append(a0)
            rows["rewards"].append(np.float32(R))
            rows["new_obs"].append(nobs_h)
            rows["terminateds"].append(np.float32(term_h))
            rows["nsteps"].append(np.float32(horizon))
            buf.pop(0)

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        rows = {k: [] for k in ("obs", "actions", "rewards", "new_obs",
                                "terminateds", "nsteps")}
        N = self.config.num_envs_per_env_runner
        for _ in range(num_steps):
            if self.config.noisy:
                # NoisyNet: a fresh parameter-noise sample per step IS
                # the exploration — no epsilon
                q = self.module.forward_np(
                    self.params, self._obs.astype(np.float32),
                    rng=self._rng)
                action = q.argmax(-1).astype(np.int32)
            else:
                q = self.module.forward_np(self.params,
                                           self._obs.astype(np.float32))
                greedy = q.argmax(-1)
                explore = (self._rng.random(N)
                           < self._eps(self._steps))
                random_a = self._rng.integers(0, q.shape[-1], N)
                action = np.where(explore, random_a,
                                  greedy).astype(np.int32)
            nobs, reward, term, trunc, _ = self._envs.step(action)
            done = term | trunc
            valid = ~self._prev_done     # autoreset filler: drop
            for i in np.nonzero(valid)[0]:
                self._pending[i].append(
                    (self._obs[i].astype(np.float32),
                     np.int32(action[i]), float(reward[i]),
                     nobs[i].astype(np.float32), bool(term[i])))
                self._emit_nstep(rows, i, flush=bool(done[i]))
            self._ep_ret[valid] += reward[valid]
            for i in np.nonzero(done & valid)[0]:
                self._recent.append(float(self._ep_ret[i]))
                self._ep_ret[i] = 0.0
            self._recent = self._recent[-100:]
            self._prev_done = done
            self._obs = nobs
            self._steps += N
        if not rows["rewards"]:
            obs_shape = self._obs.shape[1:]
            return {"obs": np.empty((0,) + obs_shape, np.float32),
                    "actions": np.empty((0,), np.int32),
                    "rewards": np.empty((0,), np.float32),
                    "new_obs": np.empty((0,) + obs_shape, np.float32),
                    "terminateds": np.empty((0,), np.float32),
                    "nsteps": np.empty((0,), np.float32)}
        return {k: np.stack(v) for k, v in rows.items()}

    def get_metrics(self) -> Dict[str, Any]:
        return {"episode_return_mean": (float(np.mean(self._recent))
                                        if self._recent else float("nan")),
                "num_episodes": len(self._recent),
                "epsilon": self._eps(self._steps),
                "num_env_steps_sampled": self._steps}

    def stop(self) -> None:
        self._envs.close()


@dataclasses.dataclass
class DQNConfig(AlgorithmConfig):
    # a gymnasium id, or a callable num_envs -> vector env
    env: Union[str, Callable[[int], Any]] = "CartPole-v1"
    num_env_runners: int = 0              # 0 = local
    num_envs_per_env_runner: int = 8
    rollout_steps_per_iteration: int = 64
    hidden: Sequence[int] = (64, 64)
    lr: float = 5e-4
    gamma: float = 0.99
    buffer_size: int = 50_000
    prioritized_replay: bool = True
    train_batch_size: int = 64
    num_updates_per_iteration: int = 16
    learning_starts: int = 500            # env steps before updates
    target_network_update_freq: int = 100  # in updates
    dueling: bool = False                  # V + A - mean(A) heads
    n_step: int = 1                        # multi-step TD returns
    # rainbow: distributional C51 (num_atoms > 1) + noisy nets
    num_atoms: int = 1
    v_min: float = -10.0
    v_max: float = 10.0
    noisy: bool = False                    # NoisyNet exploration
    noisy_sigma0: float = 0.5
    initial_epsilon: float = 1.0
    final_epsilon: float = 0.02
    epsilon_timesteps: int = 10_000
    double_q: bool = True
    seed: int = 0
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None


class DQN:
    """Iterative trainer: sample -> buffer -> k double-DQN updates."""

    def __init__(self, config: DQNConfig):
        self.config = config
        c = config
        self.device = resolve_device(c.device)
        if c.num_env_runners == 0:
            self._runners = [QEnvRunner(c)]
            self._remote = False
        else:
            import ray_tpu_torch
            cls = ray_tpu_torch.remote(num_cpus=1)(QEnvRunner)
            self._runners = [cls.remote(c, worker_index=i + 1)
                             for i in range(c.num_env_runners)]
            self._remote = True
        init_seed, noise_seed = (
            int(s) for s in np.random.SeedSequence(c.seed).generate_state(2))
        # drawn on the CPU, then moved: every device starts alike
        self.module = _q_module(
            c, *self._probe_dims(),
            torch.Generator().manual_seed(init_seed)).to(self.device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._opt = torch.optim.Adam(self.module.parameters(), lr=c.lr)
        self.buffer = (PrioritizedReplayBuffer(c.buffer_size,
                                               seed=c.seed)
                       if c.prioritized_replay
                       else ReplayBuffer(c.buffer_size, seed=c.seed))
        self._noise_gen = torch.Generator().manual_seed(noise_seed)
        self._num_updates = 0
        self._total_steps = 0
        self.iteration = 0

    def _probe_dims(self) -> Tuple[int, int]:
        obs_space, space = env_spaces(self.config.env)
        return int(np.prod(obs_space.shape)), int(space.n)

    # ---------------------------------------------------------- update
    def _loss_scalar(self, b, noise):
        c = self.config
        n1, n2, n3 = noise
        q = self.module(b["obs"], n1)
        q_sa = q.gather(-1, b["actions"].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next_target = self.target(b["new_obs"], n2)
            if c.double_q:
                # n3, not n2: online action selection must not share the
                # target net's noise realization (correlated parameter
                # noise would re-couple selection and evaluation)
                a_star = self.module(b["new_obs"], n3).argmax(-1)
                q_next = q_next_target.gather(-1, a_star[:, None])[:, 0]
            else:
                q_next = q_next_target.max(-1).values
            target = (b["rewards"]
                      + self._g_eff(b) * (1.0 - b["terminateds"]) * q_next)
        td = q_sa - target
        w = b.get("weights", torch.ones_like(td))
        return (w * td.square()).mean(), td.detach().abs()

    def _g_eff(self, b):
        # n-step bootstrap: reward already sums gamma^k r_k over the
        # window; discount the tail by gamma^horizon
        return self.config.gamma ** b.get(
            "nsteps", torch.ones_like(b["rewards"]))

    def _c51_target(self, b, noise):
        """The Bellman-updated target distribution projected onto the
        support, (B, K), in the JAX dense one-hot form: each target atom
        splits its mass between its floor and ceiling atoms, and one that
        lands exactly on the top atom (lo == hi) keeps its full mass."""
        c = self.config
        K = c.num_atoms
        z = self.module.support                      # (K,)
        dz = (c.v_max - c.v_min) / (K - 1)
        _, n2, n3 = noise
        with torch.no_grad():
            t_logits = self.target.forward_dist(b["new_obs"], n2)
            p_next = torch.softmax(t_logits, -1)     # (B, A, K)
            if c.double_q:
                a_star = self.module(b["new_obs"], n3).argmax(-1)
            else:
                a_star = (p_next * z).sum(-1).argmax(-1)
            p_a = p_next.gather(
                1, a_star[:, None, None].expand(-1, 1, K))[:, 0]
            Tz = torch.clamp(
                b["rewards"][:, None]
                + self._g_eff(b)[:, None]
                * (1.0 - b["terminateds"])[:, None] * z[None, :],
                c.v_min, c.v_max)                    # (B, K)
            bpos = (Tz - c.v_min) / dz
            lo = torch.clamp(torch.floor(bpos), 0, K - 1)
            hi = torch.clamp(lo + 1, 0, K - 1)
            w_lo = (hi - bpos) + (lo == hi)
            w_hi = bpos - lo
            onehot_lo = F.one_hot(lo.long(), K).to(p_a.dtype)
            onehot_hi = F.one_hot(hi.long(), K).to(p_a.dtype)
            return (p_a[:, :, None] * (w_lo[:, :, None] * onehot_lo
                                       + w_hi[:, :, None] * onehot_hi)
                    ).sum(1)

    def _loss_c51(self, b, noise):
        """Distributional C51 (reference rainbow): cross-entropy to the
        projected target; the per-sample cross-entropy doubles as the
        priority signal."""
        K = self.config.num_atoms
        logits = self.module.forward_dist(b["obs"], noise[0])
        logp_sa = torch.log_softmax(logits.gather(
            1, b["actions"].long()[:, None, None].expand(-1, 1, K))[:, 0],
            -1)                                      # (B, K)
        m = self._c51_target(b, noise)
        xent = -(m * logp_sa).sum(-1)                # (B,)
        w = b.get("weights", torch.ones_like(xent))
        return (w * xent).mean(), xent.detach()

    def draw_noise(self) -> tuple:
        """An update's three NoisyNet draws, on the learner's device (or
        Nones when the module is not noisy)."""
        draws = [self.module.draw_noise(self._noise_gen) for _ in range(3)]
        return tuple(None if d is None else
                     {k: tuple(e.to(self.device) for e in v)
                      for k, v in d.items()} for d in draws)

    def _update(self, batch: Dict[str, Any], noise: tuple) -> tuple:
        """One update on `batch` (arrays or tensors; `batch_indexes`
        ignored) with the given noise draws: (loss, per-sample TD error
        or cross-entropy), both tensors on the device."""
        dtype = self.module.q[0].weight.dtype
        b = {k: torch.as_tensor(v, device=self.device)
             for k, v in batch.items() if k != "batch_indexes"}
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in b.items()}
        loss_fn = (self._loss_c51 if self.config.num_atoms > 1
                   else self._loss_scalar)
        loss, td = loss_fn(b, noise)
        params = list(self.module.parameters())
        descend(self._opt, params, torch.autograd.grad(loss, params))
        return loss.detach(), td

    # ------------------------------------------------------------- api
    def get_weights(self) -> Dict[str, torch.Tensor]:
        return _host(self.module.state_dict())

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        weights = self.get_weights()
        if self._remote:
            import ray_tpu_torch
            ref = ray_tpu_torch.put(weights)
            # weights FIRST (actor-call ordering applies them before the
            # sample), matching the local path's semantics
            for r in self._runners:
                r.set_weights.remote(ref)
            batches = ray_tpu_torch.get([
                r.sample.remote(c.rollout_steps_per_iteration)
                for r in self._runners])
        else:
            self._runners[0].set_weights(weights)
            batches = [self._runners[0].sample(
                c.rollout_steps_per_iteration)]
        for b in batches:
            if len(b["rewards"]):
                self.buffer.add(b)
                self._total_steps += len(b["rewards"])

        loss = float("nan")
        if self._total_steps >= c.learning_starts:
            for _ in range(c.num_updates_per_iteration):
                batch = self.buffer.sample(c.train_batch_size)
                loss_t, td = self._update(batch, self.draw_noise())
                loss = float(loss_t)
                self._num_updates += 1
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    self.buffer.update_priorities(
                        batch["batch_indexes"], td.cpu().numpy())
                if self._num_updates % c.target_network_update_freq == 0:
                    self.target.load_state_dict(self.module.state_dict())
        self.iteration += 1
        if self._remote:
            import ray_tpu_torch
            metrics = ray_tpu_torch.get(
                self._runners[0].get_metrics.remote())
        else:
            metrics = self._runners[0].get_metrics()
        metrics.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_steps,
            "num_updates_lifetime": self._num_updates,
            "td_loss": loss,
            "buffer_size": len(self.buffer),
            "time_iteration_s": time.perf_counter() - t0,
        })
        return metrics

    def get_state(self) -> Dict[str, Any]:
        """Checkpointable trainer state (replay buffer contents stay
        local — the reference's DQN checkpoints exclude them too by
        default)."""
        return {"params": self.get_weights(),
                "target_params": _host(self.target.state_dict()),
                "opt_state": _host(self._opt.state_dict()),
                "num_updates": self._num_updates,
                "total_steps": self._total_steps,
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.module.load_state_dict(state["params"])
        self.target.load_state_dict(state["target_params"])
        self._opt.load_state_dict(state["opt_state"])
        self._num_updates = state.get("num_updates", 0)
        self._total_steps = state.get("total_steps", 0)
        self.iteration = state.get("iteration", 0)

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


DQNConfig.algo_class = DQN
