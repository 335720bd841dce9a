"""SAC: off-policy maximum-entropy actor-critic for continuous control.

Port of `ray_tpu/rllib/algorithms/sac.py`. Parity: reference
rllib/algorithms/sac/sac.py (+ default_sac_rl_module / sac_learner) —
twin Q critics with target networks, squashed-Gaussian policy, and
entropy-coefficient autotuning toward a target entropy: flat-transition
numpy env runners feed a replay buffer, and one update on the learner's
device (the card unless `device="cpu"`) takes the critic, actor and
alpha steps, then the polyak target update, in the JAX order.

The reparameterization noise of an update (two standard-normal draws of
the action's shape: the critic's next action, then the actor's) is
drawn up front from the learner's CPU generator and passed in, so a
learner on the card and one on the CPU, or a test feeding the JAX
draws, sample the same actions. The alpha step's gradient is the JAX
one written out: -(mean log-prob + target entropy).
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
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0
_EPS = 1e-6
_LOG_2PI = math.log(2 * math.pi)
METRICS = ("critic_loss", "actor_loss", "alpha", "q_mean", "entropy")


def _mlp_layers(dims) -> nn.ModuleList:
    return nn.ModuleList(nn.utils.skip_init(nn.Linear, a, b)
                         for a, b in zip(dims[:-1], dims[1:]))


def _mlp(layers, x, act=torch.tanh):
    for layer in layers[:-1]:
        x = act(layer(x))
    return layers[-1](x)


class SACModule(nn.Module):
    """Squashed-Gaussian policy + twin Q critics (reference
    default_sac_rl_module.py): `pi` (tanh MLP to mean and log-std), `q1`
    and `q2` (ReLU MLPs on the concatenated obs and action)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.hidden = tuple(hidden)
        h = list(self.hidden)
        self.pi = _mlp_layers([obs_dim] + h + [2 * act_dim])
        self.q1 = _mlp_layers([obs_dim + act_dim] + h + [1])
        self.q2 = _mlp_layers([obs_dim + act_dim] + h + [1])
        self.init(generator)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "SACModule":
        """Orthogonal weights (gain √2 on hidden layers, 0.01 on the
        policy output, 1.0 on the Q outputs), zero biases, drawn from
        `generator` (seed 0 when None)."""
        gen = generator or torch.Generator().manual_seed(0)
        for head, out_scale in (("pi", 0.01), ("q1", 1.0), ("q2", 1.0)):
            layers = getattr(self, head)
            for i, layer in enumerate(layers):
                gain = out_scale if i == len(layers) - 1 else math.sqrt(2.0)
                w = torch.empty(layer.weight.shape)
                nn.init.orthogonal_(w, gain, generator=gen)
                layer.weight.copy_(w)
                layer.bias.zero_()
        return self

    def dense_layout(self):
        """(JAX nest path, state-dict prefix) of every dense layer."""
        return [((head, i), f"{head}.{i}") for head in ("pi", "q1", "q2")
                for i in range(len(getattr(self, head)))]

    # ------------------------------------------------------------ policy
    def pi_dist(self, obs):
        mean, log_std = _mlp(self.pi, obs).chunk(2, dim=-1)
        return mean, log_std.clamp(_LOG_STD_MIN, _LOG_STD_MAX)

    def sample_action(self, obs, noise):
        """Reparameterized squashed sample from standard-normal `noise`
        of the action's shape -> (action in [-1,1], logp)."""
        mean, log_std = self.pi_dist(obs)
        std = torch.exp(log_std)
        u = mean + std * noise
        a = torch.tanh(u)
        logp_u = (-0.5 * ((u - mean) / std).square() - log_std
                  - 0.5 * _LOG_2PI).sum(-1)
        # tanh change of variables (SAC paper appendix C)
        logp = logp_u - torch.log(1 - a.square() + _EPS).sum(-1)
        return a, logp

    # ------------------------------------------------------------ critic
    def q(self, which: str, obs, act):
        """Critic `which` ("q1" or "q2") at (obs, act)."""
        return _mlp(getattr(self, which), torch.cat([obs, act], -1),
                    act=F.relu)[..., 0]


class SACEnvRunner:
    """Vectorized continuous sampler emitting flat transitions; actions
    are squashed-Gaussian samples (numpy) scaled to the env bounds."""

    def __init__(self, config: "SACConfig", worker_index: int = 0):
        self.config = config
        seed = config.seed + 1000 * worker_index
        self._envs = make_env(config.env, config.num_envs_per_env_runner)
        space = self._envs.single_action_space
        if hasattr(space, "n"):
            raise ValueError("SAC needs a continuous (Box) action space")
        self._low = np.asarray(space.low, np.float32)
        self._high = np.asarray(space.high, np.float32)
        self.module = SACModule(
            int(np.prod(self._envs.single_observation_space.shape)),
            int(np.prod(space.shape)), tuple(config.hidden),
            torch.Generator().manual_seed(seed))
        self.set_weights(self.module.state_dict())
        self._rng = np.random.default_rng(seed + 1)
        self._obs, _ = self._envs.reset(seed=seed)
        self._prev_done = np.zeros(config.num_envs_per_env_runner, bool)
        self._steps = 0
        self._ep_ret = np.zeros(config.num_envs_per_env_runner)
        self._recent: list = []

    def ping(self):
        return "pong"

    def set_weights(self, weights) -> None:
        """`weights`: the learner's state dict (tensors or arrays)."""
        self.params = to_numpy_params(self.module, weights)

    def _policy_np(self, obs):
        x = obs
        for layer in self.params["pi"][:-1]:
            x = np.tanh(x @ layer["w"] + layer["b"])
        last = self.params["pi"][-1]
        out = x @ last["w"] + last["b"]
        mean, log_std = np.split(out, 2, axis=-1)
        return mean, np.clip(log_std, _LOG_STD_MIN, _LOG_STD_MAX)

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        c = self.config
        rows = {k: [] for k in ("obs", "actions", "rewards", "new_obs",
                                "terminateds")}
        N = c.num_envs_per_env_runner
        for _ in range(num_steps):
            obs32 = self._obs.astype(np.float32)
            if self._steps < c.random_steps:
                a = self._rng.uniform(-1.0, 1.0,
                                      (N, self.module.act_dim))
            else:
                mean, log_std = self._policy_np(obs32)
                u = mean + np.exp(log_std) * self._rng.standard_normal(
                    mean.shape)
                a = np.tanh(u)
            env_a = (self._low + (a.astype(np.float32) + 1.0)
                     * 0.5 * (self._high - self._low))
            nobs, reward, term, trunc, _ = self._envs.step(env_a)
            done = term | trunc
            valid = ~self._prev_done       # autoreset filler: drop
            rows["obs"].append(obs32[valid])
            rows["actions"].append(a[valid].astype(np.float32))
            rows["rewards"].append(reward[valid].astype(np.float32))
            rows["new_obs"].append(nobs[valid].astype(np.float32))
            rows["terminateds"].append(term[valid].astype(np.float32))
            self._ep_ret[valid] += reward[valid]
            for i in np.nonzero(done & valid)[0]:
                self._recent.append(float(self._ep_ret[i]))
                self._ep_ret[i] = 0.0
            self._recent = self._recent[-100:]
            self._prev_done = done
            self._obs = nobs
            self._steps += N
        return {k: np.concatenate(v) for k, v in rows.items()}

    def get_metrics(self) -> Dict[str, Any]:
        return {"episode_return_mean": (float(np.mean(self._recent))
                                        if self._recent else float("nan")),
                "num_episodes": len(self._recent),
                "num_env_steps_sampled": self._steps}

    def stop(self) -> None:
        self._envs.close()


@dataclasses.dataclass
class SACConfig(AlgorithmConfig):
    # a gymnasium id, or a callable num_envs -> vector env
    env: Union[str, Callable[[int], Any]] = "Pendulum-v1"
    num_env_runners: int = 0               # 0 = local
    num_envs_per_env_runner: int = 8
    rollout_steps_per_iteration: int = 32
    hidden: Sequence[int] = (256, 256)
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005                     # polyak target rate
    initial_alpha: float = 0.2
    target_entropy: Optional[float] = None  # default: -act_dim
    buffer_size: int = 100_000
    train_batch_size: int = 256
    num_updates_per_iteration: int = 256
    learning_starts: int = 1_000           # env steps before updates
    random_steps: int = 1_000              # uniform exploration warmup
    seed: int = 0
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None


class SAC:
    """Iterative trainer: sample -> buffer -> k SAC updates (critic +
    actor + alpha + polyak)."""

    def __init__(self, config: SACConfig):
        self.config = config
        c = config
        self.device = resolve_device(c.device)
        if c.num_env_runners == 0:
            self._runners = [SACEnvRunner(c)]
            self._remote = False
        else:
            import ray_tpu_torch
            cls = ray_tpu_torch.remote(num_cpus=1)(SACEnvRunner)
            self._runners = [cls.remote(c, worker_index=i + 1)
                             for i in range(c.num_env_runners)]
            self._remote = True
        obs_dim, act_dim = self._probe_dims()
        init_seed, noise_seed = (
            int(s) for s in np.random.SeedSequence(c.seed).generate_state(2))
        # drawn on the CPU, then moved: every device starts alike
        self.module = SACModule(
            obs_dim, act_dim, tuple(c.hidden),
            torch.Generator().manual_seed(init_seed)).to(self.device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.tensor(
            np.log(c.initial_alpha), dtype=torch.float32,
            device=self.device))
        self._target_entropy = (c.target_entropy
                                if c.target_entropy is not None
                                else -float(act_dim))
        self._pi_params = list(self.module.pi.parameters())
        self._q_params = (list(self.module.q1.parameters())
                          + list(self.module.q2.parameters()))
        self._actor_opt = torch.optim.Adam(self._pi_params, lr=c.actor_lr)
        self._critic_opt = torch.optim.Adam(self._q_params, lr=c.critic_lr)
        self._alpha_opt = torch.optim.Adam([self.log_alpha], lr=c.alpha_lr)
        self.buffer = ReplayBuffer(c.buffer_size, seed=c.seed)
        self._noise_gen = torch.Generator().manual_seed(noise_seed)
        self._num_updates = 0
        self._total_steps = 0
        self.iteration = 0

    def _probe_dims(self) -> Tuple[int, int]:
        obs_space, space = env_spaces(self.config.env)
        return (int(np.prod(obs_space.shape)),
                int(np.prod(space.shape)))

    # ---------------------------------------------------------- update
    def draw_noise(self, batch_size: int) -> torch.Tensor:
        """An update's two reparameterization draws, (2, B, act_dim),
        from the learner's CPU generator, on its device."""
        return torch.randn((2, batch_size, self.module.act_dim),
                           generator=self._noise_gen).to(self.device)

    def _update(self, batch: Dict[str, Any], noise) -> torch.Tensor:
        """One update on `batch` (arrays or tensors; `batch_indexes`
        ignored) with the draws `noise` (2, B, act_dim): the critic step,
        the actor step on the fresh critics, the alpha step, the polyak
        target update. Returns the METRICS, stacked, on the device."""
        c = self.config
        m = self.module
        dtype = self.log_alpha.dtype
        b = {k: torch.as_tensor(v, device=self.device).to(dtype)
             for k, v in batch.items() if k != "batch_indexes"}
        noise = noise.to(device=self.device, dtype=dtype)
        # --- critic step
        with torch.no_grad():
            next_a, next_logp = m.sample_action(b["new_obs"], noise[0])
            tq = torch.minimum(self.target.q("q1", b["new_obs"], next_a),
                               self.target.q("q2", b["new_obs"], next_a))
            alpha = torch.exp(self.log_alpha)
            y = b["rewards"] + c.gamma * (1 - b["terminateds"]) \
                * (tq - alpha * next_logp)
        q1 = m.q("q1", b["obs"], b["actions"])
        q2 = m.q("q2", b["obs"], b["actions"])
        closs = (q1 - y).square().mean() + (q2 - y).square().mean()
        q_mean = 0.5 * (q1.mean() + q2.mean())
        descend(self._critic_opt, self._q_params,
                torch.autograd.grad(closs, self._q_params))
        # --- actor step (fresh critics)
        a, logp = m.sample_action(b["obs"], noise[1])
        q = torch.minimum(m.q("q1", b["obs"], a), m.q("q2", b["obs"], a))
        alpha = torch.exp(self.log_alpha).detach()
        aloss = (alpha * logp - q).mean()
        logp_mean = logp.mean().detach()
        descend(self._actor_opt, self._pi_params,
                torch.autograd.grad(aloss, self._pi_params))
        # --- alpha step (entropy autotune, reference sac_learner): the
        # gradient of log_alpha, written out as JAX writes it
        descend(self._alpha_opt, [self.log_alpha],
                [-(logp_mean + self._target_entropy)])
        # --- polyak target update
        with torch.no_grad():
            for head in ("q1", "q2"):
                for t, p in zip(getattr(self.target, head).parameters(),
                                getattr(m, head).parameters()):
                    t.copy_((1 - c.tau) * t + c.tau * p)
            return torch.stack([closs.detach(), aloss.detach(),
                                torch.exp(self.log_alpha), q_mean.detach(),
                                -logp_mean])

    # --------------------------------------------------------------- api
    def get_weights(self) -> Dict[str, torch.Tensor]:
        return _host(self.module.state_dict())

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        weights = self.get_weights()
        if self._remote:
            import ray_tpu_torch
            ref = ray_tpu_torch.put(weights)
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
            self.buffer.add(b)
            self._total_steps += len(b["rewards"])

        stats = None
        if self._total_steps >= c.learning_starts:
            for _ in range(c.num_updates_per_iteration):
                batch = self.buffer.sample(c.train_batch_size)
                stats = self._update(batch,
                                     self.draw_noise(c.train_batch_size))
                self._num_updates += 1
        self.iteration += 1
        if self._remote:
            import ray_tpu_torch
            metrics = ray_tpu_torch.get(self._runners[0].get_metrics.remote())
        else:
            metrics = self._runners[0].get_metrics()
        if stats is not None:
            metrics.update(zip(METRICS, stats.tolist()))
        metrics.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_steps,
            "num_updates_lifetime": self._num_updates,
            "buffer_size": len(self.buffer),
            "time_iteration_s": time.perf_counter() - t0,
        })
        return metrics

    def get_state(self) -> Dict[str, Any]:
        target = _host(self.target.state_dict())
        return {"params": self.get_weights(),
                "target_q": {k: v for k, v in target.items()
                             if not k.startswith("pi.")},
                "log_alpha": float(self.log_alpha.detach()),
                "iteration": self.iteration,
                "total_steps": self._total_steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.module.load_state_dict(state["params"])
        self.target.load_state_dict({**self.target.state_dict(),
                                     **state["target_q"]})
        with torch.no_grad():
            self.log_alpha.fill_(float(state["log_alpha"]))
        self.iteration = state.get("iteration", 0)
        self._total_steps = state.get("total_steps", 0)

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


SACConfig.algo_class = SAC
