"""DreamerV3: model-based RL via a recurrent state-space world model.

Port of `ray_tpu/rllib/algorithms/dreamerv3.py`. Parity (structure, not
scale) with reference rllib/algorithms/dreamerv3 (dreamerv3.py + tf
world_model.py / actor_network.py / critic_network.py, itself after
Hafner et al. 2023):
- RSSM world model: GRU deterministic path + categorical stochastic
  latents (straight-through gradients), encoder/decoder in symlog
  space, reward + continue heads, KL balancing with free bits.
- Actor + critic trained purely on IMAGINED rollouts through the world
  model: lambda-returns over predicted rewards/continues, return-range
  normalization (EMA of the 5th..95th percentile spread), entropy-
  regularized REINFORCE for the discrete actor.
- A recurrent acting loop carries (h, z) across real steps and resets
  them at episode boundaries.

Each update — world model, then actor and critic — runs on the
learner's device (the card unless `device="cpu"`). The JAX scans over
time (the posterior over the real sequence, the imagination, the
λ-returns) are loops over time here, with the stop-gradients where the
JAX code has them. Every random draw of an update (the posterior's
Gumbel noise, the imagination starts, the imagined actions' and
latents' Gumbel noise) is drawn up front from the learner's CPU
generator (`draw`) and passed in, so a learner on the card and one on
the CPU, or a test feeding the JAX draws, sample alike. Discrete action
spaces (the reference's Atari/gym path).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (_host, clip_by_global_norm_,
                                              descend)
from ray_tpu_torch.rllib.env.env_runner import make_env

_TINY = float(np.finfo(np.float32).tiny)


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws on the CPU, as `jax.random.gumbel` makes
    them: -log(-log(u)), u uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator).clamp_min(_TINY)
    return -torch.log(-torch.log(u))


def _mlp_layers(dims) -> nn.ModuleList:
    return nn.ModuleList(nn.utils.skip_init(nn.Linear, a, b)
                         for a, b in zip(dims[:-1], dims[1:]))


def _mlp(layers, x):
    for layer in layers[:-1]:
        x = F.silu(layer(x))
    return layers[-1](x)


class GRUCell(nn.Module):
    """The JAX GRU: gates in r, z, n order, `wi` on the input and `wh`
    on the state, each with a bias; h' = (1 - z)·n + z·h."""

    def __init__(self, din: int, dh: int):
        super().__init__()
        self.wi = nn.utils.skip_init(nn.Linear, din, 3 * dh)
        self.wh = nn.utils.skip_init(nn.Linear, dh, 3 * dh)

    def forward(self, h, x):
        ir, iz, inn = self.wi(x).chunk(3, dim=-1)
        hr, hz, hnn = self.wh(h).chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hnn)
        return (1.0 - z) * n + z * h


class WorldModel(nn.Module):
    """Encoder, GRU, prior, posterior, decoder, reward and continue
    heads (the JAX `wm` nest)."""

    def __init__(self, obs_dim: int, num_actions: int, c: "DreamerV3Config"):
        super().__init__()
        u, D = c.units, c.deter_dim
        z_dim = c.n_categoricals * c.n_classes
        feat = D + z_dim
        self.enc = _mlp_layers((obs_dim, u, c.embed_dim))
        self.gru = GRUCell(z_dim + num_actions, D)
        self.prior = _mlp_layers((D, u, z_dim))
        self.post = _mlp_layers((D + c.embed_dim, u, z_dim))
        self.dec = _mlp_layers((feat, u, obs_dim))
        self.rew = _mlp_layers((feat, u, 1))
        self.cont = _mlp_layers((feat, u, 1))


class DreamerModel(nn.Module):
    """The world model, the actor and the critic: the JAX package's
    `wm`, `actor` and `critic` nests, one module."""

    _WM_LISTS = ("enc", "prior", "post", "dec", "rew", "cont")

    def __init__(self, obs_dim: int, num_actions: int, c: "DreamerV3Config",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        u = c.units
        feat = c.deter_dim + c.n_categoricals * c.n_classes
        self.wm = WorldModel(obs_dim, num_actions, c)
        self.actor = _mlp_layers((feat, u, u, num_actions))
        self.critic = _mlp_layers((feat, u, u, 1))
        self.init(generator)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "DreamerModel":
        """Every dense weight normal × scale / √din and its bias zero:
        scale 1 but for the last layers of the reward head (0), the
        actor (0.01) and the critic (0), as the JAX init has them."""
        gen = generator or torch.Generator().manual_seed(0)
        groups = [(getattr(self.wm, k), 0.0 if k == "rew" else 1.0)
                  for k in self._WM_LISTS]
        groups += [(self.actor, 0.01), (self.critic, 0.0),
                   ([self.wm.gru.wi], 1.0), ([self.wm.gru.wh], 1.0)]
        for layers, last in groups:
            for i, layer in enumerate(layers):
                scale = last if i == len(layers) - 1 else 1.0
                dout, din = layer.weight.shape
                layer.weight.copy_(torch.randn((dout, din), generator=gen)
                                   * scale / math.sqrt(din))
                layer.bias.zero_()
        return self

    def dense_layout(self):
        """(JAX nest path, state-dict prefix) of every dense layer, the
        nest being {"wm": ..., "actor": [...], "critic": [...]}."""
        out = []
        for k in self._WM_LISTS:
            out += [(("wm", k, i), f"wm.{k}.{i}")
                    for i in range(len(getattr(self.wm, k)))]
        out += [(("wm", "gru", g), f"wm.gru.{g}") for g in ("wi", "wh")]
        for head in ("actor", "critic"):
            out += [((head, i), f"{head}.{i}")
                    for i in range(len(getattr(self, head)))]
        return out


@dataclasses.dataclass
class DreamerV3Config(AlgorithmConfig):
    # a gymnasium id, or a callable num_envs -> vector env
    env: Union[str, Callable[[int], Any]] = "CartPole-v1"
    num_envs: int = 16
    rollout_length: int = 32
    # --- world model
    deter_dim: int = 128                   # GRU state
    n_categoricals: int = 8
    n_classes: int = 8
    embed_dim: int = 64
    units: int = 128                       # MLP width
    wm_lr: float = 4e-4
    free_bits: float = 1.0
    kl_dyn_scale: float = 0.5
    kl_rep_scale: float = 0.1
    # --- behavior (imagination)
    horizon: int = 15
    gamma: float = 0.99
    gae_lambda: float = 0.95
    actor_lr: float = 4e-5
    critic_lr: float = 1e-4
    ent_coef: float = 3e-3
    imag_starts: int = 256                 # imagined trajectories/update
    num_updates_per_iteration: int = 4
    seed: int = 0
    # the learner's device: None = the card, "cpu" only by name
    device: Optional[str] = None


class DreamerV3:
    """sample (recurrent acting loop) -> world-model + behavior
    updates."""

    def __init__(self, config: DreamerV3Config):
        self.config = c = config
        self.device = resolve_device(c.device)
        self._envs = make_env(c.env, c.num_envs)
        space = self._envs.single_action_space
        if not hasattr(space, "n"):
            raise ValueError("DreamerV3 (this stack) needs a discrete "
                             "action space")
        self.obs_dim = int(np.prod(
            self._envs.single_observation_space.shape))
        self.num_actions = int(space.n)
        self.z_dim = c.n_categoricals * c.n_classes
        self.feat_dim = c.deter_dim + self.z_dim

        init_seed, draw_seed = (
            int(s) for s in np.random.SeedSequence(c.seed).generate_state(2))
        # drawn on the CPU, then moved: every device starts alike
        self.model = DreamerModel(
            self.obs_dim, self.num_actions, c,
            torch.Generator().manual_seed(init_seed)).to(self.device)
        self.wm, self.actor, self.critic = (self.model.wm, self.model.actor,
                                            self.model.critic)
        self._opts = [torch.optim.Adam(m.parameters(), lr=lr, eps=1e-8)
                      for m, lr in ((self.wm, c.wm_lr),
                                    (self.actor, c.actor_lr),
                                    (self.critic, c.critic_lr))]
        # return-range EMA (reference's percentile return normalizer)
        self.ret_scale = torch.tensor(1.0, device=self.device)
        self._gen = torch.Generator().manual_seed(draw_seed)

        self._obs, _ = self._envs.reset(seed=c.seed)
        self._h = torch.zeros((c.num_envs, c.deter_dim), device=self.device)
        self._z = torch.zeros((c.num_envs, self.z_dim), device=self.device)
        self._prev_a = np.zeros(c.num_envs, np.int64)
        self._prev_done = np.zeros(c.num_envs, bool)
        self._ep_ret = np.zeros(c.num_envs)
        self._recent: list = []
        self._total_steps = 0
        self.iteration = 0

    @property
    def _dtype(self):
        return self.critic[0].weight.dtype

    # ----------------------------------------------------- rssm pieces
    def _unimix(self, logits):
        """Unimixed (1% uniform) categorical log-probs, (..., n_cat,
        n_cls): the mix keeps gradients alive (reference)."""
        c = self.config
        lg = logits.reshape(logits.shape[:-1]
                            + (c.n_categoricals, c.n_classes))
        probs = 0.99 * torch.softmax(lg, -1) + 0.01 / c.n_classes
        return torch.log(probs)

    def _sample_z(self, logits, noise):
        """Straight-through categorical sample, its Gumbel `noise` of
        shape (..., n_cat, n_cls) -> (flat one-hot z, unimixed log-probs)."""
        c = self.config
        lg = self._unimix(logits)
        idx = (lg + noise).argmax(-1)
        one = F.one_hot(idx, c.n_classes).to(lg.dtype)
        sm = torch.softmax(lg, -1)
        st = one + sm - sm.detach()
        return st.reshape(st.shape[:-2] + (self.z_dim,)), lg

    @staticmethod
    def _kl(lhs_logits, rhs_logits):
        """KL(lhs || rhs) summed over categoricals (both already
        unimixed log-probs of shape (..., n_cat, n_cls))."""
        p = torch.exp(lhs_logits)
        return (p * (lhs_logits - rhs_logits)).sum((-2, -1))

    # ---------------------------------------------------------- draws
    def draw(self, T: int, N: int) -> Dict[str, torch.Tensor]:
        """Every random draw of one update on a (T, N) batch, from the
        learner's CPU generator, on its device: the posterior's Gumbel
        noise (T, N, n_cat, n_cls), the imagination starts (S,) of the
        T·N posterior states, and the imagined actions' (H, S, A) and
        latents' (H, S, n_cat, n_cls) Gumbel noise."""
        c = self.config
        S = min(c.imag_starts, T * N)
        H = c.horizon
        out = {"obs": gumbel((T, N, c.n_categoricals, c.n_classes),
                             self._gen),
               "start": torch.randperm(T * N, generator=self._gen)[:S],
               "act": gumbel((H, S, self.num_actions), self._gen),
               "z": gumbel((H, S, c.n_categoricals, c.n_classes),
                           self._gen)}
        return {k: v.to(self.device) for k, v in out.items()}

    # ---------------------------------------------------------- update
    def _observe(self, b, noise):
        """Posterior loop over the real sequence; returns per-step
        states + log-probs. b obs (T+1,N,D); actions (T,N)."""
        c = self.config
        wm = self.wm
        T, N = b["actions"].shape
        dtype = b["obs"].dtype
        embeds = _mlp(wm.enc, symlog(b["obs"]))        # (T+1, N, E)
        a_oh = F.one_hot(b["actions"].long(), self.num_actions).to(dtype)
        # state input at t uses a_{t-1} (zero at t=0)
        a_prev = torch.cat([torch.zeros_like(a_oh[:1]), a_oh[:-1]], 0)
        # reset at t where the previous step ended an episode
        reset = torch.cat([torch.ones((1, N), device=b["dones"].device,
                                      dtype=dtype), b["dones"][:-1]], 0)
        h = torch.zeros((N, c.deter_dim), device=b["obs"].device,
                        dtype=dtype)
        z = torch.zeros((N, self.z_dim), device=b["obs"].device,
                        dtype=dtype)
        hs, zs, post_lg, prior_lg = [], [], [], []
        for t in range(T):
            keep = (1.0 - reset[t])[:, None]
            h = wm.gru(h * keep, torch.cat([z * keep, a_prev[t]], -1))
            post_logits = _mlp(wm.post, torch.cat([h, embeds[t]], -1))
            z, post = self._sample_z(post_logits, noise[t])
            hs.append(h)
            zs.append(z)
            post_lg.append(post)
            prior_lg.append(self._unimix(_mlp(wm.prior, h)))
        return (torch.stack(hs), torch.stack(zs), torch.stack(post_lg),
                torch.stack(prior_lg))

    def _wm_loss(self, b, noise):
        c = self.config
        wm = self.wm
        T, N = b["actions"].shape
        m = b["mask"]
        obs_sym = symlog(b["obs"])
        hs, zs, post_lg, prior_lg = self._observe(b, noise)
        feat = torch.cat([hs, zs], -1)              # (T, N, F)
        recon = _mlp(wm.dec, feat)
        l_rec = (recon - obs_sym[:T]).square().sum(-1)
        rew_p = _mlp(wm.rew, feat)[..., 0]
        l_rew = (rew_p - symlog(b["rewards"])).square()
        cont_p = _mlp(wm.cont, feat)[..., 0]
        cont_t = 1.0 - b["terminateds"]
        # optax.sigmoid_binary_cross_entropy
        l_cont = (-cont_t * F.logsigmoid(cont_p)
                  - (1.0 - cont_t) * F.logsigmoid(-cont_p))
        # KL balancing + free bits (reference dreamerv3)
        kl_dyn = self._kl(post_lg.detach(), prior_lg)
        kl_rep = self._kl(post_lg, prior_lg.detach())
        l_kl = (c.kl_dyn_scale * torch.clamp(kl_dyn, min=c.free_bits)
                + c.kl_rep_scale * torch.clamp(kl_rep, min=c.free_bits))
        denom = m.sum().clamp_min(1.0)
        loss = ((l_rec + l_rew + l_cont + l_kl) * m).sum() / denom
        stats = {"wm_loss": loss,
                 "recon_loss": (l_rec * m).sum() / denom,
                 "reward_loss": (l_rew * m).sum() / denom,
                 "kl_dyn": (kl_dyn * m).sum() / denom}
        return loss, feat, stats

    @torch.no_grad()
    def _imagine(self, start_feat, act_noise, z_noise):
        """Roll the actor through the PRIOR for `horizon` steps. The
        features are stop-gradient'd where they are used, so nothing of
        this loop keeps a graph."""
        D = self.config.deter_dim
        wm = self.wm
        h, z = start_feat[:, :D], start_feat[:, D:]
        feats, acts = [], []
        for t in range(self.config.horizon):
            feat = torch.cat([h, z], -1)
            a = (_mlp(self.actor, feat) + act_noise[t]).argmax(-1)
            a_oh = F.one_hot(a, self.num_actions).to(feat.dtype)
            h = wm.gru(h, torch.cat([z, a_oh], -1))
            z, _ = self._sample_z(_mlp(wm.prior, h), z_noise[t])
            feats.append(feat)
            acts.append(a)
        return torch.stack(feats), torch.stack(acts)

    def _lambda_returns(self, rew, disc, v):
        """λ-returns (H-1, B), bootstrapped from the last value."""
        lam = self.config.gae_lambda
        rets = torch.empty_like(v[:-1])
        carry = v[-1]
        for t in range(v.shape[0] - 2, -1, -1):
            carry = rew[t] + disc[t] * ((1 - lam) * v[t + 1] + lam * carry)
            rets[t] = carry
        return rets

    def _behavior_losses(self, start_feat, ret_scale, act_noise, z_noise):
        c = self.config
        wm = self.wm
        feats, acts = self._imagine(start_feat, act_noise, z_noise)
        with torch.no_grad():
            rew = symexp(_mlp(wm.rew, feats)[..., 0])
            cont = torch.sigmoid(_mlp(wm.cont, feats)[..., 0])
        disc = c.gamma * cont
        v = _mlp(self.critic, feats)[..., 0]          # (H, B)
        rets = self._lambda_returns(rew, disc, v.detach())
        v_loss = (v[:-1] - rets).square().mean()
        # return-range normalization (EMA of P95-P5 spread)
        flat = rets.reshape(-1)
        spread = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)
        new_scale = 0.99 * ret_scale + 0.01 * spread
        adv = (rets - v[:-1].detach()) / torch.clamp(new_scale, min=1.0)
        logp = torch.log_softmax(_mlp(self.actor, feats[:-1]), -1)
        lp_a = logp.gather(-1, acts[:-1][..., None])[..., 0]
        ent = -(logp.exp() * logp).sum(-1)
        a_loss = (-adv * lp_a - c.ent_coef * ent).mean()
        return a_loss, v_loss, new_scale, {
            "actor_loss": a_loss, "critic_loss": v_loss,
            "imag_return_mean": rets.mean(),
            "actor_entropy": ent.mean(), "ret_scale": new_scale}

    @staticmethod
    def _descend(opt, params, grads) -> None:
        clip_by_global_norm_(grads, 100.0)
        descend(opt, params, grads)

    def _update(self, batch: Dict[str, Any],
                draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update on `batch` with the draws `draw` makes: the world
        model's step, then the actor's and the critic's on imagination
        from the updated world model. Returns the stats as tensors."""
        dtype = self._dtype
        b = {k: torch.as_tensor(v, device=self.device) for k, v in
             batch.items()}
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in b.items()}
        draws = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in draws.items()}
        wm_opt, actor_opt, critic_opt = self._opts
        wl, feat, wm_stats = self._wm_loss(b, draws["obs"])
        wm_params = list(self.wm.parameters())
        self._descend(wm_opt, wm_params,
                      list(torch.autograd.grad(wl, wm_params)))

        # imagination starts: subsample posterior states
        T, N = b["actions"].shape
        start = feat.detach().reshape(T * N, -1)[draws["start"]]

        # one combined grad pass: a_loss's critic dependence and
        # v_loss's actor dependence are both stop-gradient'd, so
        # d(a_loss+v_loss)/d(actor,critic) equals the separate gradients
        a_loss, v_loss, new_scale, b_stats = self._behavior_losses(
            start, self.ret_scale.to(dtype), draws["act"], draws["z"])
        actor_params = list(self.actor.parameters())
        critic_params = list(self.critic.parameters())
        grads = torch.autograd.grad(a_loss + v_loss,
                                    actor_params + critic_params)
        self._descend(actor_opt, actor_params,
                      list(grads[:len(actor_params)]))
        self._descend(critic_opt, critic_params,
                      list(grads[len(actor_params):]))
        self.ret_scale = new_scale.detach()
        return {k: v.detach() for k, v in {**wm_stats, **b_stats}.items()}

    # ------------------------------------------------------------- api
    @torch.no_grad()
    def _act(self, obs: np.ndarray) -> np.ndarray:
        """One acting step for every env: the posterior from the carried
        (h, z), then an action sampled from the actor."""
        c = self.config
        wm = self.wm
        dtype = self._dtype
        g_z = gumbel((c.num_envs, c.n_categoricals, c.n_classes),
                     self._gen).to(self.device, dtype)
        g_a = gumbel((c.num_envs, self.num_actions),
                     self._gen).to(self.device, dtype)
        keep = torch.as_tensor(1.0 - self._prev_done.astype(np.float32),
                               device=self.device).to(dtype)[:, None]
        a_oh = F.one_hot(torch.as_tensor(self._prev_a, device=self.device),
                         self.num_actions).to(dtype) * keep
        h = wm.gru(self._h * keep, torch.cat([self._z * keep, a_oh], -1))
        embed = _mlp(wm.enc, symlog(torch.as_tensor(
            obs, device=self.device).to(dtype)))
        z, _ = self._sample_z(_mlp(wm.post, torch.cat([h, embed], -1)), g_z)
        a = (_mlp(self.actor, torch.cat([h, z], -1)) + g_a).argmax(-1)
        self._h, self._z = h, z
        return a.cpu().numpy()

    def _sample(self) -> Dict[str, np.ndarray]:
        c = self.config
        T, N = c.rollout_length, c.num_envs
        obs_buf = np.empty((T + 1, N, self.obs_dim), np.float32)
        act_buf = np.empty((T, N), np.int32)
        rew_buf = np.empty((T, N), np.float32)
        term_buf = np.empty((T, N), np.float32)
        done_buf = np.empty((T, N), np.float32)
        mask_buf = np.empty((T, N), np.float32)
        for t in range(T):
            obs_f = self._obs.reshape(N, -1).astype(np.float32)
            obs_buf[t] = obs_f
            a = self._act(obs_f)
            nobs, rew, term, trunc, _ = self._envs.step(a)
            done = term | trunc
            valid = ~self._prev_done
            act_buf[t] = a
            rew_buf[t] = rew
            term_buf[t] = term.astype(np.float32)
            done_buf[t] = done.astype(np.float32)
            mask_buf[t] = valid.astype(np.float32)
            self._ep_ret[valid] += rew[valid]
            for i in np.nonzero(done & valid)[0]:
                self._recent.append(float(self._ep_ret[i]))
                self._ep_ret[i] = 0.0
            self._recent = self._recent[-100:]
            self._prev_a = a.astype(np.int64)
            self._prev_done = done
            self._obs = nobs
            self._total_steps += N
        obs_buf[T] = self._obs.reshape(N, -1).astype(np.float32)
        return {"obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
                "terminateds": term_buf, "dones": done_buf,
                "mask": mask_buf}

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        batch = self._sample()
        dev = {k: torch.as_tensor(v, device=self.device)
               for k, v in batch.items()}
        T, N = batch["actions"].shape
        stats_t: Dict[str, torch.Tensor] = {}
        for _ in range(self.config.num_updates_per_iteration):
            stats_t = self._update(dev, self.draw(T, N))
        stats = dict(zip(stats_t, torch.stack(list(stats_t.values()))
                         .tolist())) if stats_t else {}
        self.iteration += 1
        stats.update({
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(self._recent))
                                    if self._recent else float("nan")),
            "num_episodes": len(self._recent),
            "num_env_steps_sampled_lifetime": self._total_steps,
            "time_iteration_s": time.perf_counter() - t0,
        })
        return stats

    def get_state(self) -> Dict[str, Any]:
        state = _host(self.model.state_dict())
        return {"wm": {k[3:]: v for k, v in state.items()
                       if k.startswith("wm.")},
                "actor": {k[6:]: v for k, v in state.items()
                          if k.startswith("actor.")},
                "critic": {k[7:]: v for k, v in state.items()
                           if k.startswith("critic.")},
                "opts": [_host(o.state_dict()) for o in self._opts],
                "ret_scale": float(self.ret_scale),
                "key": self._gen.get_state(),
                "total_steps": self._total_steps,
                "iteration": self.iteration}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.wm.load_state_dict(state["wm"])
        self.actor.load_state_dict(state["actor"])
        self.critic.load_state_dict(state["critic"])
        if "opts" in state:
            for o, s in zip(self._opts, state["opts"]):
                o.load_state_dict(s)
        self.ret_scale = torch.tensor(float(state.get("ret_scale", 1.0)),
                                      device=self.device)
        if "key" in state:
            self._gen.set_state(state["key"])
        self._total_steps = state.get("total_steps", 0)
        self.iteration = state.get("iteration", 0)

    def stop(self) -> None:
        self._envs.close()


DreamerV3Config.algo_class = DreamerV3
