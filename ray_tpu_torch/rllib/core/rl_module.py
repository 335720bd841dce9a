"""RLModule-equivalent: the neural net + action-distribution bundle.

Port of `ray_tpu/rllib/core/rl_module.py`. The JAX modules are frozen
dataclasses whose `init(key)` returns a param tree; here each is an
`nn.Module` that holds its parameters and draws them from an explicit
`torch.Generator` (`init(generator)`, also called by the constructor,
which draws nothing from the global RNG). `Categorical` and
`DiagGaussian` are functions on tensors.

The env runners sample in numpy (`forward_policy_np`, `sample_np`), as
the JAX runners do, on a nest of numpy arrays in the JAX package's own
layout: `to_numpy_params` makes it from a state dict, and
`from_jax_params` carries such a nest (or a JAX param tree) back into a
state dict. Two layouts differ: a dense weight is `(din, dout)` there
and `(dout, din)` in `nn.Linear`; a conv weight is HWIO there and OIHW
in `nn.Conv2d`. The conv torso flattens its last feature map in NHWC
`(h, w, c)` order, as the JAX torso does, so its weight carries across
by a transpose alone.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LOG_2PI = 1.8378770664093453


class Categorical:
    """Categorical distribution over logits."""

    @staticmethod
    def sample(logits: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        probs = torch.softmax(logits, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator).reshape(
            logits.shape[:-1])

    @staticmethod
    def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        return logp.gather(-1, actions.long()[..., None])[..., 0]

    @staticmethod
    def entropy(logits: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        return -(logp.exp() * logp).sum(-1)


class DiagGaussian:
    """Diagonal gaussian over continuous actions (state-independent
    log_std, the reference's default for Box spaces). All shapes
    (..., A); log_prob/entropy reduce over the action dim."""

    @staticmethod
    def sample(mean: torch.Tensor, log_std: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
        return mean + log_std.exp() * noise

    @staticmethod
    def log_prob(mean: torch.Tensor, log_std: torch.Tensor,
                 actions: torch.Tensor) -> torch.Tensor:
        z = (actions - mean) * torch.exp(-log_std)
        return (-0.5 * z.square() - log_std - 0.5 * _LOG_2PI).sum(-1)

    @staticmethod
    def entropy(log_std: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Entropy broadcast to `like`'s leading shape (state-independent
        std makes it constant per state)."""
        ent = (log_std + 0.5 * (_LOG_2PI + 1.0)).sum(-1)
        return ent.expand(like.shape[:-1])


def _linear(din: int, dout: int) -> nn.Linear:
    # built without drawing: `init` fills it from an explicit generator
    return nn.utils.skip_init(nn.Linear, din, dout)


class ActorCriticModule(nn.Module):
    """MLP torso with separate policy/value heads.

    Mirrors the reference's default RLModule for classic-control tasks
    (rllib/core/rl_module/default_model_config.py): tanh MLP encoder,
    scalar value head, and either a categorical head (Discrete spaces;
    `num_actions` = n) or a diag-gaussian head with state-independent
    log_std (Box spaces; `continuous=True`, `num_actions` = action dim).
    """

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), continuous: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim, self.num_actions = obs_dim, num_actions
        self.hidden, self.continuous = tuple(hidden), continuous
        for head, out_dim in (("pi", num_actions), ("vf", 1)):
            dims = (obs_dim,) + self.hidden + (out_dim,)
            setattr(self, head, nn.ModuleList(
                _linear(a, b) for a, b in zip(dims[:-1], dims[1:])))
        if continuous:
            self.log_std = nn.Parameter(torch.zeros(num_actions))
        self.init(generator)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "ActorCriticModule":
        """Orthogonal weights (gain √2 on hidden layers, 0.01 on the
        policy output, 1.0 on the value output), zero biases, zero
        log_std, drawn from `generator` (seed 0 when None)."""
        gen = generator or torch.Generator().manual_seed(0)
        for head, out_gain in (("pi", 0.01), ("vf", 1.0)):
            layers = getattr(self, head)
            for i, layer in enumerate(layers):
                gain = out_gain if i == len(layers) - 1 else math.sqrt(2.0)
                w = torch.empty(layer.weight.shape)
                nn.init.orthogonal_(w, gain, generator=gen)
                layer.weight.copy_(w)
                layer.bias.zero_()
        if self.continuous:
            self.log_std.zero_()
        return self

    # ------------------------------------------- distribution dispatch
    def dist_log_prob(self, pi_out: torch.Tensor,
                      actions: torch.Tensor) -> torch.Tensor:
        if self.continuous:
            return DiagGaussian.log_prob(pi_out, self.log_std, actions)
        return Categorical.log_prob(pi_out, actions)

    def dist_entropy(self, pi_out: torch.Tensor) -> torch.Tensor:
        if self.continuous:
            return DiagGaussian.entropy(self.log_std, pi_out)
        return Categorical.entropy(pi_out)

    @staticmethod
    def _mlp(layers, x):
        for layer in layers[:-1]:
            x = torch.tanh(layer(x))
        return layers[-1](x)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs (..., obs_dim) -> (logits (..., A), value (...))."""
        return self._mlp(self.pi, obs), self._mlp(self.vf, obs)[..., 0]

    def action_logp(self, obs: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _ = self(obs)
        action = Categorical.sample(logits, generator)
        return action, Categorical.log_prob(logits, action)

    # ----------------------------------------------- numpy (env runner)
    @staticmethod
    def forward_policy_np(params_np: dict, obs):
        """Pure-numpy policy logits for env-runner-side inference, on
        the nest `to_numpy_params` makes.

        A classic-control MLP costs less in numpy than the dispatch of a
        framework call, so the env runner samples with plain numpy
        (mathematically identical to `forward`'s policy head) and leaves
        torch to the learner, whose batches are large."""
        x = obs
        layers = params_np["pi"]
        for layer in layers[:-1]:
            x = np.tanh(x @ layer["w"] + layer["b"])
        return x @ layers[-1]["w"] + layers[-1]["b"]

    def sample_np(self, logits, rng, params_np: Optional[dict] = None):
        """Numpy action sample + log-prob (env-runner side).

        Discrete: Gumbel-max categorical. Continuous (needs params_np
        for log_std): diag-gaussian around the mean head."""
        if self.continuous:
            log_std = np.asarray(params_np["log_std"])
            std = np.exp(log_std)
            action = logits + std * rng.standard_normal(logits.shape)
            z = (action - logits) / std
            logp = (-0.5 * np.square(z) - log_std
                    - 0.5 * _LOG_2PI).sum(-1)
            return action.astype(np.float32), logp.astype(np.float32)
        z = logits - logits.max(axis=-1, keepdims=True)
        logp_all = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
        g = rng.gumbel(size=logits.shape)
        action = np.argmax(logits + g, axis=-1)
        logp = np.take_along_axis(
            logp_all, action[..., None], axis=-1)[..., 0]
        return action.astype(np.int32), logp.astype(np.float32)


class ConvActorCriticModule(nn.Module):
    """CNN torso for pixel observations (reference model catalog's
    default conv_filters for image spaces, rllib/models/catalog.py) —
    NHWC conv stack -> flatten -> dense -> policy/value heads. Integer
    (uint8) inputs are normalized to [0, 1] inside forward, keyed on
    dtype; float inputs are assumed pre-scaled (the EnvRunner scales
    integer env observations in numpy before buffering)."""

    def __init__(self, obs_shape: Tuple[int, int, int], num_actions: int,
                 conv_filters: Sequence[Tuple[int, int, int]] = (
                     (16, 8, 4), (32, 4, 2), (32, 3, 1)),
                 hidden: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_shape = tuple(obs_shape)             # (H, W, C)
        self.num_actions, self.hidden = num_actions, hidden
        self.conv_filters = tuple(tuple(f) for f in conv_filters)
        h, w, c_in = self.obs_shape
        convs = []
        for c_out, k, s in self.conv_filters:
            convs.append(nn.utils.skip_init(nn.Conv2d, c_in, c_out, k,
                                            stride=s))
            h = -(-(h - k + 1) // s)          # VALID conv output size
            w = -(-(w - k + 1) // s)
            c_in = c_out
        flat = h * w * c_in
        if flat <= 0:
            raise ValueError(
                f"conv_filters collapse {self.obs_shape} to nothing")
        self.conv = nn.ModuleList(convs)
        self.torso = _linear(flat, hidden)
        self.pi = _linear(hidden, num_actions)
        self.vf = _linear(hidden, 1)
        self.init(generator)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None
             ) -> "ConvActorCriticModule":
        """He-normal convs, dense layers normal × scale / √din (1.0 on
        the torso and value, 0.01 on the policy), zero biases."""
        gen = generator or torch.Generator().manual_seed(0)
        for conv in self.conv:
            c_out, c_in, k, _ = conv.weight.shape
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * math.sqrt(2.0 / (k * k * c_in)))
            conv.bias.zero_()
        for layer, scale in ((self.torso, 1.0), (self.pi, 0.01),
                             (self.vf, 1.0)):
            din = layer.weight.shape[1]
            layer.weight.copy_(torch.randn(layer.weight.shape,
                                           generator=gen)
                               * scale / math.sqrt(din))
            layer.bias.zero_()
        return self

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs (..., H, W, C) uint8/float -> (logits (..., A),
        value (...))."""
        lead = obs.shape[:-3]
        x = obs.reshape((-1,) + self.obs_shape)
        # normalization keyed on dtype, not batch content
        is_int = not (x.is_floating_point() or x.is_complex())
        x = x.to(self.torso.weight.dtype)     # float32 as built
        if is_int:
            x = x / 255.0
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for conv in self.conv:
            x = F.relu(conv(x))
        # flatten in NHWC (h, w, c) order, as the JAX torso does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.tanh(self.torso(x))
        logits = self.pi(x)
        value = self.vf(x)[..., 0]
        return (logits.reshape(lead + (self.num_actions,)),
                value.reshape(lead))

    def dist_log_prob(self, pi_out, actions):
        return Categorical.log_prob(pi_out, actions)

    def dist_entropy(self, pi_out):
        return Categorical.entropy(pi_out)


# ------------------------------------------------------ weights across
def _dense_pairs(module: nn.Module):
    """(nest path, state-dict prefix) of every dense layer, in the JAX
    nest's layout: `pi`/`vf` lists for the MLP, single dicts for the conv
    module's `torso`/`pi`/`vf`; a module of another layout lists its own
    (`dense_layout()`)."""
    if hasattr(module, "dense_layout"):
        return module.dense_layout()
    if isinstance(module, ActorCriticModule):
        return [((head, i), f"{head}.{i}") for head in ("pi", "vf")
                for i in range(len(getattr(module, head)))]
    if isinstance(module, ConvActorCriticModule):
        return [((name,), name) for name in ("torso", "pi", "vf")]
    raise TypeError(f"no weight layout for {type(module).__name__}")


def _nest_get(nest, path):
    for p in path:
        nest = nest[p]
    return nest


def _nest_set(nest: dict, path, leaf) -> None:
    for p in path[:-1]:
        nest = nest.setdefault(p, {})
    nest[path[-1]] = leaf


def _lists(nest):
    """`nest` with every dict keyed 0..n-1 turned into a list."""
    if not isinstance(nest, dict):
        return nest
    out = {k: _lists(v) for k, v in nest.items()}
    if out and all(isinstance(k, int) for k in out) and \
            sorted(out) == list(range(len(out))):
        return [out[i] for i in range(len(out))]
    return out


# a dense leaf's JAX keys and their state-dict suffixes: weights are
# (din, dout) there and (dout, din) here; NoisyNet sigmas likewise
_DENSE_KEYS = (("w", "weight", True), ("b", "bias", False),
               ("w_sig", "w_sig", True), ("b_sig", "b_sig", False))


def from_jax_params(module: nn.Module, params) -> Dict[str, torch.Tensor]:
    """A JAX param tree (or the numpy nest `to_numpy_params` makes) ->
    `module`'s state dict, as CPU float32 tensors."""
    sd = {}
    for path, name in _dense_pairs(module):
        leaf = _nest_get(params, path)
        for key, suffix, transpose in _DENSE_KEYS:
            if key in leaf:
                v = np.asarray(leaf[key], np.float32)
                sd[f"{name}.{suffix}"] = torch.from_numpy(
                    np.array(v.T if transpose else v, order="C"))
    if isinstance(module, ConvActorCriticModule):
        for i, leaf in enumerate(params["conv"]):
            w = np.asarray(leaf["w"], np.float32)            # HWIO
            sd[f"conv.{i}.weight"] = torch.from_numpy(
                np.array(w.transpose(3, 2, 0, 1), order="C"))
            sd[f"conv.{i}.bias"] = torch.from_numpy(
                np.array(leaf["b"], np.float32))
    elif getattr(module, "continuous", False):
        sd["log_std"] = torch.from_numpy(
            np.array(params["log_std"], np.float32))
    return sd


def to_numpy_params(module: nn.Module, state_dict) -> dict:
    """`module`'s state dict (tensors or arrays, any device) -> the JAX
    package's param nest as contiguous numpy arrays: dense weights
    `(din, dout)`, conv weights HWIO. The env runners' numpy forward
    reads it, and `from_jax_params` takes it back."""
    def arr(key):
        v = state_dict[key]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float32)

    nest: dict = {}
    if isinstance(module, ConvActorCriticModule):
        nest["conv"] = [
            {"w": np.ascontiguousarray(
                arr(f"conv.{i}.weight").transpose(2, 3, 1, 0)),
             "b": arr(f"conv.{i}.bias").copy()}
            for i in range(len(module.conv))]
    elif getattr(module, "continuous", False):
        nest["log_std"] = arr("log_std").copy()
    for path, name in _dense_pairs(module):
        leaf = {}
        for key, suffix, transpose in _DENSE_KEYS:
            if f"{name}.{suffix}" in state_dict:
                v = arr(f"{name}.{suffix}")
                leaf[key] = np.ascontiguousarray(v.T) if transpose \
                    else v.copy()
        _nest_set(nest, path, leaf)
    return _lists(nest)
