"""APPO: asynchronous PPO — IMPALA's pipeline with a clipped surrogate.

Port of `ray_tpu/rllib/algorithms/appo.py`. Parity: reference
rllib/algorithms/appo/appo.py (+ appo_torch_learner): async env runners
feed a queued learner exactly as IMPALA does, but the policy loss is
PPO's clipped surrogate over V-trace advantages, with a periodically
refreshed TARGET network providing the stable old policy for a KL
regularizer (the reference's target_network_update_freq + use_kl_loss
path). Everything rides the IMPALA machinery: the same runner group,
sample queue and update step; only the loss and the target network
differ. The target network is a copy of the module on the learner's
device, refreshed every `target_network_update_freq` updates.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.algorithms.impala import (IMPALA, IMPALAConfig,
                                                   IMPALALearner,
                                                   IMPALALearnerConfig)
from ray_tpu_torch.rllib.core.learner import _host
from ray_tpu_torch.rllib.core.rl_module import Categorical


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    clip_eps: float = 0.2
    use_kl_loss: bool = True
    kl_coef: float = 0.2
    target_network_update_freq: int = 16    # learner updates per refresh


@dataclasses.dataclass
class APPOLearnerConfig(IMPALALearnerConfig):
    clip_eps: float = 0.2
    use_kl_loss: bool = True
    kl_coef: float = 0.2
    target_network_update_freq: int = 16


class APPOLearner(IMPALALearner):
    """V-trace advantages + clipped surrogate + target-network KL."""

    METRICS = ("policy_loss", "vf_loss", "entropy", "kl_to_target",
               "mean_rho")

    def __init__(self, config: APPOLearnerConfig):
        super().__init__(config)
        self.target = copy.deepcopy(self.module).requires_grad_(False)

    def _loss(self, b, denom):
        c = self.config
        logits, value, logp, vs, pg_adv, rho = self._vtrace_terms(b)
        m = b["mask"]
        # PPO clipped surrogate against the BEHAVIOUR policy's logp
        # (reference appo_torch_learner: ratio to the sampling policy,
        # advantages from v-trace)
        ratio = torch.exp(logp - b["logp"])
        surr = torch.minimum(
            ratio * pg_adv,
            ratio.clamp(1 - c.clip_eps, 1 + c.clip_eps) * pg_adv)
        pg_loss = -(surr * m).sum() / denom
        v_loss = 0.5 * ((vs - value[:-1]).square() * m).sum() / denom
        ent = (Categorical.entropy(logits) * m).sum() / denom
        total = pg_loss + c.vf_coef * v_loss - c.ent_coef * ent
        kl = torch.zeros((), device=total.device, dtype=total.dtype)
        if c.use_kl_loss:
            with torch.no_grad():
                t_logits, _ = self.target(b["obs"])
            t_logp_all = torch.log_softmax(t_logits[:-1], dim=-1)
            logp_all = torch.log_softmax(logits, dim=-1)
            kl_tn = (t_logp_all.exp() * (t_logp_all - logp_all)).sum(-1)
            kl = (kl_tn * m).sum() / denom
            total = total + c.kl_coef * kl
        mean_rho = (rho * m).sum() / denom
        return total, torch.stack([pg_loss, v_loss, ent, kl,
                                   mean_rho]).detach()

    def update(self, batch) -> Dict[str, float]:
        metrics = super().update(batch)
        if self.version % self.config.target_network_update_freq == 0:
            self.target.load_state_dict(self.module.state_dict())
        return metrics

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["target_params"] = _host(self.target.state_dict())
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        # the KL target net is part of the learner state (restoring
        # without it would regularize toward a random network)
        self.target.load_state_dict(
            {k: torch.as_tensor(v) for k, v in
             state.get("target_params", self.module.state_dict()).items()})


class APPO(IMPALA):
    """Asynchronous PPO on the IMPALA pipeline; its state carries the
    learner's target network (`APPOLearner.get_state`)."""

    LEARNER_CLS = APPOLearner
    LEARNER_CONFIG_CLS = APPOLearnerConfig


APPOConfig.algo_class = APPO
