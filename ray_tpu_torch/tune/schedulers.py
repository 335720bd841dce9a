"""Trial schedulers: FIFO, ASHA early stopping, PBT.

Port of `ray_tpu/tune/schedulers.py`, a copy.

Parity: reference tune/schedulers/async_hyperband.py
(AsyncHyperBandScheduler/ASHAScheduler) — the asynchronous successive
halving rule: rungs at grace_period * reduction_factor^k; when a trial
reports at a rung, it continues only if it is in the top 1/rf of
everything that has reached that rung so far. And
tune/schedulers/pbt.py (PopulationBasedTraining) — exploit/explore:
bottom-quantile trials inherit a top-quantile trial's checkpoint and a
perturbed copy of its config.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    """Run every trial to completion (reference FIFOScheduler)."""

    def on_result(self, trial_id: str, step: int, metrics: Dict) -> str:
        return CONTINUE


class ASHAScheduler:
    def __init__(self, metric: str, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        # rung milestones: grace, grace*rf, grace*rf^2, ... < max_t
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung milestone -> recorded metric values (sign-normalised: max)
        self._recorded: Dict[int, List[float]] = {r: [] for r in self.rungs}
        self._trial_rung: Dict[str, int] = {}   # highest rung passed

    def _val(self, metrics: Dict) -> float:
        v = float(metrics[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial_id: str, step: int, metrics: Dict) -> str:
        if step >= self.max_t:
            return STOP                      # budget exhausted (normal)
        if self.metric not in metrics:
            return CONTINUE
        v = self._val(metrics)
        decision = CONTINUE
        for rung in self.rungs:
            if step < rung or self._trial_rung.get(trial_id, -1) >= rung:
                continue
            self._trial_rung[trial_id] = rung
            rec = self._recorded[rung]
            rec.append(v)
            if len(rec) >= self.rf:
                # keep only the top 1/rf of what reached this rung
                cutoff = sorted(rec, reverse=True)[
                    max(0, len(rec) // self.rf - 1)]
                if v < cutoff:
                    decision = STOP
        return decision


class PopulationBasedTraining:
    """PBT (reference tune/schedulers/pbt.py): every
    `perturbation_interval` reports, a trial in the bottom
    `quantile_fraction` of the population exploits a random trial from
    the top quantile — inherits its checkpoint (the controller handles
    the transfer) and a mutated copy of its config.

    `hyperparam_mutations` values may be: a list (resample = random
    choice), a tune Domain (resample = domain.sample), or a callable
    () -> value. Non-resampled continuous params multiply by 0.8 / 1.2
    (the reference's explore defaults, pbt.py _explore).
    """

    def __init__(self, metric: str, mode: str = "max",
                 perturbation_interval: int = 2,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 seed: int = 0):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        if not 0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        if not hyperparam_mutations:
            raise ValueError("hyperparam_mutations must be non-empty")
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.mutations = dict(hyperparam_mutations)
        self._rng = random.Random(seed)
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._scores: Dict[str, float] = {}     # sign-normalized (max)
        self._last_perturb: Dict[str, int] = {}
        self.num_exploits = 0

    # controller hook: record each trial's live config
    def on_trial_add(self, trial_id: str, config: Dict[str, Any]) -> None:
        self._configs[trial_id] = dict(config)
        self._last_perturb.setdefault(trial_id, 0)

    def _quantiles(self):
        ranked = sorted(self._scores, key=self._scores.get)
        k = max(1, int(len(ranked) * self.quantile))
        if len(ranked) < 2 * k:
            return [], []
        return ranked[:k], ranked[-k:]          # (bottom, top)

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search import Domain
        new = dict(config)
        for key, mut in self.mutations.items():
            resample = self._rng.random() < self.resample_p
            cur = new.get(key)
            if isinstance(mut, list):
                if resample or cur not in mut:
                    new[key] = self._rng.choice(mut)
                else:
                    # shift to a neighboring value (reference pbt.py:
                    # continuous lists perturb by index +-1)
                    i = mut.index(cur)
                    j = min(max(i + self._rng.choice((-1, 1)), 0),
                            len(mut) - 1)
                    new[key] = mut[j]
            elif isinstance(mut, Domain):
                if resample or not isinstance(cur, (int, float)):
                    new[key] = mut.sample(self._rng)
                else:
                    new[key] = cur * self._rng.choice((0.8, 1.2))
            elif callable(mut):
                new[key] = mut()
            else:
                raise TypeError(f"unsupported mutation spec for {key!r}")
        return new

    def on_result(self, trial_id: str, step: int, metrics: Dict):
        if self.metric not in metrics:
            return CONTINUE
        v = float(metrics[self.metric])
        self._scores[trial_id] = v if self.mode == "max" else -v
        if step - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = step
        bottom, top = self._quantiles()
        if trial_id not in bottom:
            return CONTINUE
        src = self._rng.choice(top)
        new_config = self._explore(self._configs.get(src, {}))
        self._configs[trial_id] = dict(new_config)
        self.num_exploits += 1
        return (EXPLOIT, src, new_config)
