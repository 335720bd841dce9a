"""Search spaces + variant generation.

Port of `ray_tpu/tune/search.py`, a copy.

Parity: reference tune/search/ (sample.py Domain/Categorical/Float,
basic_variant.py BasicVariantGenerator) — trimmed to the deterministic
core: grid_search cross-products, stochastic domains sampled
`num_samples` times, every variant a plain config dict.
"""
from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, Iterator, List, Sequence


class Domain:
    """A stochastic hyperparameter domain; `sample(rng)` draws one."""

    def sample(self, rng: random.Random) -> Any:  # pragma: no cover
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)


class LogUniform(Domain):
    def __init__(self, lower: float, upper: float):
        if lower <= 0:
            raise ValueError("loguniform needs lower > 0")
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.lower),
                                    math.log(self.upper)))


class RandInt(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def loguniform(lower: float, upper: float) -> LogUniform:
    return LogUniform(lower, upper)


def randint(lower: int, upper: int) -> RandInt:
    return RandInt(lower, upper)


def grid_search(values: Sequence[Any]) -> Dict[str, List[Any]]:
    """Marker dict, reference tune.grid_search: every value becomes its
    own variant (cross-product with other grids)."""
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v) == {"grid_search"}


class Searcher:
    """Pluggable search algorithm (reference tune/search/searcher.py).

    The controller calls `set_space` once, then `suggest` per trial and
    feeds observations back through `on_trial_result`/`on_trial_complete`.
    """

    def set_space(self, param_space: Dict[str, Any], metric: str,
                  mode: str) -> None:
        self._space = param_space
        self._metric = metric
        self._sign = 1.0 if mode == "max" else -1.0

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, step: int,
                        metrics: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Dict[str, Any]) -> None:
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (the model behind the
    reference's OptunaSearch default sampler — optuna.samplers.TPESampler;
    implemented natively since this stack vendors no external searcher).

    After `n_initial` random trials: observations are split into the
    top-`gamma` ("good") and the rest ("bad"); each numeric dimension is
    modeled by a Parzen window (Gaussian KDE over observed values) per
    split, categorical dimensions by smoothed counts; `n_candidates`
    draws from the good model are scored by the density ratio
    l_good/l_bad and the argmax is suggested (Bergstra et al. 2011,
    "Algorithms for Hyper-Parameter Optimization").
    """

    def __init__(self, n_initial: int = 5, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._suggested: Dict[str, Dict[str, Any]] = {}
        self._obs: List[tuple] = []          # (config, score: higher=better)

    # ------------------------------------------------------- feedback
    def on_trial_result(self, trial_id, step, metrics):
        self._record(trial_id, metrics)

    def on_trial_complete(self, trial_id, result):
        self._record(trial_id, result)

    def _record(self, trial_id, metrics):
        if not metrics or self._metric not in metrics:
            return
        cfg = self._suggested.get(trial_id)
        if cfg is None:
            return
        score = self._sign * float(metrics[self._metric])
        # keep the best observation per trial
        for i, (c, s) in enumerate(self._obs):
            if c is cfg:
                if score > s:
                    self._obs[i] = (c, score)
                return
        self._obs.append((cfg, score))

    # -------------------------------------------------------- suggest
    def suggest(self, trial_id: str) -> Dict[str, Any]:
        if len(self._obs) < self.n_initial:
            cfg = self._random_config()
        else:
            cfg = self._tpe_config()
        self._suggested[trial_id] = cfg
        return cfg

    def _random_config(self) -> Dict[str, Any]:
        cfg = {}
        for k, v in self._space.items():
            if _is_grid(v):
                cfg[k] = self._rng.choice(v["grid_search"])
            elif isinstance(v, Domain):
                cfg[k] = v.sample(self._rng)
            else:
                cfg[k] = v
        return cfg

    def _tpe_config(self) -> Dict[str, Any]:
        ranked = sorted(self._obs, key=lambda cs: -cs[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        best, best_score = None, -float("inf")
        for _ in range(self.n_candidates):
            cand = {}
            logratio = 0.0
            for k, v in self._space.items():
                if isinstance(v, Domain):
                    cand[k], lr = self._sample_dim(k, v, good, bad)
                    logratio += lr
                elif _is_grid(v):
                    cand[k] = self._rng.choice(v["grid_search"])
                else:
                    cand[k] = v
            if logratio > best_score:
                best, best_score = cand, logratio
        return best if best is not None else self._random_config()

    def _sample_dim(self, key, domain, good, bad):
        gvals = [c[key] for c in good if key in c]
        bvals = [c[key] for c in bad if key in c]
        if isinstance(domain, Categorical) or not all(
                isinstance(x, (int, float)) for x in gvals + bvals):
            cats = (domain.categories if isinstance(domain, Categorical)
                    else sorted({*gvals, *bvals}, key=repr))
            # smoothed counts; sample from the good distribution
            gw = [gvals.count(c) + 1.0 for c in cats]
            val = self._rng.choices(cats, weights=gw)[0]
            bw = bvals.count(val) + 1.0
            return val, math.log(
                (gvals.count(val) + 1.0) / sum(gw)
                / (bw / (len(bvals) + len(cats))))
        logspace = isinstance(domain, LogUniform)
        xform = math.log if logspace else (lambda x: x)
        inv = math.exp if logspace else (lambda x: x)
        g = [xform(x) for x in gvals] or [xform(domain.sample(self._rng))]
        b = [xform(x) for x in bvals] or g
        lo = xform(domain.lower)
        hi = xform(domain.upper)
        sigma = max((hi - lo) / max(len(g), 1), 1e-12)
        mu = self._rng.choice(g)
        x = min(max(self._rng.gauss(mu, sigma), lo), hi)
        val = inv(x)
        if isinstance(domain, RandInt):
            val = int(min(max(round(val), domain.lower),
                          domain.upper - 1))
            x = xform(val)
        return val, (_parzen_logpdf(x, g, sigma)
                     - _parzen_logpdf(x, b, sigma))


def _parzen_logpdf(x: float, centers: List[float], sigma: float) -> float:
    m = max(-0.5 * ((x - c) / sigma) ** 2 for c in centers)
    s = sum(math.exp(-0.5 * ((x - c) / sigma) ** 2 - m) for c in centers)
    return m + math.log(s / (len(centers) * sigma * math.sqrt(2 * math.pi)))


class BasicVariantGenerator:
    """Expand a param_space into concrete trial configs.

    Grid dimensions cross-product; Domain dimensions re-sample per
    variant; `num_samples` multiplies the whole set (reference
    basic_variant semantics: num_samples repeats of each grid point)."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def variants(self, param_space: Dict[str, Any],
                 num_samples: int = 1) -> Iterator[Dict[str, Any]]:
        grid_keys = [k for k, v in param_space.items() if _is_grid(v)]
        grid_vals = [param_space[k]["grid_search"] for k in grid_keys]
        for _ in range(num_samples):
            for combo in (itertools.product(*grid_vals)
                          if grid_keys else [()]):
                cfg = {}
                for k, v in param_space.items():
                    if k in grid_keys:
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self._rng)
                    else:
                        cfg[k] = v
                yield cfg
