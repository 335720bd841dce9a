"""The one generator of serving traffic: lengths, arrivals and prompts.

A mix (`traffic/<name>.json`) states its distributions; this module
turns them into requests. Every seed gets the same multiset of sizes
and of gaps between arrivals, in another order: the values are the
distribution's quantiles at (i + 0.5) / n, shuffled by the seed. So two
seeds carry the same work, and the seed changes its order and the
token ids only.

A distribution is a dict:
  {"dist": "lognormal", "median": m, "sigma": s, "min": lo, "max": hi}
  {"dist": "uniform", "min": lo, "max": hi}          (integers, inclusive)
  {"dist": "exponential"}                   (gaps between arrivals)
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np

_NORMAL = statistics.NormalDist()


def quantile(dist: Dict, q: float):
    """The distribution's value at quantile q in (0, 1): a whole number
    of tokens within [min, max], or for "exponential" the gap (a float)
    of a unit-mean exponential."""
    kind = dist["dist"]
    if kind == "exponential":
        return -math.log(1.0 - q)
    lo, hi = int(dist["min"]), int(dist["max"])
    if kind == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(q))
        return min(hi, max(lo, int(round(x))))
    if kind == "uniform":
        return min(hi, lo + int(q * (hi - lo + 1)))
    raise ValueError(f"unknown distribution {kind!r}")


def strata(dist: Dict, n: int) -> List[int]:
    """n values at the quantiles (i + 0.5) / n, in ascending order."""
    return [quantile(dist, (i + 0.5) / n) for i in range(n)]


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def lengths(dist: Dict, n: int, seed: int, stream: int) -> List[int]:
    """The n strata of `dist`, shuffled by the seed."""
    vals = strata(dist, n)
    order = rng(seed, stream).permutation(n)
    return [vals[i] for i in order]


def rounds(dist: Dict, size: int, count: int, seed: int,
           stream: int) -> List[int]:
    """`count` rounds of `size` values each; every round holds the same
    `size` strata in its own order (so the first `size` requests of a
    closed loop carry the same work for every seed)."""
    vals = strata(dist, size)
    g = rng(seed, stream)
    out: List[int] = []
    for _ in range(count):
        out += [vals[i] for i in g.permutation(size)]
    return out


def arrivals(rate: float, seconds: float, seed: int, stream: int,
             block: int = 0) -> List[float]:
    """Poisson arrivals at `rate` a second over a window of `seconds`:
    n = round(rate * seconds) gaps at the exponential's strata, scaled so
    that they sum to the window, shuffled by the seed. With `block`, the
    gaps come in blocks of `block` arrivals, each block holding the same
    `block` strata in its own order, so every stretch of the window
    carries the same load for every seed. Returns the due times (seconds
    from the window's start), the first at 0."""
    n = max(1, int(round(rate * seconds)))
    expo = {"dist": "exponential"}
    gaps = (rounds(expo, block, -(-n // block), seed, stream)[:n] if block
            else lengths(expo, n, seed, stream))
    scale = seconds / sum(gaps)
    due, t = [], 0.0
    for g in gaps:
        due.append(t)
        t += g * scale
    return due


def prompts(lens: List[int], vocab: int, seed: int,
            stream: int) -> List[List[int]]:
    """Token ids uniform over the vocabulary, one prompt a length, no
    two sharing a prefix by design."""
    g = rng(seed, stream)
    return [g.integers(0, vocab, n).tolist() for n in lens]
