"""The serving series of the metrics plane (the port's copy).

Port of `enabled()`, `_ServingMetrics` and `serving_metrics()` of
`ray_tpu/_private/metrics_plane.py`: the LLM engine's TTFT and TPOT
histograms and its token counter, with the same series names and
bucket ladder, registered lazily into `util.metrics.DEFAULT_REGISTRY`.
The cluster scrape waits for the runtime slice.
"""
from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.util.metrics import Counter, DEFAULT_REGISTRY, Histogram

# (gen, enabled): memoized per CONFIG generation, so the per-emission
# gate costs a tuple index, not an environment lookup.
_state: tuple = (-1, False)


def enabled() -> bool:
    global _state
    gen = CONFIG._gen
    st = _state
    if st[0] == gen:
        return st[1]
    _state = (gen, bool(CONFIG.metrics))
    return _state[1]


class _ServingMetrics:
    """Serving series, registered on first use, so a process that
    never generates registers nothing."""

    def __init__(self):
        reg = DEFAULT_REGISTRY
        # Token-level latencies live well under the default 1 ms … 60 s
        # boundaries' useful range: a sub-millisecond-to-seconds ladder.
        bounds = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0]
        self.ttft = Histogram(
            "ray_tpu_llm_ttft_s",
            "LLM time-to-first-token: submit to first emitted token "
            "(engine-side, includes queue wait + prefill)",
            boundaries=bounds, registry=reg)
        self.tpot = Histogram(
            "ray_tpu_llm_tpot_s",
            "LLM time-per-output-token: inter-token gap during decode",
            boundaries=bounds, registry=reg)
        self.tokens = Counter(
            "ray_tpu_llm_tokens",
            "LLM tokens emitted by this engine replica", registry=reg)


_sv: Optional[_ServingMetrics] = None
_sv_lock = threading.Lock()


def serving_metrics() -> Optional[dict]:
    """TTFT/TPOT histograms and the token counter for the LLM engine,
    or None while the plane is disabled (callers skip their observes)."""
    if not enabled():
        return None
    global _sv
    m = _sv
    if m is None:
        with _sv_lock:
            m = _sv
            if m is None:
                _sv = m = _ServingMetrics()
    return {"ttft": m.ttft, "tpot": m.tpot, "tokens": m.tokens}
