"""Counters and histograms in an in-process registry (the port's copy).

Port of the registry, Counter and Histogram of `ray_tpu/util/metrics.py`:
metrics register into a process-wide registry, and `collect()`
snapshots every series. Histogram snapshots have the JAX package's
cumulative `(total, count, ((bound, count <= bound), ...))` shape.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple

_TagTuple = Tuple[str, ...]


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, "Metric"] = {}
        self._lock = threading.Lock()

    def register(self, metric: "Metric") -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and type(existing) is not type(metric):
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{type(existing).__name__}")
            self._metrics[metric.name] = metric

    def collect(self) -> Dict[str, dict]:
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}


DEFAULT_REGISTRY = MetricsRegistry()


class Metric:
    _type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = (),
                 registry: Optional[MetricsRegistry] = None):
        if not name or not name.replace("_", "").replace(":", "") \
                .isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._series: Dict[_TagTuple, float] = {}
        self._lock = threading.Lock()
        (registry or DEFAULT_REGISTRY).register(self)

    def _key(self, tags: Optional[Dict[str, str]]) -> _TagTuple:
        tags = tags or {}
        extra = set(tags) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"unknown tag(s) {sorted(extra)}; declared "
                f"tag_keys={self.tag_keys}")
        return tuple((k, str(tags.get(k, ""))) for k in self.tag_keys)

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": self._type, "description": self.description,
                    "series": dict(self._series)}


class Counter(Metric):
    _type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        k = self._key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value


DEFAULT_HISTOGRAM_BOUNDARIES = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)


class _HistSeries:
    """Mutable per-series histogram state: one counter per bucket
    (non-cumulative), so an observe is a bisect and one list increment.
    The snapshot converts back to the cumulative shape."""

    __slots__ = ("total", "count", "counts")

    def __init__(self, n_buckets: int):
        self.total = 0.0
        self.count = 0
        self.counts = [0] * n_buckets

    def render(self, boundaries: Tuple[float, ...]) -> tuple:
        cum = 0
        buckets = []
        for b, c in zip(boundaries, self.counts):
            cum += c
            buckets.append((b, cum))
        return (self.total, self.count, tuple(buckets))


class Histogram(Metric):
    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = DEFAULT_HISTOGRAM_BOUNDARIES,
                 tag_keys: Sequence[str] = (),
                 registry: Optional[MetricsRegistry] = None):
        self.boundaries = tuple(sorted(boundaries))
        super().__init__(name, description, tag_keys, registry)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        k = self._key(tags)
        # NaN compares False against every bound: file it past the last
        # bound (the implicit +Inf bucket), not under the first.
        i = (len(self.boundaries) if value != value
             else bisect.bisect_left(self.boundaries, value))
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = _HistSeries(len(self.boundaries))
            st.total += value
            st.count += 1
            if i < len(st.counts):
                st.counts[i] += 1

    def snapshot(self) -> dict:
        with self._lock:
            series = {k: st.render(self.boundaries)
                      for k, st in self._series.items()}
        return {"type": self._type, "description": self.description,
                "series": series}
