"""User-facing metrics: Counter / Gauge / Histogram + registry.

Parity: reference python/ray/util/metrics.py (Counter:...Gauge,
Histogram over the OpenCensus pipeline, src/ray/stats/metric.h:103) —
re-shaped for this runtime: metrics register into an in-process
registry; `collect()` snapshots every series, and
`prometheus_text()` renders the standard exposition format for
scraping or file export. Tags follow the reference's tag_keys model.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_TagTuple = Tuple[str, ...]


def escape_label_value(value) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double quote, and newline must be escaped or a hostile/unlucky tag
    value corrupts the whole scrape output."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text) -> str:
    # HELP lines escape only backslash and newline (the format keeps
    # quotes literal there)
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Render a registry snapshot (`MetricsRegistry.collect()` shape,
    or the cluster-merged snapshot from `_private/metrics_plane`) as
    Prometheus exposition text. One renderer for both so the head-local
    and cluster-aggregated views cannot drift."""
    lines: List[str] = []
    for name, snap in snapshot.items():
        lines.append(f"# HELP {name} "
                     f"{_escape_help(snap.get('description', ''))}")
        lines.append(f"# TYPE {name} {snap.get('type', 'untyped')}")
        for tags, value in snap["series"].items():
            label = ",".join(
                f'{k}="{escape_label_value(v)}"' for k, v in tags)
            label = "{" + label + "}" if label else ""
            if snap["type"] == "histogram":
                total, count, buckets = value
                blabel = label[:-1] + "," if label else "{"
                for bound, c in buckets:
                    lines.append(
                        f'{name}_bucket{blabel}le="{bound}"}} {c}')
                # exposition format mandates the +Inf bucket == count
                lines.append(
                    f'{name}_bucket{blabel}le="+Inf"}} {count}')
                lines.append(f"{name}_sum{label} {total}")
                lines.append(f"{name}_count{label} {count}")
            else:
                lines.append(f"{name}{label} {value}")
    return "\n".join(lines) + "\n"


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

    def get(self, name: str) -> Optional["Metric"]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> Dict[str, dict]:
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def prometheus_text(self) -> str:
        return render_prometheus(self.collect())

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


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
        self._default_tags: Dict[str, str] = {}
        (registry or DEFAULT_REGISTRY).register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> _TagTuple:
        merged = {**self._default_tags, **(tags or {})}
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"unknown tag(s) {sorted(extra)}; declared "
                f"tag_keys={self.tag_keys}")
        return tuple((k, str(merged.get(k, ""))) for k in self.tag_keys)

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": self._type, "description": self.description,
                    "series": dict(self._series)}

    def prune_series(self, predicate) -> int:
        """Drop every series whose tag-tuple key matches `predicate`
        (stale-label hygiene: long-lived registries must not grow
        forever under label churn). Returns the number dropped."""
        with self._lock:
            dead = [k for k in self._series if predicate(k)]
            for k in dead:
                del self._series[k]
            return len(dead)


class Counter(Metric):
    _type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        k = self._key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value


class Gauge(Metric):
    _type = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._series[self._key(tags)] = float(value)

    def set_many(self, rows: Sequence[Tuple[Optional[Dict[str, str]],
                                            float]]) -> None:
        """Atomically REPLACE every series with `rows` ((tags, value)
        pairs). Samplers that mirror a per-entity table (one series per
        node/worker) use this so entities that disappeared drop out of
        the snapshot instead of freezing at their last value."""
        series = {self._key(tags): float(v) for tags, v in rows}
        with self._lock:
            self._series = series


DEFAULT_HISTOGRAM_BOUNDARIES = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)


class _HistSeries:
    """Mutable per-series histogram state: one counter per bucket
    (non-cumulative), so a hot-path observe is a bisect + one list
    increment — not a rebuild of the whole bucket tuple. The snapshot
    converts back to the cumulative ``(total, count, ((bound, c≤), …))``
    shape every consumer already reads."""

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
        # NaN compares False against every bound: bisect_left would
        # file it under the FIRST bucket, where `value <= b` filed it
        # past the last (implicit +Inf overflow) — keep that.
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


def timeline(filename: Optional[str] = None) -> list:
    """LEGACY head-events Chrome-trace view (reference `ray timeline`).

    Pairs the controller's head-side RUNNING→FINISHED/FAILED task
    transitions into complete ("X") events; open-ended states become
    instant ("i") events. Load the file in chrome://tracing or
    Perfetto.

    This view needs nothing but the head's task-event table — it
    works even with tracing disabled — but it only sees what the head
    saw: scheduler queueing, wire latency, arg pulls, and worker-local
    time are invisible. For the cross-process timeline backed by the
    r9 tracing plane (per-process flight recorders, spans parented
    across driver → scheduler → worker → object plane), use
    `ray_tpu_torch.util.tracing.task_timeline` instead.
    """
    import json

    from ray_tpu_torch._private import context as _ctx
    events = _ctx.get_ctx().state_op("list_tasks", limit=100_000)
    t0 = min((e["ts"] for e in events), default=0.0)
    open_runs: Dict[str, dict] = {}
    trace: List[dict] = []
    for ev in events:
        us = (ev["ts"] - t0) * 1e6
        if ev["state"] == "RUNNING":
            open_runs[ev["task_id"]] = ev
        elif ev["state"] in ("FINISHED", "FAILED") and \
                ev["task_id"] in open_runs:
            start = open_runs.pop(ev["task_id"])
            trace.append({
                "name": ev["name"] or ev["task_id"],
                "cat": "task", "ph": "X",
                "ts": (start["ts"] - t0) * 1e6,
                "dur": (ev["ts"] - start["ts"]) * 1e6,
                "pid": ev["worker_id"] or start.get("worker_id") or "driver",
                "tid": ev["task_id"],
                "args": {"state": ev["state"], "error": ev["error"]},
            })
        else:
            trace.append({
                "name": f'{ev["name"]}:{ev["state"]}', "cat": "task",
                "ph": "i", "ts": us, "s": "g",
                "pid": ev["worker_id"] or "driver", "tid": ev["task_id"],
            })
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
