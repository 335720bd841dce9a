"""Metrics registry (util.metrics), config system, timeline dump.

The port's twin of `tests/test_metrics_config.py`, case for case.
"""
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram,
                                  MetricsRegistry, timeline)


@pytest.fixture()
def ray_cluster():
    """The conftest fixture of the same name, on the port: reuses a live
    runtime or (re)creates one; the module's end shuts it down."""
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


def test_counter_gauge_tags():
    reg = MetricsRegistry()
    c = Counter("requests_total", "reqs", tag_keys=("route",),
                registry=reg)
    c.inc(tags={"route": "a"})
    c.inc(2.0, tags={"route": "a"})
    c.inc(tags={"route": "b"})
    g = Gauge("queue_len", "ql", registry=reg)
    g.set(7)
    snap = reg.collect()
    assert snap["requests_total"]["series"][(("route", "a"),)] == 3.0
    assert snap["requests_total"]["series"][(("route", "b"),)] == 1.0
    assert snap["queue_len"]["series"][()] == 7.0
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        c.inc(tags={"bogus": "x"})


def test_histogram_buckets_and_prometheus_text():
    reg = MetricsRegistry()
    h = Histogram("latency_s", "lat", boundaries=(0.1, 1.0, 10.0),
                  registry=reg)
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    total, count, buckets = reg.collect()["latency_s"]["series"][()]
    assert count == 4 and abs(total - 55.55) < 1e-9
    assert dict(buckets) == {0.1: 1, 1.0: 2, 10.0: 3}
    text = reg.prometheus_text()
    assert "# TYPE latency_s histogram" in text
    assert "latency_s_count" in text
    assert 'le="+Inf"} 4' in text      # mandatory +Inf bucket == count


def test_registry_rejects_type_conflicts():
    reg = MetricsRegistry()
    Counter("m1", registry=reg)
    with pytest.raises(ValueError):
        Gauge("m1", registry=reg)
    # same type re-register is a replace, not an error
    Counter("m1", registry=reg)


def test_config_env_override(monkeypatch):
    from ray_tpu_torch._private.config import CONFIG
    CONFIG.reload()
    assert CONFIG.heartbeat_timeout_s == 3.0
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_TIMEOUT_S", "9.5")
    CONFIG.reload()
    assert CONFIG.heartbeat_timeout_s == 9.5
    monkeypatch.delenv("RAY_TPU_HEARTBEAT_TIMEOUT_S")
    CONFIG.reload()
    assert CONFIG.heartbeat_timeout_s == 3.0
    with pytest.raises(AttributeError):
        CONFIG.not_a_knob
    desc = CONFIG.describe()
    assert desc["spill_delay_s"]["env"] == "RAY_TPU_SPILL_DELAY_S"
    assert all("doc" in v for v in desc.values())


def test_timeline_dump(ray_cluster, tmp_path):
    @ray_tpu_torch.remote
    def work(x):
        return x + 1

    ray_tpu_torch.get([work.remote(i) for i in range(3)])
    out = tmp_path / "trace.json"
    events = timeline(str(out))
    assert out.exists()
    complete = [e for e in events if e["ph"] == "X"]
    assert len(complete) >= 3
    assert all(e["dur"] >= 0 for e in complete)
    import json
    json.load(open(out))            # valid chrome trace json
