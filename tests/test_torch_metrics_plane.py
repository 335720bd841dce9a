"""Cluster metrics plane (r11): runtime-instrumented series, the
METRICS_DUMP cluster scrape, and the latency-signal consumers.

Done-criteria mirrored from r11:
- /metrics exposition carries series from >= 3 distinct processes
  (head, agent, worker) with correct node/worker labels on a real
  multi-agent cluster, and a nonzero task queue-wait histogram
- RAY_TPU_METRICS=0 records zero metric bytes on hot paths
- histogram bucket-merge math sums aligned buckets
- a scrape racing a node death returns (bounded) without the dead
  node; its series expire after RAY_TPU_METRICS_TTL_S
- the autoscaler scale-up fires from the queue-latency p95 signal
  where resource-shape demand alone would not trigger it
- Histogram.observe is O(log buckets) with a snapshot-equivalence
  regression test; Prometheus label values escape hostile characters

The port's twin of `tests/test_metrics_plane.py`, case for case.
"""
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import metrics_plane as mp
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram,
                                  MetricsRegistry, render_prometheus)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


_ENV_KEYS = ("RAY_TPU_METRICS", "RAY_TPU_METRICS_TTL_S",
             "RAY_TPU_METRICS_MIN_SCRAPE_S", "RAY_TPU_METRICS_RING",
             "RAY_TPU_AUTOSCALE_QUEUE_LATENCY_S",
             "RAY_TPU_AUTOSCALE_QUEUE_LATENCY_COOLDOWN_S")


@pytest.fixture
def metrics_env():
    for k in _ENV_KEYS:
        os.environ.pop(k, None)
    CONFIG.reload()
    yield
    for k in _ENV_KEYS:
        os.environ.pop(k, None)
    CONFIG.reload()


def _fresh_runtime():
    if ray_tpu_torch.is_initialized():   # a shared suite runtime may be live
        ray_tpu_torch.shutdown()
    return ray_tpu_torch.init(num_cpus=1)


# ------------------------------------------------ util.metrics satellites
def test_histogram_fast_observe_snapshot_equivalence():
    """The bisect-based observe must produce byte-identical snapshots
    to the reference cumulative-tuple algorithm, including values ON a
    boundary and past the last bucket."""
    bounds = (0.1, 1.0, 10.0)
    values = [0.05, 0.1, 0.10001, 0.5, 1.0, 5.0, 10.0, 50.0, 0.1]
    reg = MetricsRegistry()
    h = Histogram("lat_s", "lat", boundaries=bounds, registry=reg)
    for v in values:
        h.observe(v)

    # reference implementation (the pre-r11 per-observe rebuild)
    total, count = 0.0, 0
    buckets = tuple((b, 0) for b in bounds)
    for v in values:
        buckets = tuple((b, c + (1 if v <= b else 0))
                        for b, c in buckets)
        total, count = total + v, count + 1

    got = reg.collect()["lat_s"]["series"][()]
    assert got == (pytest.approx(total), count, buckets)
    # the +Inf bucket (count) exceeds the last bound's cumulative count
    assert count > dict(buckets)[10.0]

    # NaN (`v <= b` is False for every bound): counted, but lands in
    # the implicit +Inf overflow — never a finite bucket
    h.observe(float("nan"))
    t2, c2, b2 = reg.collect()["lat_s"]["series"][()]
    assert c2 == count + 1 and b2 == buckets and t2 != t2


def test_histogram_observe_tagged_series_independent():
    reg = MetricsRegistry()
    h = Histogram("m", "", boundaries=(1.0, 2.0), tag_keys=("n",),
                  registry=reg)
    h.observe(0.5, {"n": "a"})
    h.observe(1.5, {"n": "b"})
    snap = reg.collect()["m"]["series"]
    assert snap[(("n", "a"),)][2] == ((1.0, 1), (2.0, 1))
    assert snap[(("n", "b"),)][2] == ((1.0, 0), (2.0, 1))


def test_prometheus_label_escaping():
    reg = MetricsRegistry()
    c = Counter("hostile_total", 'desc with \\ and\nnewline',
                tag_keys=("tag",), registry=reg)
    c.inc(tags={"tag": 'a\\b"c\nd'})
    g = Gauge("ok_gauge", "g", tag_keys=("t",), registry=reg)
    g.set(1.0, tags={"t": "plain"})
    text = reg.prometheus_text()
    # escaped per the exposition format: \\ then \" then \n
    assert 'tag="a\\\\b\\"c\\nd"' in text
    # no raw newline may survive inside any line (it would split a
    # sample into two bogus lines)
    for line in text.splitlines():
        if line.startswith("hostile_total{"):
            assert line.endswith("} 1.0")
    assert "# HELP hostile_total desc with \\\\ and\\nnewline" in text
    assert 't="plain"' in text


def test_histogram_bucket_merge_math():
    a = (10.0, 4, ((0.1, 1), (1.0, 3), (10.0, 4)))
    b = (2.0, 2, ((0.1, 0), (1.0, 1), (10.0, 2)))
    total, count, buckets = mp._merge_hist(a, b)
    assert (total, count) == (12.0, 6)
    assert buckets == ((0.1, 1), (1.0, 4), (10.0, 6))
    # quantiles read the merged CDF at bucket resolution
    assert mp.quantile((total, count, buckets), 0.5) == 1.0
    assert mp.quantile((total, count, buckets), 0.99) == 10.0
    assert mp.quantile((1.0, 1, ((0.1, 0),)), 0.95) == float("inf")
    assert mp.quantile((0.0, 0, ()), 0.5) is None
    # windowed view: new - old per aligned bucket
    delta = mp.hist_delta((12.0, 6, buckets), a)
    assert delta == (2.0, 2, ((0.1, 0), (1.0, 1), (10.0, 2)))
    # differing boundary sets merge on the union (CDF step read)
    c = (1.0, 2, ((0.5, 1), (10.0, 2)))
    _, cc, cb = mp._merge_hist(a, c)
    assert cc == 6
    assert cb == ((0.1, 1), (0.5, 2), (1.0, 4), (10.0, 6))
    # hist_delta across a boundary-set change (union fallback added
    # 0.5 between samples): old's CDF is step-read at the new bound,
    # NOT treated as 0 — else the 3 pre-window obs <= 1.0 would all
    # count as in-window and drag the windowed p95 down
    new = (13.0, 7, ((0.1, 1), (0.5, 2), (1.0, 4), (10.0, 7)))
    assert mp.hist_delta(new, a) == \
        (3.0, 3, ((0.1, 0), (0.5, 1), (1.0, 1), (10.0, 3)))


def test_merge_dumps_label_attach_and_collision():
    hist = {"type": "histogram", "description": "d",
            "series": {(): (1.0, 1, ((1.0, 1),))}}
    ctr = {"type": "counter", "description": "",
           "series": {(): 2.0}}
    tagged = {"type": "histogram", "description": "d",
              "series": {(("node", "nX"),): (1.0, 1, ((1.0, 1),))}}
    merged = mp.merge_dumps([
        {"labels": {"node": "n1", "worker": "w1"},
         "metrics": {"h": hist, "c": ctr, "t": tagged}},
        {"labels": {"node": "n2", "worker": ""},
         "metrics": {"h": hist, "c": ctr, "t": tagged}},
    ])
    # per-process series stay distinct under their labels
    assert (("node", "n1"), ("worker", "w1")) in merged["h"]["series"]
    assert (("node", "n2"), ("worker", "")) in merged["h"]["series"]
    # a metric that tags its own node keeps it (the process label must
    # not override an in-process node's identity)...
    key = (("node", "nX"), ("worker", "w1"))
    assert key in merged["t"]["series"]
    # ...and identical tag sets from two sources SUM (histogram)
    same = mp.merge_dumps([
        {"labels": {"node": "nX", "worker": ""}, "metrics": {"t": tagged}},
        {"labels": {"node": "nX", "worker": ""}, "metrics": {"t": tagged}},
    ])
    assert same["t"]["series"][(("node", "nX"), ("worker", ""))] == \
        (2.0, 2, ((1.0, 2),))
    # counters with identical keys add
    both = mp.merge_dumps([
        {"labels": {"node": "n", "worker": ""}, "metrics": {"c": ctr}},
        {"labels": {"node": "n", "worker": ""}, "metrics": {"c": ctr}},
    ])
    assert both["c"]["series"][(("node", "n"), ("worker", ""))] == 4.0
    # exposition renders the merged snapshot
    text = render_prometheus(merged)
    assert 'h_count{node="n1",worker="w1"} 1' in text


# ------------------------------------------------------ disabled mode
def test_disabled_mode_records_nothing(metrics_env):
    os.environ["RAY_TPU_METRICS"] = "0"
    CONFIG.reload()
    assert not mp.enabled()
    assert mp.local_dump() == {"enabled": False, "metrics": {}}

    def series_counts():
        m = mp._mx
        if m is None:
            return None
        return (m.queue_wait.snapshot()["series"],
                m.exec.snapshot()["series"],
                m.e2e.snapshot()["series"])

    before = series_counts()
    mp.observe_queue_wait(1.0, "n1")
    mp.observe_exec(2.0)

    class Spec:
        pass

    s = Spec()
    mp.submit_stamp(s)
    assert not hasattr(s, "_submit_mono")   # zero bytes on the spec
    mp.observe_task_done(s, "n1")
    mp.run_samplers()
    assert series_counts() == before        # nothing recorded anywhere


def test_autoscale_threshold_is_a_queue_wait_bucket_bound(metrics_env):
    """quantile() resolves at bucket granularity, so a threshold
    strictly between two default bounds would behave as the LOWER one
    (tasks waiting 0.12 s read as p95=0.5 for a 0.2 s threshold and
    spuriously trigger scale-up). Configuring the threshold must make
    it a bound, making the p95-vs-threshold comparison exact."""
    try:
        os.environ["RAY_TPU_AUTOSCALE_QUEUE_LATENCY_S"] = "0.2"
        CONFIG.reload()
        m = mp._RuntimeMetrics()
        assert 0.2 in m.queue_wait.boundaries
        for _ in range(40):
            m.queue_wait.observe(0.12, {"node": "n"})
        snap = m.queue_wait.snapshot()["series"][(("node", "n"),)]
        assert mp.quantile(snap, 0.95) == 0.2  # not 0.5: no false fire
        # unset -> default boundaries, no extra bucket
        del os.environ["RAY_TPU_AUTOSCALE_QUEUE_LATENCY_S"]
        CONFIG.reload()
        assert 0.2 not in mp._RuntimeMetrics().queue_wait.boundaries
    finally:
        # the throwaway instances above re-registered the runtime
        # series: drop the singleton so the next observe rebuilds it
        # in sync with whatever the registry holds
        mp._mx = None


def test_reply_off_reader_delivers_errors():
    """A failing off-reader state op (metrics_dump and friends) must
    reply with an error payload — a silently dead reply thread leaves
    the remote caller blocked for its full request timeout — and the
    worker-side client must re-raise it."""
    from ray_tpu_torch._private.runtime import Runtime
    from ray_tpu_torch._private.worker_main import WorkerContext

    replies = []

    class FakeConn:
        def reply(self, msg, **fields):
            replies.append(fields)

    def boom():
        raise KeyError("type")

    Runtime._reply_off_reader(None, FakeConn(), {"rid": 1}, "t", boom)
    deadline = time.time() + 5
    while not replies and time.time() < deadline:
        time.sleep(0.01)
    assert replies and replies[0]["value"] is None
    assert "KeyError" in replies[0]["error"]

    class FakeReqConn:
        def request(self, msg, timeout=None):
            return {"value": None, "error": "KeyError: 'type'"}

    ctx = object.__new__(WorkerContext)
    ctx.conn = FakeReqConn()
    with pytest.raises(RuntimeError, match="metrics_dump.*KeyError"):
        ctx.state_op("metrics_dump")


def test_submit_stamp_stays_off_the_wire(metrics_env):
    """The head-side e2e stamp must not ship in pickled specs: a
    monotonic reading is meaningless in another process and would be
    pure per-task wire overhead."""
    import pickle

    from ray_tpu_torch._private.specs import TaskSpec
    CONFIG.reload()
    assert mp.enabled()
    s = TaskSpec(task_id="t", func_id="f")
    mp.submit_stamp(s)
    assert hasattr(s, "_submit_mono")        # head-side mirror keeps it
    clone = pickle.loads(pickle.dumps(s))
    assert not hasattr(clone, "_submit_mono")
    assert (clone.task_id, clone.func_id) == ("t", "f")


@pytest.mark.slow    # ~7s (r20 tier-1 budget): the cluster-scoped
# disabled-mode sweep; test_disabled_mode_records_nothing keeps the
# disabled-mode contract in tier-1.
def test_disabled_mode_cluster_ops_empty(metrics_env):
    os.environ["RAY_TPU_METRICS"] = "0"
    CONFIG.reload()
    rt = _fresh_runtime()
    try:
        @ray_tpu_torch.remote
        def f(x):
            return x

        assert ray_tpu_torch.get([f.remote(i) for i in range(4)]) == [0, 1, 2, 3]
        assert rt.state_op("metrics_dump") == {}
        assert rt.state_op("metrics_summary")["enabled"] is False
        assert rt.state_op("metrics_stats")["enabled"] is False
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------- cluster scrape + labels
def _drain_on_tags(n=6):
    @ray_tpu_torch.remote(resources={"tag_a": 0.5}, num_cpus=0.1)
    def on_a(x):
        return x * 2

    @ray_tpu_torch.remote(resources={"tag_b": 0.5}, num_cpus=0.1)
    def on_b(x):
        return x * 3

    outs = ray_tpu_torch.get([on_a.remote(i) for i in range(n)]
                       + [on_b.remote(i) for i in range(n)],
                       timeout=120)
    assert outs == [i * 2 for i in range(n)] + [i * 3 for i in range(n)]


def test_two_agent_cluster_scrape(metrics_env):
    """The acceptance scenario: a real 2-agent cluster's /metrics
    exposition carries series from >= 3 distinct processes (head,
    agent, worker) with correct node/worker labels, and the task
    queue-wait histogram has nonzero counts after a drain."""
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    os.environ["RAY_TPU_METRICS_MIN_SCRAPE_S"] = "0"
    CONFIG.reload()
    rt = _fresh_runtime()
    agents = [NodeAgentProcess(num_cpus=1, max_workers=1,
                               resources={"tag_a": 1.0}),
              NodeAgentProcess(num_cpus=1, max_workers=1,
                               resources={"tag_b": 1.0})]
    try:
        deadline = time.time() + 60
        while (time.time() < deadline
               and len(rt.cluster.alive_nodes()) < 3):
            time.sleep(0.1)
        assert len(rt.cluster.alive_nodes()) >= 3
        _drain_on_tags()

        # One fan-out's deadline can expire before a loaded agent has
        # drained its worker, dropping that process from the snapshot —
        # re-scrape until both agents' worker series have landed.
        agent_ids = {a.node_id for a in agents}
        deadline = time.time() + 60
        while True:
            merged = rt.state_op("metrics_dump")
            ex = merged.get("ray_tpu_task_exec_s", {}).get("series", {})
            # exec is observed worker-side: one series per (node, worker)
            procs = {key for key in ex}
            nodes = {dict(k).get("node") for k in procs}
            if agent_ids <= nodes or time.time() > deadline:
                break
            time.sleep(0.5)
        workers = {dict(k).get("worker") for k in procs}
        assert agent_ids <= nodes              # both agents' workers
        assert all(w for w in workers)         # worker label set
        # queue wait: nonzero counts, observed per scheduler node
        qw = merged["ray_tpu_task_queue_wait_s"]["series"]
        by_node = {dict(k)["node"]: v for k, v in qw.items()}
        assert sum(v[1] for v in by_node.values()) >= 12
        assert agent_ids <= set(by_node)       # delegated queues too
        # e2e observed head-side, labeled by the EXECUTING node
        e2e = merged["ray_tpu_task_e2e_s"]["series"]
        assert agent_ids <= {dict(k)["node"] for k in e2e}
        # >= 3 distinct processes contributed series: the head
        # process, each agent process, each agent's worker process
        sources = {key for name in merged
                   for key in merged[name]["series"]
                   if {"node", "worker"} <= set(dict(key))}
        distinct = {(dict(k)["node"], dict(k)["worker"])
                    for k in sources}
        assert len(distinct) >= 3
        # exposition text renders every label pair
        text = mp.prometheus_text(merged)
        for nid in agent_ids:
            assert f'node="{nid}"' in text
        assert 'worker="w_' in text
        # summary JSON view over the same collection
        summary = rt.state_op("metrics_summary")
        assert summary["enabled"] and summary["sources"] >= 3
        assert summary["queue_wait"]["count"] >= 12
    finally:
        for a in agents:
            a.terminate()
        for a in agents:
            a.wait(10)
        ray_tpu_torch.shutdown()


def test_scrape_survives_node_death_and_ttl_expiry(metrics_env):
    """A scrape racing an agent death returns (bounded by the fan-out
    deadline) with the dead node's last series, which then EXPIRE
    after RAY_TPU_METRICS_TTL_S instead of lingering forever."""
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    os.environ["RAY_TPU_METRICS_MIN_SCRAPE_S"] = "0"
    os.environ["RAY_TPU_METRICS_TTL_S"] = "1.0"
    CONFIG.reload()
    rt = _fresh_runtime()
    agent = NodeAgentProcess(num_cpus=1, max_workers=1,
                             resources={"tag_a": 1.0})
    try:
        deadline = time.time() + 60
        while (time.time() < deadline
               and len(rt.cluster.alive_nodes()) < 2):
            time.sleep(0.1)

        @ray_tpu_torch.remote(resources={"tag_a": 0.5}, num_cpus=0.1)
        def f(x):
            return x

        assert ray_tpu_torch.get([f.remote(i) for i in range(4)],
                           timeout=60) == list(range(4))
        merged = rt.state_op("metrics_dump")
        assert any(("node", agent.node_id) in k
                   for k in merged["ray_tpu_task_exec_s"]["series"])

        agent.terminate()
        agent.wait(10)
        # the racing scrape is bounded and must not hang or throw
        t0 = time.monotonic()
        merged = rt.state_op("metrics_dump", timeout=2.0)
        assert time.monotonic() - t0 < 10
        # within the TTL the dead node's cached series may linger;
        # after it they are gone from the exposition
        deadline = time.time() + 15
        while time.time() < deadline:
            merged = rt.state_op("metrics_dump", timeout=1.0)
            text = mp.prometheus_text(merged)
            if f'node="{agent.node_id}"' not in text:
                break
            time.sleep(0.3)
        assert f'node="{agent.node_id}"' not in text
        # the head's own series survive the expiry sweep
        assert "ray_tpu_task_e2e_s" in merged
        # ...and the head REGISTRY pruned the dead node's series (node
        # churn must not grow it forever), not just the merged view
        from ray_tpu_torch.util.metrics import DEFAULT_REGISTRY
        local = DEFAULT_REGISTRY.collect().get(
            "ray_tpu_task_e2e_s", {}).get("series", {})
        assert not any(("node", agent.node_id) in k for k in local)
    finally:
        agent.terminate()
        agent.wait(5)
        ray_tpu_torch.shutdown()


def test_metric_prune_series():
    reg = MetricsRegistry()
    h = Histogram("m", "", boundaries=(1.0,), tag_keys=("node",),
                  registry=reg)
    h.observe(0.5, {"node": "a"})
    h.observe(0.5, {"node": "b"})
    assert h.prune_series(lambda k: dict(k)["node"] == "a") == 1
    assert list(reg.collect()["m"]["series"]) == [(("node", "b"),)]


def test_in_process_node_workers_scraped(metrics_env):
    """A cluster-sim node (Cluster.add_node, no agent process) owns
    real subprocess workers — their registries must reach the cluster
    scrape like any agent's."""
    from ray_tpu_torch.cluster_utils import Cluster
    os.environ["RAY_TPU_METRICS_MIN_SCRAPE_S"] = "0"
    CONFIG.reload()
    rt = _fresh_runtime()
    try:
        c = Cluster(initialize_head=False)
        sim_nid = c.add_node(num_cpus=1, resources={"tag_sim": 1.0})

        @ray_tpu_torch.remote(resources={"tag_sim": 0.5}, num_cpus=0.1)
        def f(x):
            return x

        assert ray_tpu_torch.get([f.remote(i) for i in range(3)],
                           timeout=60) == [0, 1, 2]

        def sim_worker_series(merged):
            ex = merged.get("ray_tpu_task_exec_s", {}).get("series", {})
            return [k for k in ex
                    if dict(k).get("node") == sim_nid
                    and dict(k).get("worker")]

        deadline = time.time() + 30
        while True:
            merged = rt.state_op("metrics_dump")
            if sim_worker_series(merged) or time.time() > deadline:
                break
            time.sleep(0.3)
        assert sim_worker_series(merged)
    finally:
        ray_tpu_torch.shutdown()


def test_user_node_tag_survives_ttl_filter(metrics_env):
    """The node-TTL filter targets ids that were cluster nodes — a
    user metric tagging "node" with its own foreign values must still
    reach the cluster exposition."""
    os.environ["RAY_TPU_METRICS_MIN_SCRAPE_S"] = "0"
    CONFIG.reload()
    rt = _fresh_runtime()
    try:
        c = Counter("user_node_hits_total", "user metric",
                    tag_keys=("node",))
        c.inc(tags={"node": "external-db-1"})
        merged = rt.state_op("metrics_dump")
        keys = merged["user_node_hits_total"]["series"]
        assert any(("node", "external-db-1") in k for k in keys)
        assert 'node="external-db-1"' in mp.prometheus_text(merged)
    finally:
        ray_tpu_torch.shutdown()


def test_concurrent_collects_share_one_fanout(metrics_env):
    """Two collect() callers overlapping in time (a gather can outlive
    the rate-limit window) must produce ONE cluster fan-out: the
    second caller waits for the in-flight result instead of doubling
    the dump traffic."""
    import threading

    os.environ["RAY_TPU_METRICS_MIN_SCRAPE_S"] = "0"
    CONFIG.reload()
    rt = _fresh_runtime()
    coll = rt.metrics
    orig = coll._gather
    calls = []
    release = threading.Event()

    def slow_gather(timeout):
        calls.append(1)
        release.wait(10)
        return orig(timeout)

    try:
        coll._gather = slow_gather
        first = threading.Thread(
            target=lambda: coll.collect(timeout=8), daemon=True)
        first.start()
        deadline = time.time() + 5
        while not calls and time.time() < deadline:
            time.sleep(0.05)
        assert calls, "first collect never reached the gather"
        got = {}
        second = threading.Thread(
            target=lambda: got.update(r=coll.collect(timeout=8)),
            daemon=True)
        second.start()
        time.sleep(0.5)
        assert len(calls) == 1      # no second fan-out started
        release.set()
        first.join(15)
        second.join(15)
        assert len(calls) == 1
        assert "r" in got           # the waiter got the shared result
        assert not coll._collecting
    finally:
        coll._gather = orig
        ray_tpu_torch.shutdown()


# ------------------------------------------------ autoscaler consumer
def test_autoscaler_queue_latency_trigger(metrics_env):
    """Scale-up fires from the queue-wait p95 signal in a situation
    where resource-shape demand alone would NOT trigger it: the queue
    has fully drained (zero unmet shapes) but the recent window's p95
    breached the threshold."""
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig
    os.environ["RAY_TPU_METRICS_MIN_SCRAPE_S"] = "0"
    # any real dispatch waits longer than 10 µs, so the p95 trips
    # without needing an actual backlog at update() time
    os.environ["RAY_TPU_AUTOSCALE_QUEUE_LATENCY_S"] = "0.00001"
    os.environ["RAY_TPU_AUTOSCALE_QUEUE_LATENCY_COOLDOWN_S"] = "60"
    CONFIG.reload()
    rt = _fresh_runtime()
    try:
        @ray_tpu_torch.remote(num_cpus=1)
        def f(x):
            return x

        assert ray_tpu_torch.get([f.remote(i) for i in range(6)],
                           timeout=60) == list(range(6))
        auto = Autoscaler(
            rt.cluster,
            [NodeTypeConfig("cpu", {"CPU": 2.0}, max_workers=4)],
            idle_timeout_s=3600.0)
        assert auto.latency_threshold_s == pytest.approx(1e-5)
        # the signal source is non-blocking (reads the newest ring
        # sample): warm the ring synchronously so the first tick sees
        # the drain's queue waits
        assert rt.metrics.collect(timeout=5.0)
        # the control: no unmet resource shapes — demand-driven
        # scaling has nothing to act on
        assert auto._unmet_demand() == []
        n_before = len(rt.cluster.alive_nodes())
        auto.update()
        assert auto.num_latency_scale_ups == 1
        assert auto.last_queue_wait_p95 is not None \
            and auto.last_queue_wait_p95 > 1e-5
        assert len(rt.cluster.alive_nodes()) == n_before + 1
        # cooldown: the still-hot p95 must not launch a node per tick
        auto.update()
        assert auto.num_latency_scale_ups == 1
    finally:
        ray_tpu_torch.shutdown()


def test_latency_trigger_waits_for_in_flight_capacity(metrics_env):
    """A breached p95 must not re-fire while an earlier launch is
    still provisioning: the pending node can't drain anything before
    it registers, so re-firing every cooldown window would march to
    max_workers for a backlog the in-flight capacity already covers."""
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig
    auto = Autoscaler.__new__(Autoscaler)
    auto._types = {"t": NodeTypeConfig("t", {"CPU": 1.0},
                                       max_workers=8)}
    auto.latency_threshold_s = 0.1
    auto.latency_cooldown_s = 0.0
    auto.num_latency_scale_ups = 0
    auto._last_latency_scale_up = None
    auto.last_queue_wait_p95 = None
    auto._latency_source = lambda: 5.0          # always breached
    auto._in_flight_launches = [("pending-node", {"CPU": 1.0}, 0.0)]
    auto._maybe_latency_scale_up(time.monotonic())
    assert auto.num_latency_scale_ups == 0      # suppressed
    auto._in_flight_launches = []
    fired = []
    auto._scale_up = lambda t: fired.append(t.name)
    auto._count_type = lambda name: 0
    auto._maybe_latency_scale_up(time.monotonic())
    assert fired == ["t"] and auto.num_latency_scale_ups == 1


def test_actor_task_e2e_observed(metrics_env):
    """Actor-method completions must land in the e2e histogram like
    plain tasks — a serve/actor-heavy cluster otherwise reads
    tasks_done=0 on the Metrics tab while exec counts grow."""
    os.environ["RAY_TPU_METRICS_MIN_SCRAPE_S"] = "0"
    CONFIG.reload()
    rt = _fresh_runtime()
    try:
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

        a = Counter.remote()
        assert ray_tpu_torch.get([a.bump.remote() for _ in range(4)],
                           timeout=60)[-1] == 4
        merged = rt.state_op("metrics_dump")
        e2e = merged["ray_tpu_task_e2e_s"]["series"]
        assert sum(v[1] for v in e2e.values()) >= 4
    finally:
        ray_tpu_torch.shutdown()


def test_autoscaler_latency_signal_off_by_default(metrics_env):
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig

    class NoCluster:
        _rt = None
    auto = Autoscaler.__new__(Autoscaler)
    auto._cluster = NoCluster()
    auto._types = {"t": NodeTypeConfig("t", {"CPU": 1.0})}
    auto.latency_threshold_s = 0.0
    auto.num_latency_scale_ups = 0
    auto._last_latency_scale_up = 0.0
    auto.latency_cooldown_s = 0.0
    auto.last_queue_wait_p95 = None
    auto._latency_source = auto._default_latency_source
    auto._maybe_latency_scale_up(time.monotonic())   # no-op, no crash
    assert auto.num_latency_scale_ups == 0
