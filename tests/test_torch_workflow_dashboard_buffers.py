"""Workflows (durable steps), dashboard endpoints, replay buffers,
schedules: the twin of `tests/test_workflow_dashboard_buffers.py`, case
for case, on the port (`ray_tpu_torch/workflow`, `ray_tpu_torch/dashboard.py`,
`ray_tpu_torch/job_submission.py`, `ray_tpu_torch/rllib/utils`).

The runtime fixtures are this file's own, and a live port runtime is
shut down when the module ends.
"""
import json
import os
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


# ----------------------------------------------------------- workflows
def _make_flow(marker_dir):
    from ray_tpu_torch import workflow

    @workflow.step
    def load(x):
        open(os.path.join(marker_dir, f"load_{x}"), "w").close()
        return x * 10

    @workflow.step
    def transform(x):
        open(os.path.join(marker_dir, f"transform_{x}"), "w").close()
        return x + 1

    @workflow.step
    def explode(x):
        raise RuntimeError("injected failure")

    def flow(x, fail=False):
        a = load(x)
        b = transform(a)
        if fail:
            explode(b)
        return b
    return flow


def test_workflow_run_and_short_circuit(ray_cluster, tmp_path):
    from ray_tpu_torch import workflow
    flow = _make_flow(str(tmp_path))
    out = workflow.run(flow, 4, workflow_id="wf1",
                       storage=str(tmp_path / "store"))
    assert out == 41
    st = workflow.get_status("wf1", storage=str(tmp_path / "store"))
    assert st["finished"] and st["steps_completed"] == 2
    # finished workflow resumes straight from the stored result
    assert workflow.resume("wf1", storage=str(tmp_path / "store")) == 41


def test_workflow_resume_replays_completed_steps(ray_cluster, tmp_path):
    """Crash mid-workflow -> resume re-executes ONLY the missing steps
    (reference workflow_executor durable-step semantics)."""
    from ray_tpu_torch import workflow
    store = str(tmp_path / "store")
    flow = _make_flow(str(tmp_path))
    with pytest.raises(Exception, match="injected failure"):
        workflow.run(flow, 7, workflow_id="wf2", storage=store,
                     fail=True)
    st = workflow.get_status("wf2", storage=store)
    assert not st["finished"] and st["steps_completed"] == 2

    # remove the poison by resuming with the stored entry whose `fail`
    # kwarg is... still True — so patch the entry the way a fixed
    # redeploy would: run() again with fail=False under the same id.
    out = workflow.run(flow, 7, workflow_id="wf2", storage=store)
    assert out == 71
    stats = workflow.last_run_stats()
    assert stats["replayed"] == 2 and stats["executed"] == 0
    # side effects did not repeat
    assert len([f for f in os.listdir(tmp_path) if f.startswith("load_")
                or f.startswith("transform_")]) == 2


def test_workflow_unknown_id_raises(tmp_path):
    from ray_tpu_torch import workflow
    with pytest.raises(workflow.WorkflowNotFoundError):
        workflow.resume("nope", storage=str(tmp_path))


def test_workflow_content_key_invalidates_stale_steps(ray_cluster,
                                                      tmp_path):
    """Editing a branch between run and resume must NOT silently
    replay the old step's result at the same call position: the
    content key (name + arg hash) mismatches and the step re-runs."""
    from ray_tpu_torch import workflow
    store = str(tmp_path / "store")

    @workflow.step
    def compute(x):
        return x * 2

    @workflow.step
    def explode(x):
        raise RuntimeError("boom")

    def flow_v1(fail=True):
        a = compute(3)
        if fail:
            explode(a)
        return a

    with pytest.raises(Exception, match="boom"):
        workflow.run(flow_v1, workflow_id="wfk", storage=store)

    # v2 changes the *first* step's argument: position 0 must not
    # replay compute(3)'s checkpoint.
    def flow_v2():
        return compute(5)

    out = workflow.run(flow_v2, workflow_id="wfk", storage=store)
    assert out == 10
    stats = workflow.last_run_stats()
    assert stats["invalidated"] == 1 and stats["executed"] == 1


def test_workflow_step_options_retry_and_catch(ray_cluster, tmp_path):
    from ray_tpu_torch import workflow
    store = str(tmp_path / "store")
    marker = str(tmp_path / "attempts")
    os.makedirs(marker)

    @workflow.step(retry_exceptions=(ValueError,), max_retries=3)
    def flaky():
        n = len(os.listdir(marker))
        open(os.path.join(marker, f"a{n}"), "w").close()
        if n < 2:
            raise ValueError("transient")
        return "ok"

    @workflow.step(catch_exceptions=True)
    def fails():
        raise KeyError("caught")

    def flow():
        first = flaky()
        res, err = fails()
        return first, res, type(err).__name__

    out = workflow.run(flow, workflow_id="wfr", storage=store)
    assert out == ("ok", None, "KeyError")
    assert len(os.listdir(marker)) == 3  # 2 failures + 1 success
    meta = workflow.get_metadata("wfr", storage=store)
    (step_rec,) = [m for f, m in meta["step_metadata"].items()
                   if "flaky" in f]
    assert step_rec["attempts"] == 3
    kinds = [e["event"] for e in meta["events"]]
    assert kinds.count("retrying") == 2 and "failed" in kinds


def test_workflow_step_timeout(ray_cluster, tmp_path):
    from ray_tpu_torch import workflow
    store = str(tmp_path / "store")

    @workflow.step(timeout=0.5, max_retries=0)
    def slow():
        import time as _t
        _t.sleep(30)

    def flow():
        return slow()

    with pytest.raises(workflow.StepTimeoutError):
        workflow.run(flow, workflow_id="wft", storage=store)
    st = workflow.get_status("wft", storage=store)
    assert st["status"] == "FAILED"


def test_workflow_list_and_status(ray_cluster, tmp_path):
    from ray_tpu_torch import workflow
    store = str(tmp_path / "store")

    @workflow.step
    def one():
        return 1

    workflow.run(lambda: one(), workflow_id="wl_ok", storage=store)
    listed = dict(workflow.list_workflows(storage=store))
    assert listed == {"wl_ok": "SUCCEEDED"}


# ----------------------------------------------------------- dashboard
def test_dashboard_endpoints(ray_cluster):
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.util.metrics import Counter

    @ray_tpu_torch.remote
    def touch():
        return 1

    ray_tpu_torch.get(touch.remote())
    Counter("dashboard_test_total").inc(3)
    port = start_dashboard(port=0)
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                return r.read()

        nodes = json.loads(get("/api/nodes"))
        assert nodes and nodes[0]["alive"]
        cluster = json.loads(get("/api/cluster"))
        assert cluster["total"]["CPU"] > 0
        assert "bytes" in cluster["object_store"]
        summary = json.loads(get("/api/task_summary"))
        assert summary.get("FINISHED", 0) >= 1
        html = get("/").decode()
        assert "ray_tpu_torch" in html
        metrics = get("/metrics").decode()
        # r11: /metrics is cluster-aggregated — every series carries
        # node/worker labels, user metrics included
        import re
        assert re.search(
            r'dashboard_test_total\{node="[^"]+",worker=""\} 3',
            metrics), metrics[:800]
        # runtime-instrumented series ride the same exposition
        assert "ray_tpu_task_e2e_s_count{" in metrics
        msum = json.loads(get("/api/metrics_summary"))
        assert msum["enabled"] and msum["sources"] >= 1
        # worker-manager table + usage rollup (frontend Workers tab)
        workers = json.loads(get("/api/workers"))
        assert workers and all("node_id" in w and "pid" in w
                               for w in workers)
        assert any(w["state"] for w in workers)
        usage = json.loads(get("/api/usage"))
        assert usage["nodes_alive"] >= 1
        assert usage["workers"] == len(workers)
        assert usage["uptime_s"] > 0
        assert usage["tasks"].get("FINISHED", 0) >= 1
        # serve_applications degrades to {} when serve is down
        assert json.loads(get("/api/serve_applications")) == {}
        # chrome-trace export parses and carries task events
        trace = json.loads(get("/api/timeline"))
        assert isinstance(trace, list)
    finally:
        stop_dashboard()


# ------------------------------------------------------- replay buffers
def test_replay_buffer_ring_semantics():
    from ray_tpu_torch.rllib.utils import ReplayBuffer
    buf = ReplayBuffer(capacity=8, seed=0)
    buf.add({"x": np.arange(6), "y": np.arange(6) * 2.0})
    assert len(buf) == 6
    buf.add({"x": np.arange(6, 12), "y": np.arange(6, 12) * 2.0})
    assert len(buf) == 8                      # wrapped
    s = buf.sample(32)
    assert s["x"].shape == (32,)
    np.testing.assert_array_equal(s["y"], s["x"] * 2.0)
    # oldest rows (0..3) were overwritten by the wrap
    assert s["x"].min() >= 4


def test_prioritized_buffer_biases_sampling_and_weights():
    from ray_tpu_torch.rllib.utils import PrioritizedReplayBuffer
    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, beta=0.5,
                                  seed=1)
    idx = buf.add({"x": np.arange(64)})
    pri = np.full(64, 1e-3)
    pri[7] = 10.0                             # one hot item
    buf.update_priorities(idx, pri)
    s = buf.sample(512)
    frac7 = float(np.mean(s["x"] == 7))
    assert frac7 > 0.8                        # dominates sampling
    assert s["weights"].max() <= 1.0 + 1e-6
    # the over-sampled item gets the SMALLEST importance weight
    assert s["weights"][s["x"] == 7].max() <= s["weights"].min() + 1e-6
    # priorities can be re-flattened
    buf.update_priorities(idx, np.ones(64))
    s2 = buf.sample(512)
    assert float(np.mean(s2["x"] == 7)) < 0.2


def test_schedules():
    from ray_tpu_torch.rllib.utils import (ConstantSchedule, LinearSchedule,
                                     PiecewiseSchedule)
    assert ConstantSchedule(0.3)(999) == 0.3
    lin = LinearSchedule(100, final_p=0.1, initial_p=1.0)
    assert lin(0) == 1.0
    assert abs(lin(50) - 0.55) < 1e-9
    assert abs(lin(1000) - 0.1) < 1e-9
    pw = PiecewiseSchedule([(0, 1.0), (10, 0.5), (20, 0.0)])
    assert pw(-5) == 1.0 and pw(5) == 0.75 and pw(15) == 0.25
    assert pw(99) == 0.0


def test_state_api_filters_and_getters(ray_cluster):
    from ray_tpu_torch.util import state as st

    @ray_tpu_torch.remote
    class Pinger:
        def ping(self):
            return "ok"

    a = Pinger.options(name="filter_target").remote()
    ray_tpu_torch.get(a.ping.remote())
    alive = st.list_actors(filters=[("state", "=", "ALIVE")])
    assert any(x.get("name") == "filter_target" for x in alive)
    assert st.list_actors(filters=[("state", "=", "NOPE")]) == []
    # contains + getter round-trip
    hit = st.list_actors(filters=[("name", "contains", "filter_t")])
    assert len(hit) == 1
    got = st.get_actor(hit[0]["actor_id"])
    assert got and got["name"] == "filter_target"
    with pytest.raises(ValueError, match="unknown filter op"):
        st.list_actors(filters=[("state", "~", "x")])
    summary = st.summarize_actors()
    assert summary.get("ALIVE", 0) >= 1
    ray_tpu_torch.kill(a)


def test_dashboard_jobs_and_logs_endpoints(ray_cluster):
    import json as _json
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.job_submission import default_client

    client = default_client()
    jid = client.submit_job(
        entrypoint="python -c \"print('hello-from-job')\"")
    client.wait_until_finished(jid, timeout=60)
    port = start_dashboard(port=0)
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                return _json.loads(r.read())
        jobs = get("/api/jobs")
        assert any(j["job_id"] == jid for j in jobs)
        logs = get("/api/logs")
        assert any(l["job_id"] == jid for l in logs)
        tail = get(f"/api/logs/{jid}?lines=10")
        assert "hello-from-job" in "\n".join(tail["lines"])
        assert isinstance(get("/api/actor_summary"), dict)
    finally:
        stop_dashboard()
