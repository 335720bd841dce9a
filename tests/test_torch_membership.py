"""Partition-tolerant membership (r17): incarnation fencing,
suspicion-based liveness, and protocol-level network fault injection.

Tier-1 units per r17: incarnation monotonicity across head
restarts (WAL round-trip), stale-attempt terminal drop (first-terminal-
wins), suspect -> schedulable_nodes exclusion with free recovery, the
fenced-agent clean re-register, and the sub-suspect blip costing zero
recoveries. The 5k partition-mid-delegated-drain exactly-once gate and
the seeded chaos soak matrix are slow-marked multi-process e2es; the
units here are their tier-1 siblings.

The port's twin of `tests/test_membership.py`, case for case.
"""
import collections
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.controller import Controller
from ray_tpu_torch._private.specs import TaskSpec, bump_attempt

import torch_chaos as chaos


@pytest.fixture()
def fresh_cluster():
    """The conftest fixture of the same name, on the port: an isolated
    runtime, any live one shut down first."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


def _wait(pred, timeout=30.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(step)
    return pred()


# ------------------------------------------------ incarnation table
def test_incarnation_monotonic_across_wal_roundtrip(tmp_path):
    """Incarnations survive snapshot + WAL replay and keep rising: a
    zombie from before ANY head restart still fences."""
    from ray_tpu_torch._private.head_ha import WriteAheadLog, read_wal
    c = Controller()
    assert c.mint_incarnation("node_a") == 1
    assert c.mint_incarnation("node_a") == 2
    assert c.bump_incarnation("node_a") == 3       # death declaration
    assert c.mint_incarnation("node_b") == 1
    # snapshot round-trip preserves the table
    blob = c.snapshot_state()
    c2 = Controller()
    c2.restore_state(blob)
    assert c2.node_incarnation("node_a") == 3
    assert c2.node_incarnation("node_b") == 1
    assert c2.mint_incarnation("node_a") == 4      # still monotonic
    # WAL replay path: records are max-merge (idempotent, reorderable)
    wal = WriteAheadLog(str(tmp_path / "inc.wal"), fsync_ms=0.0)
    wal.append("incarnation", ("node_a", 3))
    wal.append("incarnation", ("node_a", 5))
    wal.append("incarnation", ("node_a", 4))       # stale duplicate
    wal.sync()
    wal.close()
    c3 = Controller()
    for _ in range(2):                             # replay twice
        for _seq, rtype, data in read_wal(wal.path):
            c3.apply_wal_record(rtype, data)
    assert c3.node_incarnation("node_a") == 5
    assert c3.mint_incarnation("node_a") == 6


# --------------------------------------------- stale-attempt fencing
def test_stale_attempt_terminal_drop(fresh_cluster):
    """First-terminal-wins: a completion carrying an attempt older
    than the live spec's is dropped whole — no seal, no event, no
    live-task pop — closing the zombie-races-the-winner window."""
    rt = fresh_cluster
    spec = TaskSpec(task_id="ab" * 8, func_id="f" * 16,
                    return_ids=["ab" * 8 + "r0"], name="t_stale")
    rt.controller.task_submitted(spec)
    bump_attempt(spec)                 # re-placed once: attempt 1
    assert spec.attempt == 1
    before = dict(rt._fence_stats)
    # zombie's completion for attempt 0: dropped before anything lands
    rt._apply_node_done("node_zombie", None,
                        {"task_id": spec.task_id, "attempt": 0,
                         "name": "t_stale"})
    assert rt._fence_stats["stale_attempt_drops"] == \
        before["stale_attempt_drops"] + 1
    assert rt.controller.live_task(spec.task_id) is spec
    # the winner's completion (current attempt) is admitted
    rt._apply_node_done("node_winner", None,
                        {"task_id": spec.task_id, "attempt": 1,
                         "name": "t_stale"})
    assert rt._fence_stats["stale_attempt_drops"] == \
        before["stale_attempt_drops"] + 1
    # entries without an attempt field (pre-r17 agents) pass through
    rt._apply_node_done("node_old", None,
                        {"task_id": spec.task_id, "name": "t_stale"})


def test_bump_attempt_on_node_death_resubmit(fresh_cluster):
    """The death path re-places queued work with a bumped attempt, so
    the re-placed winner outranks any zombie completion."""
    rt = fresh_cluster
    import ray_tpu_torch.cluster_utils as cu
    cluster = cu.Cluster(initialize_head=False)
    nid = cluster.add_node(num_cpus=1, resources={"victim": 4.0})

    @ray_tpu_torch.remote(resources={"victim": 1.0}, max_retries=3)
    def g(x):
        time.sleep(0.2)
        return x

    refs = [g.remote(i) for i in range(8)]
    time.sleep(0.1)
    mirror = [rt.controller.live_task(r.object_id.split("r", 1)[0])
              for r in refs]
    rt.cluster.remove_node(nid, graceful=True)
    # re-placed specs carry attempt >= 1 now
    bumped = [s for s in mirror
              if s is not None and getattr(s, "attempt", 0) >= 1]
    assert bumped, "no re-placed spec had its attempt bumped"
    cluster.add_node(num_cpus=1, resources={"victim": 4.0})
    assert ray_tpu_torch.get(refs, timeout=60) == list(range(8))


# ------------------------------------------------- suspicion (r17b)
def test_suspect_excluded_then_free_recovery(fresh_cluster):
    """A stale-heartbeat node turns SUSPECT: excluded from
    schedulable_nodes, still alive, NO recovery runs — and the next
    heartbeat restores it for free (no DEAD event, no resubmits)."""
    rt = fresh_cluster
    import ray_tpu_torch.cluster_utils as cu
    cluster = cu.Cluster(initialize_head=False)
    nid = cluster.add_node(num_cpus=1)
    rec = rt.cluster.get_node(nid)
    # pause the node's dispatch-tick heartbeat (it beats every ~50 ms
    # and clears suspicion inline — racing it makes the rewind flaky),
    # rewind past the suspect threshold, run one deterministic sweep
    sched = rec.scheduler
    sched._cluster = None
    try:
        rec.last_heartbeat = time.monotonic() - (CONFIG.suspect_s + 0.05)
        rt.cluster._sweep_liveness()
        assert rec.suspect and rec.alive
        assert nid not in [n.node_id
                           for n in rt.cluster.schedulable_nodes()]
        assert rt.cluster.is_suspect(nid)
        assert rt.cluster.liveness_counters["suspected"] >= 1
        lv = rt.state_op("liveness_stats")
        assert {r["node_id"]: r["state"] for r in lv["nodes"]}[nid] \
            == "suspect"
    finally:
        sched._cluster = rt.cluster    # resume heartbeats
    # the node's scheduler loop heartbeats every ~50 ms: recovery is
    # free — no re-placement, no death, just the flag clearing
    assert _wait(lambda: not rec.suspect, 3.0)
    rt.cluster._sweep_liveness()       # publishes deferred RECOVERED
    assert rec.alive
    assert nid in [n.node_id for n in rt.cluster.schedulable_nodes()]
    assert rt.cluster.liveness_counters["recovered"] >= 1
    assert rt.cluster.liveness_counters["deaths"] == 0
    states = [e["state"] for e in rt.controller.list_task_events(2000)]
    assert "RESUBMITTED" not in states


# ----------------------------------- chaos-backed fencing (fast e2e)
@pytest.fixture()
def chaos_head():
    """Head with the chaos layer on and 1 s death detection; agents
    appended to the list are reaped on exit."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    prev = {k: os.environ.get(k) for k in
            ("RAY_TPU_CHAOS", "RAY_TPU_HEARTBEAT_TIMEOUT_S",
             "RAY_TPU_SUSPECT_S")}
    os.environ["RAY_TPU_CHAOS"] = "1"
    os.environ["RAY_TPU_HEARTBEAT_TIMEOUT_S"] = "1.0"
    os.environ["RAY_TPU_SUSPECT_S"] = "0.7"
    CONFIG.reload()
    rt = ray_tpu_torch.init(num_cpus=1, resources={"head": 4.0})
    agents = []
    yield rt, agents
    chaos.heal()
    for a in agents:
        a.terminate()
    for a in agents:
        a.wait(5)
    ray_tpu_torch.shutdown()
    for k, v in prev.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    CONFIG.reload()


def _join_agent(rt, agents, **kw):
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    n0 = len(rt.cluster.alive_nodes())
    agents.append(NodeAgentProcess(**kw))
    assert _wait(lambda: len(rt.cluster.alive_nodes()) > n0, 20), \
        "agent failed to register"
    return [n.node_id for n in rt.cluster.alive_nodes()
            if not n.is_head][-1]


def test_fenced_agent_clean_reregister(chaos_head):
    """Partition an agent past the death timeout, heal: its next frame
    is fenced (stale incarnation), it kills workers + clears ledgers,
    re-registers fresh with a higher incarnation, and takes new work."""
    rt, agents = chaos_head
    nid = _join_agent(rt, agents, num_cpus=2, resources={"ag": 8.0})
    inc0 = rt.controller.node_incarnation(nid)
    assert inc0 == 1

    @ray_tpu_torch.remote(resources={"ag": 1.0})
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1), timeout=30) == 2
    chaos.partition(rt, nid)
    assert _wait(lambda: not rt.cluster.get_node(nid).alive, 10), \
        "partitioned node not declared dead"
    chaos.heal(rt, nid)
    assert _wait(lambda: rt.cluster.get_node(nid).alive, 20), \
        "fenced agent did not re-register"
    assert rt.controller.node_incarnation(nid) > inc0
    assert rt._fence_stats["fence_notices"] >= 1
    assert rt.cluster.liveness_counters["fenced"] >= 1
    # takes new work on fresh workers
    assert ray_tpu_torch.get(f.remote(10), timeout=40) == 11


def test_blip_below_suspect_threshold_no_recovery(chaos_head):
    """A partition shorter than RAY_TPU_SUSPECT_S + heartbeat period
    costs NOTHING: no suspicion escalation to death, no re-placement,
    no fencing, same incarnation."""
    rt, agents = chaos_head
    nid = _join_agent(rt, agents, num_cpus=2, resources={"ag": 8.0})
    inc0 = rt.controller.node_incarnation(nid)

    @ray_tpu_torch.remote(resources={"ag": 1.0})
    def f(x):
        return x * 3

    assert ray_tpu_torch.get(f.remote(3), timeout=30) == 9
    deaths0 = rt.cluster.liveness_counters["deaths"]
    chaos.partition(rt, nid)
    time.sleep(0.3)                    # < suspect_s (0.7) < timeout (1)
    chaos.heal(rt, nid)
    time.sleep(1.5)                    # give the sweep time to misfire
    rec = rt.cluster.get_node(nid)
    assert rec.alive and not rec.suspect
    assert rt.cluster.liveness_counters["deaths"] == deaths0
    assert rt.controller.node_incarnation(nid) == inc0
    assert rt._fence_stats["fenced_frames"] == 0
    states = [e["state"] for e in rt.controller.list_task_events(2000)]
    assert "RESUBMITTED" not in states
    assert ray_tpu_torch.get(f.remote(5), timeout=30) == 15


# --------------------------------------------- slow chaos gates (r17)
@pytest.mark.slow    # ~30s multi-process e2e; tier-1 siblings:
                     # test_fenced_agent_clean_reregister + the units
def test_partition_mid_delegated_drain_exactly_once(chaos_head):
    """THE r17 gate: partition an agent mid-5k-delegated-drain past
    the death timeout, heal — every task accounted exactly once at the
    head (zero lost, zero double-counted), the fenced agent
    re-registers and finishes the backlog."""
    rt, agents = chaos_head
    os.environ["RAY_TPU_TASK_EVENT_HISTORY"] = "40000"
    try:
        rt.controller._task_events = collections.deque(
            rt.controller._task_events, maxlen=40000)
        nid = _join_agent(rt, agents, num_cpus=4,
                          resources={"ag": 1e9})
        N = 5000

        @ray_tpu_torch.remote(resources={"ag": 1.0})
        def f(x):
            return x

        refs = [f.remote(i) for i in range(N)]
        assert _wait(lambda: len(rt.controller.live_task_ids())
                     <= N - 800, 60), "drain never started"
        chaos.partition(rt, nid)
        assert _wait(lambda: not rt.cluster.get_node(nid).alive, 10)
        time.sleep(0.5)
        chaos.heal(rt, nid)
        assert _wait(lambda: rt.cluster.get_node(nid).alive, 20)
        assert ray_tpu_torch.get(refs, timeout=180) == list(range(N))
        term = collections.Counter()
        for ev in rt.controller.list_task_events(40000):
            if ev["state"] in ("FINISHED", "FAILED", "CANCELLED"):
                term[ev["task_id"]] += 1
        dup = {t: c for t, c in term.items() if c > 1}
        assert not dup, f"double-counted: {list(dup.items())[:5]}"
        assert len(term) == N, f"lost {N - len(term)} terminals"
        assert not rt.controller.live_task_ids()
        assert rt._fence_stats["fence_notices"] >= 1
    finally:
        os.environ.pop("RAY_TPU_TASK_EVENT_HISTORY", None)


@pytest.mark.slow    # seeded multi-scenario soak (standalone:
                     # python tools/torch_chaos_soak.py)
def test_chaos_soak_matrix(chaos_head):
    """One pass of the kill/partition/blip scenario matrix through the
    tools/torch_chaos_soak.py driver, small task counts."""
    rt, agents = chaos_head
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import torch_chaos_soak as chaos_soak
    for scenario in ("kill", "partition", "blip"):
        report = chaos_soak.run_scenario(rt, agents, scenario,
                                         seed=7, tasks=300)
        assert report["ok"], report
    # r18 direct actor plane: kill / partition mid-direct-call stream
    # (exactly-once-or-error, zero hangs, zombie endpoint fenced)
    for scenario in ("actor_kill", "actor_partition"):
        report = chaos_soak.run_actor_scenario(rt, agents, scenario,
                                               seed=7, calls=150)
        assert report["ok"], report
