"""Delegated bulk-lease scheduling (r10): the head grants agents
batches of queued tasks (NODE_LEASE_BATCH), agents schedule locally and
report completions in coalesced NODE_TASK_DONE_BATCH frames, per-task
dispatch events are suppressed — while the head keeps ownership (lease
revoke, steal-back, exactly-once resubmit on agent death) and the N10
heartbeat delta-sync keeps its resource view converged.

The port's twin of `tests/test_delegated_lease.py`, case for case.
"""
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import NodeAgentProcess


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


AGENT_RES = {"agent": 100.0}


def _wait(pred, timeout=30.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(step)
    return pred()


def _agent_handle(rt):
    for n in rt.cluster.alive_nodes():
        if not n.is_head:
            return n.scheduler          # RemoteNodeHandle
    return None


@pytest.fixture
def cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=2, resources={"head": 1.0})
    agents = [NodeAgentProcess(num_cpus=2, resources=AGENT_RES)]
    assert _wait(lambda: len(rt.cluster.alive_nodes()) >= 2), \
        "agent failed to register"
    yield rt, agents
    for a in agents:
        a.terminate()
    for a in agents:
        a.wait(10)
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(resources={"agent": 0.01})
def _double(x):
    return x * 2


def test_bulk_lease_grant_consume_accounting_and_coalescing(cluster):
    """N tasks ride FAR fewer lease batches than N (bulk grants), the
    agent's ledger consumes every grant (no lease leaks), and
    completions coalesce into done batches — the per-task round-trips
    delegation exists to remove."""
    rt, agents = cluster
    handle = _agent_handle(rt)
    assert handle.delegates(), "agent did not negotiate delegation"
    N = 120
    out = ray_tpu_torch.get([_double.remote(i) for i in range(N)], timeout=120)
    assert out == [i * 2 for i in range(N)]
    # head-side grant accounting
    assert handle._tasks_leased == N
    assert 0 < handle._leases_sent < N / 2, handle._leases_sent
    assert len(handle._leased) == 0          # all consumed
    # agent-side ledger (rides heartbeats; wait for the next beat)
    stats = _wait(lambda: (handle.delegate_stats
                           if handle.delegate_stats.get(
                               "tasks_done") == N else None))
    assert stats, handle.delegate_stats
    assert stats["tasks_leased"] == N
    assert stats["open_leases"] == 0         # fully-consumed leases pruned
    assert stats["outstanding"] == 0
    assert stats["lease_batches"] == handle._leases_sent
    assert 0 < stats["done_batches"] < N / 2, stats
    assert stats["dispatch_events_suppressed"] == N


def test_lease_revoke_mid_batch(cluster):
    """Revoking a lease pulls queued-not-started tasks back to the
    head (pending queue + worker-FIFO tombstone path). The hand-back
    is the agent's fire-and-forget lease_reclaimed event; the head
    re-places the mirror specs automatically and every task still
    runs exactly once."""
    rt, agents = cluster
    handle = _agent_handle(rt)

    @ray_tpu_torch.remote(resources={"agent": 0.01}, num_cpus=1)
    def slow(x):
        time.sleep(0.3)
        return x + 1000

    # 2 CPUs on the agent: most of the batch sits queued behind the
    # first few slow tasks
    refs = [slow.remote(i) for i in range(16)]
    task_ids = [r.object_id.split("r", 1)[0] for r in refs]
    # wait until at least one task is actually EXECUTING (worker spawn
    # takes seconds; revoking before that would reclaim all 16)
    assert _wait(lambda: any(
        handle.worker_running_task(t) is not None for t in task_ids[:4]),
        timeout=60)
    handle.revoke_lease(task_ids)        # fire-and-forget steal
    # the agent's ledger confirms a mid-batch reclaim happened
    # (heartbeat-carried), and fewer than all 16 moved: running tasks
    # stay leased and finish in place
    revoked = _wait(lambda: handle.delegate_stats.get("revoked", 0)
                    or None, timeout=20)
    assert revoked, handle.delegate_stats
    assert revoked < 16, "running tasks must stay leased"
    # reclaimed specs re-placed by the lease_reclaimed event handler:
    # every result still arrives exactly once
    out = ray_tpu_torch.get(refs, timeout=120)
    assert out == [i + 1000 for i in range(16)]


def test_agent_death_with_outstanding_lease_exactly_once(cluster,
                                                         tmp_path):
    """Killing an agent holding a bulk lease loses zero tasks: every
    task completes after resubmission, and none is resubmitted more
    than once (execution count per task <= 2: at most the interrupted
    attempt plus the one resubmit)."""
    rt, agents = cluster
    marker_dir = str(tmp_path)

    @ray_tpu_torch.remote(resources={"agent": 0.01}, num_cpus=1)
    def tracked(i, d):
        with open(os.path.join(d, f"t{i}"), "a") as f:
            f.write(f"{os.getpid()}\n")
        time.sleep(0.05)
        return i

    refs = [tracked.remote(i, marker_dir) for i in range(40)]
    _wait(lambda: len(handle._leased) > 0
          if (handle := _agent_handle(rt)) else False)
    time.sleep(0.8)                      # some done, a lease outstanding
    agents[0].kill()                     # SIGKILL: no goodbye
    agents.append(NodeAgentProcess(num_cpus=2, resources=AGENT_RES))
    out = ray_tpu_torch.get(refs, timeout=180)
    assert out == list(range(40)), "tasks lost across agent death"
    for i in range(40):
        runs = len(open(os.path.join(marker_dir, f"t{i}")).readlines())
        assert 1 <= runs <= 2, f"task {i} ran {runs} times"


def test_steal_interaction_with_tombstone_path(cluster):
    """Delegated tasks pipelined behind a task that blocks in get()
    are stolen back through the r6 UNQUEUE tombstone machinery and
    re-dispatched — the nested-submission deadlock must not return
    under bulk leases."""
    rt, agents = cluster

    @ray_tpu_torch.remote(resources={"agent": 0.01}, num_cpus=1)
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote(resources={"agent": 0.01}, num_cpus=1)
    def outer(x):
        # blocks this worker in get(): pipelined successors must be
        # stolen back or (transitively) never run
        return ray_tpu_torch.get(inner.remote(x)) + 100

    out = ray_tpu_torch.get([outer.remote(i) for i in range(8)], timeout=120)
    assert out == [i + 101 for i in range(8)]


def test_cancel_spec_parked_in_lease_buffer(cluster, monkeypatch):
    """With the outstanding-task budget saturated, a spec can sit in
    the head-side lease buffer; cancelling it must remove it LOCALLY
    (the agent has never seen it) — not silently no-op and let it
    lease out later."""
    from ray_tpu_torch._private.config import CONFIG
    rt, agents = cluster
    monkeypatch.setenv("RAY_TPU_DELEGATE_MAX_INFLIGHT", "2")
    CONFIG.reload()
    try:
        handle = _agent_handle(rt)

        @ray_tpu_torch.remote(resources={"agent": 0.01}, num_cpus=1)
        def slow(x):
            time.sleep(0.4)
            return x

        refs = [slow.remote(i) for i in range(8)]
        assert _wait(lambda: len(handle._lease_buf) > 0), \
            "budget cap never parked a spec"
        victim_tid = handle._lease_buf[-1].task_id
        victim = next(r for r in refs
                      if r.object_id.startswith(victim_tid))
        ray_tpu_torch.cancel(victim)
        with pytest.raises(Exception):
            ray_tpu_torch.get(victim, timeout=60)
        rest = [r for r in refs if r is not victim]
        out = ray_tpu_torch.get(rest, timeout=120)
        assert sorted(out) == sorted(
            i for i in range(8)
            if not refs[i].object_id.startswith(victim_tid))
    finally:
        CONFIG.reload()


@pytest.mark.slow        # ~10s: rides the default suite, not tier-1;
                         # test_lease_revoke_mid_batch is the fast
                         # tier-1 sibling for the revoke machinery
def test_rebalance_steals_leased_backlog(cluster):
    """The production steal path: an agent holding a bulk-leased
    backlog it can't drain fast gets queued-not-started tasks revoked
    by the head's rebalance sweep and re-placed on a later-joining
    idle agent — work ends up executing on BOTH nodes."""
    rt, agents = cluster

    @ray_tpu_torch.remote(resources={"agent": 0.01}, num_cpus=1)
    def where(i):
        time.sleep(0.8)
        return os.environ.get("RAY_TPU_NODE_ID")

    refs = [where.remote(i) for i in range(16)]
    # backlog leased to the only agent first; THEN a second joins idle
    assert _wait(lambda: _agent_handle(rt)._tasks_leased >= 1)
    agents.append(NodeAgentProcess(num_cpus=2, resources=AGENT_RES))
    out = ray_tpu_torch.get(refs, timeout=120)
    assert len(out) == 16 and all(out)
    assert len(set(out)) >= 2, \
        f"rebalance never moved leased backlog: {set(out)}"


def test_delegate_off_restores_per_task_protocol(tmp_path):
    """RAY_TPU_DELEGATE=0 (both sides): no lease batches, per-task
    NODE_ENQUEUE + dispatch events + NODE_TASK_DONE — and the same
    results."""
    from ray_tpu_torch._private.config import CONFIG
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_DELEGATE"] = "0"
    CONFIG.reload()
    agents = []
    try:
        rt = ray_tpu_torch.init(num_cpus=2, resources={"head": 1.0})
        agents.append(NodeAgentProcess(num_cpus=2, resources=AGENT_RES))
        assert _wait(lambda: len(rt.cluster.alive_nodes()) >= 2)
        handle = _agent_handle(rt)
        assert not handle.delegates()
        out = ray_tpu_torch.get([_double.remote(i) for i in range(30)],
                          timeout=120)
        assert out == [i * 2 for i in range(30)]
        assert handle._leases_sent == 0
        assert handle._tasks_leased == 0
        # per-task dispatch events flowed: the mirror saw RUNNING
        stats = _wait(lambda: (handle.delegate_stats
                               if handle.delegate_stats else None))
        assert stats.get("lease_batches", 0) == 0
    finally:
        for a in agents:
            a.terminate()
        for a in agents:
            a.wait(10)
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_DELEGATE", None)
        CONFIG.reload()


def test_heartbeat_delta_sync_and_resync(cluster):
    """N10: steady-state beats are seq-numbered DELTAS that omit the
    unchanged resource view; a seq gap triggers NODE_HB_RESYNC and the
    next beat is a full snapshot; the head's view stays correct."""
    rt, agents = cluster
    handle = _agent_handle(rt)
    beats = []
    orig = handle.on_heartbeat
    handle.on_heartbeat = lambda m: (beats.append(dict(m)), orig(m))[1]
    try:
        # drain a few tasks so ledgers churned at least once
        ray_tpu_torch.get([_double.remote(i) for i in range(8)], timeout=60)
        time.sleep(1.5)                 # let the pool settle to idle
        beats.clear()
        assert _wait(lambda: len(beats) >= 4, timeout=10)
        idle = [b for b in beats if b.get("hb_delta")]
        assert idle, "no delta beats while idle"
        for b in idle[-2:]:
            # the steady-state delta omits the whole resource view AND
            # the wire counters (whose per-beat tick is the heartbeat's
            # own send cost, normalized away) — the degenerate beat
            assert "avail" not in b and "workers" not in b \
                and "pending_shapes" not in b and "wire" not in b, \
                sorted(b)
        seqs = [b["hb_seq"] for b in beats if "hb_seq" in b]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        # force a seq gap head-side: the head must request a resync
        # and the agent must answer with a full snapshot
        with handle._lock:
            handle._hb_seq -= 3
        full = _wait(lambda: next(
            (b for b in beats[-4:] if "hb_seq" in b
             and not b.get("hb_delta") and "avail" in b), None),
            timeout=10)
        assert full, "no full snapshot after forced seq gap"
        # view still converged: idle node reports full availability
        assert _wait(lambda: handle.effective_avail().get("CPU")
                     == handle.total.get("CPU"), timeout=10)
    finally:
        handle.on_heartbeat = orig
