"""Direct actor call plane (r18): peer-to-peer submission, inline
replies, head out of the steady-state path.

Covers: the driver-as-caller direct path against an agent-hosted actor
(zero steady-state head frames), the worker-as-caller path (endpoint
resolve + dialed stream + inline-reply cache), the per-handle ordering
guarantee on the direct path / across an actor restart / across a
direct->head fallback redirect, the RAY_TPU_DIRECT_ACTOR=0 kill
switch, and the _submit_actor_task_inner send-failure race regression
(a recovery sweep claiming a spec between the failed send and the
repop used to drop the call silently).

The port's twin of `tests/test_direct_actor.py`, case for case.
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
class Counter:
    def __init__(self, log_path=None):
        self.log_path = log_path
        self.seen = []

    def add(self, i):
        self.seen.append(i)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(f"{os.getpid()}:{i}\n")
        return i

    def log(self):
        return list(self.seen)

    def big(self, n):
        import numpy as np
        return np.arange(n, dtype="int64")

    def die(self, once_marker=None):
        if once_marker is not None:
            # retried on the restarted instance: only the FIRST
            # incarnation actually dies
            if os.path.exists(once_marker):
                return "survived"
            open(once_marker, "w").close()
        os._exit(1)


def _head_actor_frames(rt) -> int:
    """Head control-plane involvement in actor calls: head-routed
    sends, head-processed actor completions, resolves, and mirror-
    delta frames. Load-independent counters, not timers."""
    st = rt._direct_stats
    return (st["head_routed_sends"] + st["head_actor_dones"]
            + st["resolves"] + st["delta_frames"])


def test_driver_direct_calls_skip_head(cluster):
    """Steady-state driver->agent actor calls go peer-to-peer: after
    the warmup call, N sync calls add ZERO head-routed actor frames
    and every reply lands inline."""
    rt, _ = cluster
    a = Counter.remote()
    assert ray_tpu_torch.get(a.add.remote(0)) == 0      # warm: actor ALIVE
    base_frames = _head_actor_frames(rt)
    base_direct = rt._direct_stats["direct_replies"]
    N = 30
    for i in range(1, N + 1):
        assert ray_tpu_torch.get(a.add.remote(i)) == i
    assert rt._direct_stats["direct_replies"] >= base_direct + N
    # the acceptance signal: head frames per steady-state call ~ 0
    assert _head_actor_frames(rt) - base_frames == 0
    assert rt._direct_stats["inline_bytes"] > 0
    ray_tpu_torch.kill(a)


def test_direct_large_result_located_and_pullable(cluster):
    """A large direct-call result stays holder-side; the reply's
    directory hint registers the location and the normal pull path
    fetches it."""
    rt, _ = cluster
    a = Counter.remote()
    ray_tpu_torch.get(a.add.remote(0))                  # warm
    n = 200_000                                   # ~1.6 MB > inline max
    ref = a.big.remote(n)
    arr = ray_tpu_torch.get(ref, timeout=30)
    assert arr.shape == (n,) and int(arr[-1]) == n - 1
    assert rt._direct_stats["direct_replies"] >= 1
    ray_tpu_torch.kill(a)


def test_direct_off_reverts_to_head_routed(cluster):
    """RAY_TPU_DIRECT_ACTOR=0: zero direct frames — every call rides
    the classic head-routed path (r17 byte shape)."""
    rt, _ = cluster
    from ray_tpu_torch._private.config import CONFIG
    os.environ["RAY_TPU_DIRECT_ACTOR"] = "0"
    CONFIG.reload()
    try:
        a = Counter.remote()
        for i in range(5):
            assert ray_tpu_torch.get(a.add.remote(i)) == i
        assert rt._direct_stats["direct_calls"] == 0
        assert rt._direct_stats["resolves"] == 0
        assert rt._direct_stats["head_routed_sends"] >= 5
        ray_tpu_torch.kill(a)
    finally:
        os.environ.pop("RAY_TPU_DIRECT_ACTOR", None)
        CONFIG.reload()


def test_ordering_direct_path(cluster):
    """Per-handle submission order on the direct path: a burst of
    async calls through one handle executes in order."""
    rt, _ = cluster
    a = Counter.remote()
    ray_tpu_torch.get(a.add.remote(-1))                 # warm: ALIVE
    refs = [a.add.remote(i) for i in range(60)]
    ray_tpu_torch.get(refs, timeout=30)
    log = ray_tpu_torch.get(a.log.remote(), timeout=10)
    assert log == [-1] + list(range(60))
    assert rt._direct_stats["direct_replies"] >= 30
    ray_tpu_torch.kill(a)


def test_ordering_across_restart_and_fallback(cluster, tmp_path):
    """Kill the actor's worker mid-stream (max_restarts=1,
    max_task_retries=1): pending direct calls NACK redirect-to-head,
    re-enter the head queue in submission order, and the restarted
    instance executes every surviving call in order — the per-handle
    guarantee holds across the direct->head fallback."""
    rt, _ = cluster
    log = tmp_path / "order.log"
    a = Counter.options(max_restarts=1, max_task_retries=1).remote(
        log_path=str(log))
    ray_tpu_torch.get(a.add.remote(-1))                 # warm: ALIVE, direct
    refs = [a.add.remote(i) for i in range(10)]
    a.die.remote(str(tmp_path / "died_once"))     # worker exits once
    refs += [a.add.remote(i) for i in range(10, 20)]
    vals = ray_tpu_torch.get(refs, timeout=60)
    assert vals == list(range(20))
    # order within each incarnation must be ascending (a retried call
    # may appear in both, but never out of order within one pid)
    by_pid: dict = {}
    for line in log.read_text().splitlines():
        pid, i = line.split(":")
        by_pid.setdefault(pid, []).append(int(i))
    assert len(by_pid) == 2, by_pid               # exactly one restart
    for seq in by_pid.values():
        filtered = [x for x in seq if x >= 0]
        assert filtered == sorted(filtered), by_pid
    # the fallback happened (redirects counted) and later calls flowed
    assert rt._direct_stats["redirects"] >= 1
    ray_tpu_torch.kill(a)


def test_direct_dead_actor_errors(cluster):
    """Actor dies with no restarts left: in-flight direct calls
    resolve with ActorDiedError/ActorError, never hang."""
    rt, _ = cluster
    a = Counter.remote()
    ray_tpu_torch.get(a.add.remote(0))
    refs = [a.add.remote(i) for i in range(5)]
    a.die.remote()
    refs += [a.add.remote(99)]
    from ray_tpu_torch.exceptions import RayTpuError
    results = []
    for r in refs:
        try:
            results.append(ray_tpu_torch.get(r, timeout=30))
        except RayTpuError as e:
            results.append(e)
    # every call resolved (value or error) — zero hangs
    assert len(results) == 6
    assert any(isinstance(v, Exception) for v in results)


def test_worker_caller_direct(cluster):
    """A worker-resident caller resolves the endpoint once, streams
    calls peer-to-peer, and lands replies inline — the head's actor
    frames stay flat while the caller drives."""
    rt, _ = cluster
    target = Counter.remote()
    ray_tpu_torch.get(target.add.remote(0))

    @ray_tpu_torch.remote(resources={"agent": 0.01})
    def drive(h, n):
        vals = [ray_tpu_torch.get(h.add.remote(i)) for i in range(1, n + 1)]
        from ray_tpu_torch._private import context as _c
        d = _c.get_ctx()._direct
        return vals, (dict(d.stats) if d is not None else None)

    vals, stats = ray_tpu_torch.get(drive.remote(target, 12), timeout=60)
    assert vals == list(range(1, 13))
    assert stats is not None and stats["direct_replies"] >= 10, stats
    assert stats["resolves"] <= 2
    ray_tpu_torch.kill(target)


def test_worker_socket_upgrade(cluster):
    """Once heartbeats carry the target worker's direct port, the
    driver's calls ride the WORKER's own socket — the agent's hosted
    counter stops moving while calls keep succeeding."""
    rt, _ = cluster
    a = Counter.remote()
    ray_tpu_torch.get(a.add.remote(0))
    handle = next(n.scheduler for n in rt.cluster.alive_nodes()
                  if not n.is_head)
    rec = rt.controller.get_actor(a._actor_id)
    assert _wait(lambda: handle.direct_port_of(rec.worker_id)), \
        "worker direct port never rode a heartbeat"
    # driver upgrades at a quiet moment (no in-flight calls)
    base_replies = rt._direct_stats["direct_replies"]
    for i in range(10):
        assert ray_tpu_torch.get(a.add.remote(i)) == i
    assert rt._direct_stats["direct_replies"] >= base_replies + 10
    time.sleep(1.2)        # agent heartbeat with its served counter
    served = (handle.direct_stats or {}).get("served", 0)
    for i in range(10):
        assert ray_tpu_torch.get(a.add.remote(i)) == i
    time.sleep(1.2)
    served2 = (handle.direct_stats or {}).get("served", 0)
    assert served2 == served, \
        f"agent still hosting after upgrade ({served} -> {served2})"
    ray_tpu_torch.kill(a)


def test_resolve_states(cluster):
    """ACTOR_RESOLVE contract: unknown/dead/pending actors and
    head-local actors answer the right shapes."""
    rt, _ = cluster
    rep = rt._resolve_actor_endpoint("no_such_actor")
    assert rep["direct"] is False and rep["state"] == "dead"

    @ray_tpu_torch.remote(resources={"head": 0.5})
    class Local:
        def ping(self):
            return 1

    loc = Local.remote()
    assert ray_tpu_torch.get(loc.ping.remote()) == 1
    rec = rt.controller.get_actor(loc._actor_id)
    rep = rt._resolve_actor_endpoint(loc._actor_id)
    # head-local on a loopback bind: direct endpoint = head listener
    assert rep["direct"] is True
    assert rep["node_id"] == rt.head_node_id
    assert rep["worker_id"] == rec.worker_id

    a = Counter.remote()
    ray_tpu_torch.get(a.add.remote(0))
    rep = rt._resolve_actor_endpoint(a._actor_id)
    assert rep["direct"] is True and rep["node_id"] != rt.head_node_id
    assert rep["epoch"] == 0 and rep["incarnation"] is not None
    ray_tpu_torch.kill(a)


def test_send_race_keeps_recovered_claim(cluster):
    """Regression (r18 satellite): _send_actor_task fails while a
    concurrent recovery sweep already claimed the spec — the failure
    path must NOT pop/requeue (the sweep owns it; the old blind pop
    silently dropped the call when a flush had re-inserted it)."""
    rt, _ = cluster
    a = Counter.remote()
    ray_tpu_torch.get(a.add.remote(0))
    aid = a._actor_id
    st = rt._actor_state(aid)
    from ray_tpu_torch._private.specs import ActorTaskSpec, new_task_id
    tid = new_task_id()
    spec = ActorTaskSpec(task_id=tid, actor_id=aid,
                         method_name="add", args=(1,),
                         return_ids=[tid + "r0"], name="Counter.add")
    rt.addref(tid + "r0")      # what ActorMethod.remote does
    base = rt._direct_stats["send_race_kept"]
    orig = rt._send_actor_task

    def racing_send(worker_id, s):
        # a recovery sweep runs between the send attempt and its
        # failure: it claims every inflight spec and requeues ours
        with st.lock:
            st.epoch += 1
            st.inflight.pop(s.task_id, None)
            st.queued.append(s)
        return False

    from ray_tpu_torch._private.config import CONFIG
    os.environ["RAY_TPU_DIRECT_ACTOR"] = "0"
    CONFIG.reload()
    rt._send_actor_task = racing_send
    try:
        rt._submit_actor_task_inner(aid, spec)
    finally:
        rt._send_actor_task = orig
        os.environ.pop("RAY_TPU_DIRECT_ACTOR", None)
        CONFIG.reload()
    assert rt._direct_stats["send_race_kept"] == base + 1
    with st.lock:
        # exactly one copy of the call survives, owned by the sweep
        assert [s.task_id for s in st.queued].count(tid) == 1
        assert tid not in st.inflight
    # the requeued copy drains and completes once the queue flushes
    rt._flush_actor_queue(aid)
    assert ray_tpu_torch.get(ray_tpu_torch.ObjectRef(tid + "r0"), timeout=20) == 1
    ray_tpu_torch.kill(a)


def test_inline_release_hook():
    """A released return ref drops its cached inline reply (the
    refs.py release-hook plumbing)."""
    from ray_tpu_torch._private.direct_actor import WorkerDirectCaller

    class _Conn:
        def peer_speaks_direct_actor(self):
            return False

    class _Ctx:
        conn = _Conn()

    d = WorkerDirectCaller(_Ctx())

    class _Stored:
        object_id = "oid1"
        nbytes = 3

    with d._lock:
        d._results["oid1"] = _Stored()
        d._oid_task["oid1"] = "t1"
    d.release(["oid1", "other"])
    assert d.take_inline("oid1") is None
    with d._lock:
        assert "oid1" not in d._oid_task


def test_on_actor_died_invalidates_endpoint_cache():
    """r20 regression: surfacing an ActorDiedError must drop the
    cached endpoint AND the negative-resolve memo so a restarted actor
    is re-resolved on the next call (not NACK-discovered), and clear
    the sticky fallback only when no calls are in flight."""
    from ray_tpu_torch._private.direct_actor import WorkerDirectCaller

    class _Conn:
        def peer_speaks_direct_actor(self):
            return False

    class _Ctx:
        conn = _Conn()

    d = WorkerDirectCaller(_Ctx())
    with d._lock:
        d._endpoints["a1"] = {"host": "h", "port": 1}
        d._neg["a1"] = time.monotonic() + 60.0   # backoff from a race
        d._fallback.add("a1")
    d.on_actor_died("a1")
    with d._lock:
        assert "a1" not in d._endpoints
        assert "a1" not in d._neg                # next call re-resolves
        assert "a1" not in d._fallback           # books empty: unstick
    # with calls still pending the fail/NACK discipline owns the flag
    with d._lock:
        d._endpoints["a2"] = {"host": "h", "port": 2}
        d._fallback.add("a2")
        d._actor_pending["a2"] = 1
    d.on_actor_died("a2")
    with d._lock:
        assert "a2" not in d._endpoints
        assert "a2" in d._fallback               # sticky until drained


def test_get_surfaces_actor_death_to_direct_caller():
    """The worker get() path routes an ActorDiedError (raw or wrapped
    in a TaskError cause chain) into on_actor_died."""
    from ray_tpu_torch._private.worker_main import WorkerContext
    from ray_tpu_torch.exceptions import ActorDiedError, TaskError

    class _Caller:
        def __init__(self):
            self.seen = []

        def on_actor_died(self, actor_id):
            self.seen.append(actor_id)

    ctx = WorkerContext.__new__(WorkerContext)
    ctx._direct = _Caller()
    ctx._note_actor_death(ActorDiedError("a1", "gone"))
    ctx._note_actor_death(
        TaskError(ActorDiedError("a2", "gone"), "tb"))
    ctx._note_actor_death(ValueError("unrelated"))
    ctx._note_actor_death(TaskError(ValueError("x"), "tb"))
    assert ctx._direct.seen == ["a1", "a2"]
    ctx._direct = None
    ctx._note_actor_death(ActorDiedError("a3", "gone"))   # no caller: noop


def test_delta_window_adapts_to_caller_rate():
    """r20: the ACTOR_INFLIGHT_DELTA collect window widens while
    flushes run near-empty (sparse caller) and shrinks back toward
    the base when frames fill — head mirror frames amortize by call
    count, not wall clock."""
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.direct_actor import WorkerDirectCaller

    class _Conn:
        def __init__(self):
            self.sent = []

        def peer_speaks_direct_actor(self):
            return False

        def send(self, msg):
            self.sent.append(msg)

    class _Ctx:
        def __init__(self):
            self.conn = _Conn()

    d = WorkerDirectCaller(_Ctx())
    base = CONFIG.direct_actor_delta_delay_ms
    cap = CONFIG.direct_actor_delta_delay_max_ms
    assert d._delta_delay_ms() == base
    # sparse flushes (1 entry each) double the window up to the cap
    widths = []
    for _ in range(16):
        with d._delta_lock:
            d._delta_buf.append(("done", "a1", "t", False, [], True))
        d.flush_delta()
        widths.append(d._delta_delay_ms())
    assert widths[0] == base * 2
    assert widths[-1] == cap
    assert all(b >= a for a, b in zip(widths, widths[1:]))
    # near-full frames (>= delta_max/2 entries) halve back toward the
    # base — no cap<->base sawtooth for a mid-rate caller
    shrink = []
    for _ in range(16):
        with d._delta_lock:
            for i in range(CONFIG.direct_actor_delta_max // 2):
                d._delta_buf.append(
                    ("done", "a1", f"t{i}", False, [], True))
        d.flush_delta()
        shrink.append(d._delta_delay_ms())
    assert shrink[0] == cap / 2
    assert shrink[-1] == base
    assert all(b <= a for a, b in zip(shrink, shrink[1:]))
    assert len(d._ctx.conn.sent) == 32        # every flush one frame
