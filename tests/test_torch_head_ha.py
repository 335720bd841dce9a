"""Head HA (r15): write-ahead-logged, restartable control plane.

Recovery matrix per r15: WAL record framing (torn tail
truncates at the last good CRC, replay idempotent), snapshot+WAL-tail
equivalence to the live tables, completion-batch replay dedup (no task
counted twice, none lost), lease-ledger resync after rejoin, and the
chaos gates — head SIGKILLed mid-delegated-drain completes every task
exactly once (slow-marked multi-process e2e; the in-process restart +
unit matrix below are its tier-1 siblings), head SIGKILLed mid-fit()
yields (step, loss) curves equal to an uninterrupted run.

The port's twin of `tests/test_head_ha.py`, case for case.
"""
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import head_ha, protocol
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.controller import Controller
from ray_tpu_torch._private.head_ha import (HeadPersistence, WriteAheadLog,
                                      frame_snapshot, read_wal,
                                      unframe_snapshot)
from ray_tpu_torch._private.specs import TaskSpec


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


def _spec(tid: str, **kw) -> TaskSpec:
    return TaskSpec(task_id=tid, func_id="f" * 16, args=(), kwargs={},
                    num_returns=1, return_ids=[tid + "r0"],
                    resources={"CPU": 1.0}, name="t_" + tid, **kw)


@pytest.fixture()
def ha_runtime(tmp_path):
    """Isolated runtime with head persistence (WAL mode) enabled."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    snap = str(tmp_path / "head.snap")
    os.environ["RAY_TPU_HEAD_SNAPSHOT_PATH"] = snap
    CONFIG.reload()
    rt = ray_tpu_torch.init(num_cpus=2)
    yield rt, snap
    ray_tpu_torch.shutdown()
    os.environ.pop("RAY_TPU_HEAD_SNAPSHOT_PATH", None)
    CONFIG.reload()


# ------------------------------------------------------- WAL framing
def test_wal_torn_tail_truncates_at_last_good_crc(tmp_path):
    path = str(tmp_path / "t.wal")
    wal = WriteAheadLog(path, fsync_ms=0.0)
    for i in range(10):
        wal.append("kv", ("ns", f"k{i}", i))
    wal.sync()
    wal.close()
    good = read_wal(path)
    assert [r[2][2] for r in good] == list(range(10))
    # torn tail: a crash mid-write leaves a partial frame — recovery
    # must keep every intact record and stop cleanly
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-7])
    recs = read_wal(path)
    assert [r[2][2] for r in recs] == list(range(9))
    # corrupt (not just short) tail: flipped bytes fail the CRC
    open(path, "wb").write(blob[:-4] + b"\xff\xff\xff\xff")
    recs = read_wal(path)
    assert [r[2][2] for r in recs] == list(range(9))
    # appends after recovery continue from the intact prefix
    wal2 = WriteAheadLog(path, fsync_ms=0.0)
    wal2.append("kv", ("ns", "k-post", "post"))
    wal2.sync()
    wal2.close()


def test_wal_ref_records_coalesce_to_absolute_values(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "r.wal"), fsync_ms=50.0)
    # a decref storm inside one flush window: many per-object updates,
    # ONE record, carrying the LAST (absolute) value per object
    for i in range(100):
        wal.log_ref("oid_a", i, 0)
    wal.log_ref("oid_b", 7, 2)
    wal.sync()
    wal.close()
    recs = [r for r in read_wal(wal.path) if r[1] == "refs"]
    assert len(recs) == 1
    assert recs[0][2]["oid_a"] == (99, 0)
    assert recs[0][2]["oid_b"] == (7, 2)


def test_wal_replay_is_idempotent(tmp_path):
    """Replaying the tail twice (the torn-compaction overlap) must
    converge to the same tables — records are set-semantics."""
    wal = WriteAheadLog(str(tmp_path / "i.wal"), fsync_ms=0.0)
    wal.append("kv", ("default", "k", "v"))
    wal.append("task", _spec("aa" * 8))
    wal.append("task_done", "aa" * 8)
    wal.append("task", _spec("bb" * 8))
    wal.append("dir+", ("obj1", "node_x", 128))
    wal.log_ref("obj1", 3, 1)
    wal.sync()
    wal.close()
    recs = read_wal(wal.path)

    def build(passes: int) -> Controller:
        c = Controller()
        ha = HeadPersistence(str(tmp_path / "s.snap"), wal.path)
        for _ in range(passes):
            ha.replay(c, recs, 0, {}, {})
        ha.close()
        return c

    c1, c2 = build(1), build(2)
    assert c1._kv == c2._kv == {("default", "k"): "v"}
    assert (c1.live_task_ids() == c2.live_task_ids() == ["bb" * 8])
    refs1, pins1 = c1.ref_tables()
    refs2, pins2 = c2.ref_tables()
    assert refs1 == refs2 == {"obj1": 3}
    assert pins1 == pins2 == {"obj1": 1}
    assert (c1.locations("obj1") == c2.locations("obj1")
            == ["node_x"])


# ------------------------------------------- snapshot + tail recovery
def test_snapshot_plus_wal_tail_equals_live_tables(ha_runtime):
    """After real task traffic, a fresh controller rebuilt from the
    snapshot + WAL tail matches the live head's tables exactly."""
    rt, snap = ha_runtime

    @ray_tpu_torch.remote
    def f(x):
        return x * 3

    refs = [f.remote(i) for i in range(25)]
    assert ray_tpu_torch.get(refs, timeout=60) == [i * 3 for i in range(25)]
    rt.controller.kv_put("mykey", {"a": 1})
    rt._ha.wal.sync()
    rt.snapshot_now()           # frontier captured under controller lock
    live_kv = dict(rt.controller._kv)
    live_refs = rt.controller.ref_tables()[0]
    live_live = rt.controller.live_task_ids()

    ha2 = HeadPersistence(snap, snap + ".wal")
    c2 = Controller()
    state = c2.restore_state(ha2.load_snapshot())
    ha2.replay(c2, ha2.wal_tail(), int(state.get("_wal_seq", 0)), {}, {})
    ha2.close()
    assert c2._kv == live_kv
    assert c2.ref_tables()[0] == live_refs
    assert set(c2.live_task_ids()) == set(live_live) == set()
    assert c2.kv_get("mykey") == {"a": 1}


def test_snapshot_torn_write_falls_back_to_previous_good(tmp_path):
    snap = str(tmp_path / "s.snap")
    ha = HeadPersistence(snap, snap + ".wal")
    ha.write_snapshot(b"blob-one")
    ha.write_snapshot(b"blob-two")          # rotates one -> .prev
    assert ha.load_snapshot() == b"blob-two"
    # corrupt the current blob (torn write): restore must fall back to
    # the previous good snapshot, NOT start with empty tables
    data = open(snap, "rb").read()
    open(snap, "wb").write(data[: len(data) // 2])
    ha2 = HeadPersistence(snap, snap + ".wal2")
    assert ha2.load_snapshot() == b"blob-one"
    assert ha2.recovered["snapshot_fallback"] is True
    ha.close()
    ha2.close()
    # framing self-check: bit flips fail the checksum loudly
    framed = bytearray(frame_snapshot(b"payload"))
    assert unframe_snapshot(bytes(framed)) == b"payload"
    framed[-1] ^= 0xFF
    with pytest.raises(ValueError):
        unframe_snapshot(bytes(framed))
    # pre-r15 unframed blobs pass through (upgrade path)
    assert unframe_snapshot(b"legacy-pickle") == b"legacy-pickle"


def test_compaction_rotates_snapshots_and_truncates(tmp_path):
    snap = str(tmp_path / "c.snap")
    ha = HeadPersistence(snap, snap + ".wal", compact_bytes=1,
                         compact_interval_s=0.0)
    ha.activate()
    c = Controller()
    c.ha = ha
    for i in range(20):
        c.kv_put(f"k{i}", i)
    ha.wal.sync()
    snapshots = []
    ok = ha.wal.compact(lambda: (
        snapshots.append(1),
        ha.write_snapshot(c.snapshot_state())))
    assert ok and snapshots
    assert not os.path.exists(snap + ".wal.old")   # old segment deleted
    c.kv_put("post", "compact")                    # lands in new segment
    ha.wal.sync()
    # recovery: snapshot covers the pre-compaction writes, the fresh
    # segment carries the rest; frontier skip keeps replay exact
    ha2 = HeadPersistence(snap, snap + ".wal")
    c2 = Controller()
    state = c2.restore_state(ha2.load_snapshot())
    ha2.replay(c2, ha2.wal_tail(), int(state.get("_wal_seq", 0)), {}, {})
    assert c2.kv_get("post") == "compact"
    assert all(c2.kv_get(f"k{i}") == i for i in range(20))
    # crash-mid-compaction shape: a rotated-but-undeleted segment is
    # replayed too (in seq order, before the active one)
    os.rename(ha.wal.path, ha.wal.path + ".old")
    open(ha.wal.path, "wb").close()
    ha3 = HeadPersistence(snap, snap + ".wal")
    c3 = Controller()
    state = c3.restore_state(ha3.load_snapshot())
    ha3.replay(c3, ha3.wal_tail(), int(state.get("_wal_seq", 0)), {}, {})
    assert c3.kv_get("post") == "compact"
    ha.close()
    ha2.close()
    ha3.close()


def test_wal_seq_seeds_past_recovered_state(tmp_path):
    """Review regression: a restarted head appends to the SAME segment
    the old process wrote — the sequence counter must seed past both
    the recovered tail and the snapshot frontier, or new records sort
    below old ones (stale clobber) / below the frontier (skipped) on
    a second crash."""
    snap = str(tmp_path / "s.snap")
    wal = WriteAheadLog(str(tmp_path / "seed.wal"), fsync_ms=0.0)
    for i in range(5):
        wal.append("kv", ("ns", f"k{i}", "old"))
    wal.sync()
    wal.close()
    ha2 = HeadPersistence(snap, wal.path)
    tail = ha2.wal_tail()
    old_max = max(r[0] for r in tail)
    ha2.wal.advance_seq(max(7, old_max))    # frontier may exceed tail
    ha2.activate()
    seq = ha2.wal.append("kv", ("ns", "k0", "new"))
    assert seq > old_max and seq > 7
    ha2.wal.sync()
    # a second recovery replays old-then-new by seq: "new" wins
    recs = sorted(read_wal(wal.path), key=lambda r: r[0])
    c = Controller()
    HeadPersistence(snap, wal.path + "2").replay(c, recs, 0, {}, {})
    assert c.kv_get("k0", "ns") == "new"
    ha2.close()


def test_compaction_keeps_retained_segment_until_snapshotted(tmp_path):
    """Review regression: when a compaction's snapshot fails, the
    rotated segment is retained — the NEXT compaction must not rotate
    over it (destroying the only copy of its records); it snapshots
    first, then clears it."""
    snap = str(tmp_path / "k.snap")
    ha = HeadPersistence(snap, snap + ".wal", compact_bytes=1,
                         compact_interval_s=0.0)
    ha.activate()
    c = Controller()
    c.ha = ha
    c.kv_put("k", "v1")
    ha.wal.sync()
    assert not ha.wal.compact(lambda: (_ for _ in ()).throw(
        OSError("disk full")))
    assert os.path.exists(ha.wal.path + ".old")   # retained
    c.kv_put("k2", "v2")                          # new segment records
    ha.wal.sync()

    def good_snapshot():
        ha.write_snapshot(c.snapshot_state())

    assert ha.wal.compact(good_snapshot)
    assert not os.path.exists(ha.wal.path + ".old")
    # everything — including the once-orphaned segment's records —
    # survives recovery
    ha2 = HeadPersistence(snap, ha.wal.path)
    c2 = Controller()
    state = c2.restore_state(ha2.load_snapshot())
    ha2.replay(c2, ha2.wal_tail(), int(state.get("_wal_seq", 0)), {}, {})
    assert c2.kv_get("k") == "v1" and c2.kv_get("k2") == "v2"
    ha.close()
    ha2.close()


# --------------------------------------- completion replay + reconcile
def _fake_remote_node(rt, node_id="node_hatest"):
    """A RemoteNodeHandle over a real socketpair (no agent process):
    enough to drive the head-side mirror/dedup paths."""
    from ray_tpu_torch._private.cluster import NodeRecord
    from ray_tpu_torch._private.remote_node import RemoteNodeHandle
    lst = socket.socket()
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    peer = protocol.connect(lst.getsockname(), lambda c, m: None,
                            name="fake-agent")
    a, _ = lst.accept()
    lst.close()
    conn = protocol.Connection(a, lambda c, m: None, name="head-side",
                               server=True)
    conn.start()
    ha = rt._ha
    proxy = RemoteNodeHandle(node_id, conn, {"CPU": 4.0},
                             ("127.0.0.1", 0),
                             wal_log=ha.log if ha else None)
    rec = NodeRecord(node_id=node_id, scheduler=proxy, is_head=False)
    with rt.cluster._lock:
        rt.cluster._nodes[node_id] = rec
    rt.controller.register_node(node_id, {"CPU": 4.0})
    return rec, proxy, (conn, peer)


def _done_entry(tid: str) -> dict:
    return {"task_id": tid, "worker_id": "w_x", "inline": [],
            "located": [], "name": "t_" + tid}


def test_completion_batch_replay_dedups_against_mirror(ha_runtime):
    """A rejoining agent re-ships its sent-completion tail; entries the
    pre-crash head already processed pop an empty mirror and are
    SKIPPED — no task is counted twice, none lost."""
    rt, _ = ha_runtime
    rec, proxy, conns = _fake_remote_node(rt)
    tids = ["%016x" % i for i in range(4)]
    for tid in tids:
        spec = _spec(tid)
        rt.controller.task_submitted(spec)
        proxy.enqueue(spec)
    batch = {"type": protocol.NODE_TASK_DONE_BATCH,
             "node_id": rec.node_id,
             "done": [_done_entry(t) for t in tids]}
    rt._on_node_task_done_batch(None, dict(batch))
    assert rt.controller.live_task_ids() == []
    # the replay: same entries again, flagged — every one must dedup
    rt._on_node_task_done_batch(None, dict(batch, replayed=True))
    st = rt.state_op("head_ha_stats")
    assert st["recovered"]["deduped_completions"] == len(tids)
    assert st["recovered"]["replayed_completions"] == 0
    events = [e for e in rt.controller.list_task_events(10_000)
              if e["state"] == "FINISHED" and e["task_id"] in tids]
    assert len(events) == len(tids)        # exactly once each
    # a replayed entry the head NEVER processed applies normally
    tid5 = "%016x" % 99
    spec5 = _spec(tid5)
    rt.controller.task_submitted(spec5)
    proxy.enqueue(spec5)
    rt._on_node_task_done_batch(None, {
        "type": protocol.NODE_TASK_DONE_BATCH, "node_id": rec.node_id,
        "done": [_done_entry(tid5)], "replayed": True})
    st = rt.state_op("head_ha_stats")
    assert st["recovered"]["replayed_completions"] == 1
    assert rt.controller.live_task_ids() == []
    for c in conns:
        c.close()


def test_lease_ledger_resync_replaces_only_lost_tasks(ha_runtime):
    """Post-rejoin reconcile: restored mirror entries absent from the
    agent's in-flight report re-place exactly once; entries the agent
    still drains stay mirrored; completed-during-drain entries drop."""
    rt, _ = ha_runtime
    rec, proxy, conns = _fake_remote_node(rt)
    t_kept, t_lost, t_done = ("%016x" % i for i in (1, 2, 3))
    specs = {t: _spec(t) for t in (t_kept, t_lost, t_done)}
    for t in (t_kept, t_lost):
        rt.controller.task_submitted(specs[t])
    rt._ha.park_node(rec.node_id,
                     {t: (specs[t], False)
                      for t in (t_kept, t_lost, t_done)},
                     {t_kept, t_lost, t_done})
    submitted = []
    orig_submit = rt.cluster.submit
    rt.cluster.submit = lambda s: submitted.append(s)
    try:
        rt._process_rejoin(rec, {"rejoin": True,
                                 "inflight_tasks": [t_kept],
                                 "live_actors": {}, "objects": []})
        assert t_kept in proxy._work and t_lost in proxy._work
        rt._reconcile_node_mirror(rec.node_id)   # the drained marker
    finally:
        rt.cluster.submit = orig_submit
    assert [s.task_id for s in submitted] == [t_lost]
    assert t_kept in proxy._work          # agent still owes it
    assert t_lost not in proxy._work      # re-placed
    assert t_done not in proxy._work      # completed: dropped silently
    # a second marker (duplicate event) reconciles nothing new
    rt._reconcile_node_mirror(rec.node_id)
    for c in conns:
        c.close()


# -------------------------------------------- in-process restart e2e
@pytest.mark.slow    # ~6s (r17 tier-1 budget): its tier-1 sibling
                     # test_head_restart_in_process_completes_under_
                     # original_ids covers the restart+resubmit path
                     # end-to-end (and further asserts completion)
def test_head_restart_in_process_resubmits_unfinished(tmp_path):
    """Sibling of the SIGKILL chaos gate: a head shut down with
    tasks still queued (its workers die with it) rehydrates from
    snapshot+WAL on restart and re-places every unfinished task — the
    results land under the ORIGINAL return ids."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    snap = str(tmp_path / "head.snap")
    os.environ["RAY_TPU_HEAD_SNAPSHOT_PATH"] = snap
    CONFIG.reload()
    try:
        rt = ray_tpu_torch.init(num_cpus=1)

        @ray_tpu_torch.remote
        def slow(x):
            import time as _t
            _t.sleep(60)
            return x + 7

        refs = [slow.remote(i) for i in range(3)]
        oids = [r.object_id for r in refs]
        _wait(lambda: rt._ha.wal.stats()["records"] > 0)
        rt._ha.wal.sync()
        ray_tpu_torch.shutdown()      # workers die mid-sleep; tasks unfinished

        rt2 = ray_tpu_torch.init(num_cpus=2)
        st = rt2.state_op("head_ha_stats")
        assert st["recovered"]["resubmitted"] == 3
        assert sorted(rt2.controller.live_task_ids()) == sorted(
            o.split("r", 1)[0] for o in oids)
        # the resubmitted specs re-run the ORIGINAL (60 s) function;
        # don't wait for them — just prove they are back in flight
        def _in_flight():
            s = rt2.state_op("summarize_tasks")
            return (s.get("RUNNING", 0) + s.get("PENDING", 0)
                    + s.get("RESUBMITTED", 0)) > 0
        assert _wait(_in_flight, timeout=30)
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_HEAD_SNAPSHOT_PATH", None)
        CONFIG.reload()


def test_head_restart_in_process_completes_under_original_ids(tmp_path):
    """Same shape with fast tasks: restart, resubmit, and the ORIGINAL
    ObjectRefs resolve on the restarted head."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    snap = str(tmp_path / "head.snap")
    os.environ["RAY_TPU_HEAD_SNAPSHOT_PATH"] = snap
    CONFIG.reload()
    try:
        rt = ray_tpu_torch.init(num_cpus=1, max_workers=1)

        @ray_tpu_torch.remote
        def add(x):
            return x + 7

        # one warm task proves the pool; then queue work and kill the
        # head before the backlog can finish
        assert ray_tpu_torch.get(add.remote(1), timeout=60) == 8

        @ray_tpu_torch.remote
        def gate(x):
            import time as _t
            _t.sleep(0.4)
            return x + 7

        refs = [gate.remote(i) for i in range(6)]
        oids = [r.object_id for r in refs]
        rt._ha.wal.sync()
        ray_tpu_torch.shutdown()

        rt2 = ray_tpu_torch.init(num_cpus=2)
        from ray_tpu_torch._private.refs import ObjectRef
        # re-adopt the old driver's handles (the restored refcounts
        # keep them alive); every value arrives exactly as computed
        out = ray_tpu_torch.get([ObjectRef(o) for o in oids], timeout=120)
        assert sorted(out) == [i + 7 for i in range(6)]
        st = rt2.state_op("head_ha_stats")
        assert st["recovered"]["live_tasks"] >= 1
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_HEAD_SNAPSHOT_PATH", None)
        CONFIG.reload()


# ------------------------------------------------- chaos gates (slow)
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow     # ~35s multi-process e2e; tier-1 siblings: the
                      # in-process restart pair + dedup/resync units
def test_chaos_head_sigkill_mid_delegated_drain_exactly_once(tmp_path):
    """THE r15 chaos gate: SIGKILL the head while a delegated agent
    drains 5k leased tasks; the agent keeps draining through the
    outage, replays its completion tail on rejoin, and the restarted
    head (snapshot + WAL) accounts every task exactly once — each task
    EXECUTES exactly once (agent-side append log), zero lost, zero
    duplicated."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    N = 5000
    port = _free_port()
    snap = tmp_path / "head.snap"
    execlog = tmp_path / "exec.log"
    ready = tmp_path / "ready"
    out = tmp_path / "out"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               RAY_TPU_HEAD_SNAPSHOT_PATH=str(snap))
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__))) + os.pathsep
        + env.get("PYTHONPATH", ""))
    head_a = textwrap.dedent(f"""
        import time, ray_tpu_torch
        rt = ray_tpu_torch.init(num_cpus=0, port={port})
        deadline = time.monotonic() + 60
        while (len(rt.cluster.alive_nodes()) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)

        @ray_tpu_torch.remote(resources={{"agent": 0.01}})
        def work(i):
            import os, time
            time.sleep(0.002)
            fd = os.open({str(execlog)!r},
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND)
            os.write(fd, (str(i) + "\\n").encode())
            os.close(fd)
            return i

        refs = [work.remote(i) for i in range({N})]
        open({str(ready)!r}, "w").write("ok")
        time.sleep(600)
    """)
    head_b = textwrap.dedent(f"""
        import collections, time, ray_tpu_torch
        rt = ray_tpu_torch.init(num_cpus=0, port={port})
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if (not rt.controller.live_task_ids()
                    and not rt._ha.pending_nodes
                    and len(rt.cluster.alive_nodes()) >= 2):
                break
            time.sleep(0.1)
        st = rt.state_op("head_ha_stats")
        c = collections.Counter(
            int(x) for x in open({str(execlog)!r}).read().split())
        dup = {{k: v for k, v in c.items() if v > 1}}
        missing = [i for i in range({N}) if i not in c]
        with open({str(out)!r}, "w") as f:
            f.write(repr(dict(dup=dup, nmissing=len(missing),
                              live=len(rt.controller.live_task_ids()),
                              recovered=st["recovered"])))
        ray_tpu_torch.shutdown()
    """)
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    pa = pb = agent = None
    try:
        pa = subprocess.Popen([sys.executable, "-c", head_a], env=env)
        deadline = time.time() + 30
        while agent is None and time.time() < deadline:
            try:
                agent = NodeAgentProcess(
                    head_address=("127.0.0.1", port), num_cpus=4,
                    resources={"agent": 100.0})
            except Exception:
                time.sleep(0.3)
        assert agent is not None
        assert _wait(lambda: ready.exists(), timeout=90)
        # kill mid-drain: some executed, most still leased/queued
        assert _wait(lambda: execlog.exists()
                     and len(execlog.read_bytes().split()) > 200,
                     timeout=90)
        os.kill(pa.pid, signal.SIGKILL)
        pa.wait(timeout=10)
        pb = subprocess.Popen([sys.executable, "-c", head_b], env=env)
        assert pb.wait(timeout=180) == 0
        res = eval(out.read_text())
        assert res["dup"] == {}, f"tasks executed twice: {res['dup']}"
        assert res["nmissing"] == 0, res
        assert res["live"] == 0
        rec = res["recovered"]
        assert rec["replayed_completions"] + rec["deduped_completions"] \
            > 0
    finally:
        for p in (pa, pb):
            if p is not None and p.poll() is None:
                p.kill()
        if agent is not None:
            agent.terminate()
            agent.wait(10)


@pytest.mark.slow     # ~60s multi-process elastic e2e
def test_chaos_head_sigkill_mid_fit_elastic_curve_parity(tmp_path):
    """Head SIGKILLed mid-elastic-fit(): the restarted driver's fit
    auto-resumes from the recovered CheckpointManager (no explicit
    resume argument), replayed steps dedup via the persisted step
    seed, NO reshape happens, and the concatenated (step, loss) curve
    equals an uninterrupted run's."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               RAY_TPU_HEAD_SNAPSHOT_PATH=str(tmp_path / "head.snap"))
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__))) + os.pathsep
        + env.get("PYTHONPATH", ""))
    storage = tmp_path / "results"
    steps_log = tmp_path / "steps.log"
    out = tmp_path / "out"

    loop_src = textwrap.dedent(f"""
        def loop(config):
            import os
            from ray_tpu_torch import train
            from ray_tpu_torch.train import Checkpoint
            ckpt = train.get_checkpoint()
            start = 0
            if ckpt is not None:
                with open(os.path.join(ckpt.as_directory(),
                                       "step.txt")) as f:
                    start = int(f.read()) + 1
            for step in range(start, 8):
                import time as _t
                _t.sleep(0.3)
                loss = 100.0 - step * 3.5          # deterministic curve
                # worker-side curve log (the pre-crash driver's history
                # dies with it; re-executed checkpoint->crash steps are
                # EXPECTED — the assertion dedups and compares values)
                fd = os.open({str(steps_log)!r},
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND)
                os.write(fd, (f"{{step}} {{loss}}\\n").encode())
                os.close(fd)
                c = None
                if step % 2 == 1:
                    import tempfile
                    d = tempfile.mkdtemp()
                    with open(os.path.join(d, "step.txt"), "w") as f:
                        f.write(str(step))
                    c = Checkpoint.from_directory(d)
                train.report({{"step": step, "loss": loss}}, checkpoint=c)
    """)
    driver_tpl = textwrap.dedent(f"""
        import json, time, ray_tpu_torch
        from ray_tpu_torch.train import (ElasticConfig, RunConfig, TorchTrainer,
                                   ScalingConfig)
        rt = ray_tpu_torch.init(num_cpus=2, port={port})
        deadline = time.monotonic() + 60
        while (len(rt.cluster.alive_nodes()) < 2
               and time.monotonic() < deadline):
            time.sleep(0.1)
    """) + loop_src + textwrap.dedent(f"""
        trainer = TorchTrainer(
            loop,
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=False,
                resources_per_worker={{"CPU": 1.0, "trainhost": 1.0}},
                elastic=ElasticConfig(min_workers=2, max_workers=2,
                                      checkpoint_every_n_steps=2)),
            run_config=RunConfig(name="harun",
                                 storage_path={str(storage)!r}))
        result = trainer.fit()
        hist = [int(m["step"]) for m in result.metrics_history]
        with open({str(out)!r}, "w") as f:
            f.write(repr(dict(
                reshapes=result.artifacts["elastic"]["reshapes"],
                last=result.metrics.get("step"), hist=hist)))
        ray_tpu_torch.shutdown()
    """)
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    pa = pb = agent = None
    try:
        pa = subprocess.Popen([sys.executable, "-c", driver_tpl],
                              env=env)
        deadline = time.time() + 30
        while agent is None and time.time() < deadline:
            try:
                agent = NodeAgentProcess(
                    head_address=("127.0.0.1", port), num_cpus=8,
                    max_workers=8, resources={"trainhost": 8.0})
            except Exception:
                time.sleep(0.3)
        assert agent is not None
        # kill once a mid-run checkpoint exists (step >= 3 reported)
        ckroot = storage / "harun" / "checkpoints"
        assert _wait(lambda: ckroot.exists()
                     and any(p.name.startswith("checkpoint_")
                             for p in ckroot.iterdir()), timeout=120)
        time.sleep(1.0)          # let a post-checkpoint step land
        os.kill(pa.pid, signal.SIGKILL)
        pa.wait(timeout=10)
        pb = subprocess.Popen([sys.executable, "-c", driver_tpl],
                              env=env)
        assert pb.wait(timeout=240) == 0
        res = eval(out.read_text())
        assert res["reshapes"] == 0, res    # rode through, no reshape
        assert res["last"] == 7
        # the resumed run's history holds each step at most once (the
        # persisted-step seed dedups checkpoint-replay re-reports) and
        # only fresh ground (no step the pre-crash run checkpointed)
        assert len(res["hist"]) == len(set(res["hist"])), res
        assert res["hist"] == sorted(res["hist"]), res
        assert res["hist"][-1] == 7
        # union of every executed step == the uninterrupted curve:
        # all 8 steps present, every reported loss exactly the
        # deterministic value (re-executed checkpoint->crash steps are
        # recomputed, not diverged)
        merged: dict = {}
        for ln in steps_log.read_text().splitlines():
            s, l = ln.split()
            merged.setdefault(int(s), set()).add(float(l))
        assert set(merged) == set(range(8)), sorted(merged)
        expected = {s: {100.0 - s * 3.5} for s in range(8)}
        assert merged == expected
    finally:
        for p in (pa, pb):
            if p is not None and p.poll() is None:
                p.kill()
        if agent is not None:
            agent.terminate()
            agent.wait(10)
