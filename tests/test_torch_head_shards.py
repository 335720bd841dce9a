"""r16 striped head tables + batched decref deltas.

Done-criteria mirrored from r16:
- striped ref/pin table keeps NO resident entry at zero/zero (the old
  defaultdict leak), applies batched deltas per shard, and reverts to
  one stripe with RAY_TPU_HEAD_SHARDS=0
- snapshot round-trip: a controller rebuilt from snapshot_state (and
  snapshot + WAL tail) matches the live striped tables exactly
- replayed decref deltas dedup by the per-node seq watermark — none
  counted twice, none lost — including across a snapshot/restore
- a real agent's decref storm lands as coalesced NODE_DECREF_DELTA
  frames and the released objects actually delete

The port's twin of `tests/test_head_shards.py`, case for case.
"""
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import striped
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.controller import Controller
from ray_tpu_torch._private.head_ha import HeadPersistence, read_wal


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture
def fresh_config():
    yield
    for k in ("RAY_TPU_HEAD_SHARDS", "RAY_TPU_HEAD_LINEAGE_MAX",
              "RAY_TPU_DECREF_DELTA"):
        os.environ.pop(k, None)
    CONFIG.reload()


# ------------------------------------------------------ striped units
def test_ref_table_evicts_zero_entries():
    t = striped.RefTable(n=4)
    t.addref("a", 2)
    t.pin("a")
    assert t.refcount("a") == 2 and not t.unreferenced("a")
    assert t.decref("a") is False
    assert t.decref("a") is False          # refs 0, still pinned
    assert t.unpin("a") is True            # now deletable
    # the entry is GONE, not a resident zero (the defaultdict leak)
    assert len(t) == 0
    # probing untracked ids keeps the legacy contract without
    # creating entries
    assert t.unreferenced("ghost") and t.decref("ghost") is True
    assert len(t) == 0


def test_ref_table_apply_deltas_per_shard():
    t = striped.RefTable(n=4)
    for i in range(20):
        t.addref(f"o{i}", 3)
    dead = t.apply_deltas({f"o{i}": 3 for i in range(10)})
    assert sorted(dead) == [f"o{i}" for i in range(10)]
    assert len(t) == 10
    assert t.apply_deltas({"o15": 1}) == []
    assert t.refcount("o15") == 2


def test_striped_map_bound_evicts_fifo():
    m = striped.StripedMap(n=1, max_entries=5)
    for i in range(9):
        m.put(f"k{i}", i)
    assert len(m) == 5
    assert m.evicted == 4
    assert m.get("k0") is None and m.get("k8") == 8


def test_shard_count_knob_reverts(fresh_config):
    os.environ["RAY_TPU_HEAD_SHARDS"] = "0"
    CONFIG.reload()
    assert striped.stripe_count() == 1
    os.environ["RAY_TPU_HEAD_SHARDS"] = "6"
    CONFIG.reload()
    assert striped.stripe_count() == 8     # next power of two
    c = Controller()
    c.addref("x", 2)
    assert c.ref_tables()[0] == {"x": 2}


# ------------------------------------- snapshot / WAL round-trip (HA)
def _populate(c: Controller) -> None:
    from ray_tpu_torch._private.specs import TaskSpec
    for i in range(40):
        c.addref(f"obj{i}", (i % 3) + 1)
    c.pin("obj1")
    c.pin("obj1")
    spec = TaskSpec(task_id="aa" * 8, func_id="f" * 16, args=(),
                    kwargs={}, return_ids=["aa" * 8 + "r0"])
    c.task_submitted(spec)
    c.add_location("obj5", "node_x", 128)
    c.add_location("obj5", "node_y", 128)
    c.add_location("obj7", "node_x", 64)
    c.kv_put("k", {"v": 1})
    assert c.apply_decref_delta("node_x", 3, {"obj0": 1}) is not None


def _tables(c: Controller) -> tuple:
    refs, pins = c.ref_tables()
    return (refs, pins, sorted(c.live_task_ids()),
            sorted(c.locations("obj5")), c.locations("obj7"),
            c.kv_get("k"), dict(c._decref_seqs))


def test_sharded_snapshot_round_trip_equivalence(fresh_config):
    os.environ["RAY_TPU_HEAD_SHARDS"] = "8"
    CONFIG.reload()
    c = Controller()
    _populate(c)
    blob = c.snapshot_state()
    # restore into a DIFFERENT stripe topology: the blob is the merged
    # one-dict shape, so shard count is a free parameter across
    # restarts
    os.environ["RAY_TPU_HEAD_SHARDS"] = "2"
    CONFIG.reload()
    c2 = Controller()
    c2.restore_state(blob)
    assert _tables(c) == _tables(c2)
    # lineage survives (keyed by return oid)
    assert c2.lineage_for("aa" * 8 + "r0").task_id == "aa" * 8


def test_sharded_snapshot_plus_wal_tail_round_trip(tmp_path):
    snap = str(tmp_path / "s.snap")
    ha = HeadPersistence(snap, snap + ".wal", fsync_ms=0.0)
    ha.activate()
    c = Controller()
    c.ha = ha
    _populate(c)
    ha.write_snapshot(c.snapshot_state())
    # post-snapshot traffic lands only in the WAL tail
    c.addref("tail_obj", 5)
    c.record_task_event("aa" * 8, "t", "FINISHED")
    assert c.apply_decref_delta("node_x", 4, {"obj2": 1}) is not None
    ha.wal.sync()
    live = _tables(c)
    live_tail = c.ref_tables()[0].get("tail_obj")

    c2 = Controller()
    ha2 = HeadPersistence(snap, snap + ".wal")
    state = c2.restore_state(ha2.load_snapshot())
    assert int(state.get("_wal_seq", 0)) > 0
    ha2.replay(c2, ha2.wal_tail(), int(state["_wal_seq"]), {}, {})
    assert c2.ref_tables()[0].get("tail_obj") == live_tail == 5
    assert c2.live_task_ids() == []        # terminal pop replayed
    assert _tables(c2) == live
    # replaying the tail AGAIN converges (set semantics, shard-aware)
    ha2.replay(c2, ha2.wal_tail(), int(state["_wal_seq"]), {}, {})
    assert _tables(c2) == live
    ha2.close()
    ha.close()


# --------------------------------------- decref-delta dedup (replay)
def test_decref_delta_replay_dedup_none_twice_none_lost(tmp_path):
    snap = str(tmp_path / "d.snap")
    ha = HeadPersistence(snap, snap + ".wal", fsync_ms=0.0)
    ha.activate()
    c = Controller()
    c.ha = ha
    c.addref("a", 4)
    c.addref("b", 2)
    assert c.apply_decref_delta("n1", 1, {"a": 1}) == []
    assert c.apply_decref_delta("n1", 2, {"a": 1, "b": 2}) == ["b"]
    # replayed frames (rejoin): at-or-below the watermark -> None,
    # counts NOT applied twice
    assert c.apply_decref_delta("n1", 1, {"a": 1}) is None
    assert c.apply_decref_delta("n1", 2, {"a": 1, "b": 2}) is None
    assert c.ref_tables()[0] == {"a": 2}
    # a fresh frame still applies (none lost)
    assert c.apply_decref_delta("n1", 3, {"a": 1}) == []
    assert c.ref_tables()[0] == {"a": 1}
    ha.wal.sync()

    # the watermark survives recovery: a restarted head still dedups
    # the same replayed frames (snapshot-free path: WAL only)
    c2 = Controller()
    ha2 = HeadPersistence(snap, snap + ".wal")
    ha2.replay(c2, ha2.wal_tail(), 0, {}, {})
    assert c2._decref_seqs == {"n1": 3}
    assert c2.ref_tables()[0] == {"a": 1}
    assert c2.apply_decref_delta("n1", 3, {"a": 1}) is None
    assert c2.apply_decref_delta("n1", 4, {"a": 1}) == ["a"]
    # a FRESH (non-rejoin) agent under the same node id resets
    c2.reset_decref_seq("n1")
    c2.addref("c", 1)
    assert c2.apply_decref_delta("n1", 1, {"c": 1}) == ["c"]
    ha2.close()
    ha.close()


def test_dref_seq_wal_records_written(tmp_path):
    snap = str(tmp_path / "w.snap")
    ha = HeadPersistence(snap, snap + ".wal", fsync_ms=0.0)
    ha.activate()
    c = Controller()
    c.ha = ha
    c.addref("a", 2)
    c.apply_decref_delta("nX", 7, {"a": 1})
    ha.wal.sync()
    ha.close()
    recs = [r for r in read_wal(snap + ".wal") if r[1] == "dref_seq"]
    assert recs and recs[-1][2] == ("nX", 7)


# ------------------------------------------------- agent e2e (real)
def test_agent_decref_storm_rides_delta_frames():
    """A worker on a real agent borrows refs and drops them: the
    releases must reach the head as coalesced NODE_DECREF_DELTA
    frames (not per-connection DECREF_BATCH forwards) and the objects
    must actually delete."""
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    # a shared runtime an earlier test left up made this init raise
    # "init() called twice" now and then in the JAX file (its conftest's
    # `ray_cluster` keeps one up until the session ends): shut it first
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=0)
    agent = None
    try:
        agent = NodeAgentProcess(num_cpus=2)
        deadline = time.time() + 30
        while (time.time() < deadline
               and len(rt.cluster.alive_nodes()) < 2):
            time.sleep(0.1)

        @ray_tpu_torch.remote
        def consume(refs):
            return sum(ray_tpu_torch.get(r) for r in refs)

        vals = [ray_tpu_torch.put(i) for i in range(8)]
        # several rounds so deferred worker-side decrefs (borrow
        # releases) actually flow while the session is alive
        for _ in range(3):
            assert ray_tpu_torch.get(consume.remote(list(vals)),
                               timeout=60) == sum(range(8))
        deadline = time.time() + 20
        st = {}
        while time.time() < deadline:
            st = rt.state_op("head_shard_stats")["decref_delta"]
            if st.get("frames", 0) > 0:
                break
            time.sleep(0.2)
        assert st.get("frames", 0) > 0, st
        assert st.get("entries", 0) > 0, st
        # release the driver's own refs: objects fully delete
        oids = [v.object_id for v in vals]
        del vals
        deadline = time.time() + 20
        while time.time() < deadline:
            if all(rt.controller.unreferenced(o) for o in oids):
                break
            time.sleep(0.2)
        assert all(rt.controller.unreferenced(o) for o in oids)
    finally:
        if agent is not None:
            agent.terminate()
            agent.wait(10)
        ray_tpu_torch.shutdown()
