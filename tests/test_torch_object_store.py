"""Object store: serialization, shm, capacity/LRU spill-to-disk.

Parity target: reference plasma eviction_policy.cc (LRU) +
raylet/local_object_manager.cc (spill/restore), exercised directly on
LocalStore.

The port's twin of `tests/test_object_store.py`, case for case.
"""
import ray_tpu_torch
import os

import numpy as np
import pytest

from ray_tpu_torch._private.object_store import (LocalStore, deserialize,
                                           serialize)


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


MB = 1024 * 1024


def _big(i, mb=1):
    return np.full(mb * MB // 8, float(i))


def test_serialize_roundtrip_shm_and_inline():
    v = {"small": np.arange(10), "big": _big(7)}
    obj = serialize(v)
    assert obj.shm_names            # big buffer went to shm
    back = deserialize(obj)
    np.testing.assert_array_equal(back["big"], v["big"])
    np.testing.assert_array_equal(back["small"], v["small"])
    for name in obj.shm_names:
        from ray_tpu_torch._private.object_store import unlink_segment
        unlink_segment(name)


def test_capacity_spills_lru_and_restores(tmp_path):
    store = LocalStore(capacity_bytes=int(2.5 * MB),
                       spill_dir=str(tmp_path / "spill"))
    ids = [store.put(_big(i)) for i in range(4)]   # 4 MB total
    stats = store.stats()
    assert stats["bytes"] <= 2.5 * MB
    assert stats["num_spilled"] >= 1
    assert stats["num_objects"] == 4               # nothing lost
    # oldest objects were chosen (LRU = insertion order here)
    spilled_files = os.listdir(tmp_path / "spill")
    assert ids[0] in spilled_files
    # restore transparently, value intact
    got = deserialize(store.get_stored(ids[0], timeout=0))
    np.testing.assert_array_equal(got, _big(0))
    store.shutdown()


def test_lru_touch_changes_spill_victim(tmp_path):
    store = LocalStore(capacity_bytes=int(2.5 * MB),
                       spill_dir=str(tmp_path / "s"))
    a = store.put(_big(1))
    b = store.put(_big(2))
    store.get_stored(a, timeout=0)        # touch a: b becomes LRU
    c = store.put(_big(3))
    assert b in store._spilled
    assert a not in store._spilled
    store.shutdown()


def test_pinned_objects_never_spill(tmp_path):
    pinned = set()
    store = LocalStore(capacity_bytes=int(1.5 * MB),
                       spill_dir=str(tmp_path / "s"),
                       pinned_fn=lambda: pinned)
    a = store.put(_big(1))
    pinned.add(a)
    b = store.put(_big(2))
    c = store.put(_big(3))
    assert a not in store._spilled        # pinned survived the pressure
    assert a in store._objects
    store.shutdown()


def test_delete_spilled_removes_file(tmp_path):
    store = LocalStore(capacity_bytes=MB, spill_dir=str(tmp_path / "s"))
    a = store.put(_big(1))
    b = store.put(_big(2))               # a spills
    assert a in store._spilled
    path = store._spilled[a].path
    assert os.path.exists(path)
    store.delete(a)
    assert not os.path.exists(path)
    assert not store.contains(a)
    store.shutdown()


def test_unbounded_store_never_spills(tmp_path):
    store = LocalStore(spill_dir=str(tmp_path / "s"))
    for i in range(5):
        store.put(_big(i))
    assert store.stats()["num_spilled"] == 0
    store.shutdown()


# ---------------------------------------------- segment pool (r6)
@pytest.fixture
def seg_pool():
    """Fresh, enabled pool state around each pool test."""
    from ray_tpu_torch._private.object_store import SEGMENT_POOL
    SEGMENT_POOL.clear()
    r0, p0 = SEGMENT_POOL.reused, SEGMENT_POOL.pooled
    yield SEGMENT_POOL
    SEGMENT_POOL.clear()


def test_segment_pool_reuse_roundtrip(seg_pool):
    """A freed segment is renamed into the pool and the next put of a
    compatible size reuses it — contents must be the NEW object's."""
    from ray_tpu_torch._private.object_store import free_segment, serialize
    a = serialize(_big(1))
    assert a.shm_names
    reused0 = seg_pool.reused
    free_segment(a.shm_names[0])
    assert seg_pool.stats()["pool_segments"] == 1
    assert not os.path.exists("/dev/shm/" + a.shm_names[0])  # renamed
    b = serialize(_big(2))
    assert seg_pool.reused == reused0 + 1
    np.testing.assert_array_equal(deserialize(b), _big(2))
    from ray_tpu_torch._private.object_store import unlink_segment
    for n in b.shm_names:
        unlink_segment(n)


def test_segment_pool_class_mismatch_misses(seg_pool):
    """A pooled 1 MB-class segment must not serve an 8 MB put."""
    from ray_tpu_torch._private.object_store import free_segment, serialize
    a = serialize(_big(1, mb=1))
    free_segment(a.shm_names[0])
    reused0 = seg_pool.reused
    b = serialize(_big(2, mb=8))
    assert seg_pool.reused == reused0          # miss: fresh create
    np.testing.assert_array_equal(deserialize(b), _big(2, mb=8))
    from ray_tpu_torch._private.object_store import unlink_segment
    for n in b.shm_names:
        unlink_segment(n)


def test_segment_pool_overflow_falls_back_to_unlink(seg_pool):
    """Past the per-class cap the pool refuses and the segment is
    unlinked-by-name exactly as before."""
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.object_store import free_segment, serialize
    cap = CONFIG.shm_pool_per_class
    objs = [serialize(_big(i)) for i in range(cap + 2)]
    for o in objs:
        free_segment(o.shm_names[0])
    st = seg_pool.stats()
    assert st["pool_segments"] == cap
    # the overflow segments are GONE from /dev/shm (plain unlink)
    names = {n for o in objs for n in o.shm_names}
    assert not any(os.path.exists("/dev/shm/" + n) for n in names)


def test_segment_pool_shutdown_sweep(seg_pool, tmp_path):
    """Store shutdown reaps pooled segments; the tag-prefixed session
    sweep would catch them too (pool names carry the session tag)."""
    from ray_tpu_torch._private.object_store import _local_tag
    store = LocalStore(spill_dir=str(tmp_path / "s"))
    a = store.put(_big(1))
    store.delete(a)                    # feeds the pool
    assert seg_pool.stats()["pool_segments"] >= 1
    tag = _local_tag()
    pooled = [n for n in os.listdir("/dev/shm")
              if n.startswith(f"rtt_{tag}_pool")]
    assert pooled
    store.shutdown()
    assert seg_pool.stats()["pool_segments"] == 0
    for n in pooled:
        assert not os.path.exists("/dev/shm/" + n)


def test_segment_pool_disable_flag(seg_pool):
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.object_store import free_segment, serialize
    prev = os.environ.get("RAY_TPU_SHM_POOL")
    os.environ["RAY_TPU_SHM_POOL"] = "0"
    CONFIG.reload()
    try:
        a = serialize(_big(3))
        free_segment(a.shm_names[0])
        assert seg_pool.stats()["pool_segments"] == 0
        assert not os.path.exists("/dev/shm/" + a.shm_names[0])
    finally:
        if prev is None:
            os.environ.pop("RAY_TPU_SHM_POOL", None)
        else:
            os.environ["RAY_TPU_SHM_POOL"] = prev
        CONFIG.reload()


def test_mapped_view_pins_object_until_collected(seg_pool):
    """Pooled reuse overwrites segment pages, so a deserialized view
    must hold a borrow on its object: addref at map time, deferred
    decref once the last view is collected — the refcount can never
    hit zero (and pool the segment) under a live view."""
    import gc
    import time

    from ray_tpu_torch._private import context as _context
    from ray_tpu_torch._private.object_store import serialize, unlink_segment

    class _Ctx(_context.BaseContext):
        def __init__(self):
            self.addrefs, self.decrefs = [], []

        def addref(self, oid):
            self.addrefs.append(oid)

        def decref(self, oid):
            self.decrefs.append(oid)

    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()          # same pattern as test_refs parking
    assert _context.maybe_ctx() is None
    ctx = _Ctx()
    _context.set_ctx(ctx)
    try:
        a = serialize(_big(4))
        val = deserialize(a)
        assert ctx.addrefs == [a.object_id]
        assert not ctx.decrefs
        np.testing.assert_array_equal(val, _big(4))
        del val
        gc.collect()
        deadline = time.monotonic() + 10
        while (a.object_id not in ctx.decrefs
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert a.object_id in ctx.decrefs, \
            "map pin was not released after view collection"
    finally:
        _context.set_ctx(None)
        for n in a.shm_names:
            unlink_segment(n)


def test_guarded_segments_are_unlinked_not_pooled(seg_pool):
    """While a transient copier (pull serving) has a segment guarded,
    a concurrent free must take the mapping-safe unlink path instead
    of renaming the segment into the pool."""
    from ray_tpu_torch._private.object_store import (free_segment,
                                               guard_segments, serialize)
    a = serialize(_big(6))
    with guard_segments(a.shm_names):
        free_segment(a.shm_names[0])
        assert seg_pool.stats()["pool_segments"] == 0
        assert not os.path.exists("/dev/shm/" + a.shm_names[0])


def test_spill_keeps_unlink_semantics(seg_pool, tmp_path):
    """Spill victims usually have live refs (that is why they spill
    instead of dying), so readers may hold mapped views: the spill
    writer must unlink, never pool, their segments."""
    store = LocalStore(capacity_bytes=int(2.5 * MB),
                       spill_dir=str(tmp_path / "spill"))
    for i in range(4):
        store.put(_big(i))
    assert store.stats()["num_spilled"] >= 1
    assert seg_pool.stats()["pool_segments"] == 0
    store.shutdown()


def test_view_survives_ref_death_under_pooling(ray_cluster, seg_pool):
    """End to end: an array obtained from get() must stay intact after
    its ObjectRef dies and later large puts churn the segment pool —
    the exact corruption pooling could introduce without the map pin."""
    import gc
    import time

    import ray_tpu_torch
    src = np.arange(MB // 4, dtype=np.float64)        # 2 MB
    expected = src.copy()
    ref = ray_tpu_torch.put(src)
    arr = ray_tpu_torch.get(ref)
    del ref
    gc.collect()
    time.sleep(1.0)          # deferred decref flush + any (wrong) free
    for i in range(3):       # churn puts that would reuse a pooled seg
        ray_tpu_torch.get(ray_tpu_torch.put(np.full(MB // 4, float(i))))
    np.testing.assert_array_equal(arr, expected)


def test_serialize_containment_capture_is_reentrant():
    """Regression (ADVICE r5): a nested serialize() inside a user
    __reduce__ must not wipe the OUTER object's containment capture —
    refs pickled after the nested call still register as contained."""
    from ray_tpu_torch._private.object_store import serialize
    from ray_tpu_torch._private.refs import ObjectRef

    class NestedPut:
        def __reduce__(self):
            serialize({"inner": 1})          # reentrant serialize
            return (dict, ())

    ref = ObjectRef("feedbeef01234567890a", owned=False)
    outer = serialize([NestedPut(), ref])
    assert ref.object_id in outer.contained_ids


def test_reap_object_segments_cleans_orphans():
    """A worker killed between sealing result shm and delivering
    TASK_DONE leaves orphan segments named rtt_<return_id>_<i>; the
    driver reaps them when it records the task's failure."""
    import _posixshmem

    from ray_tpu_torch._private.object_store import (_create_segment,
                                               _local_tag,
                                               reap_object_segments)
    rid = "deadbeef01r0"
    tag = _local_tag()
    for i in range(3):
        _create_segment(f"rtt_{tag}_{rid}_{i}", memoryview(b"x" * 128))
    assert reap_object_segments(rid) == 3
    # gone — and reaping again is a no-op
    assert reap_object_segments(rid) == 0
    with pytest.raises(FileNotFoundError):
        _posixshmem.shm_open(f"/rtt_{tag}_{rid}_0", 0, mode=0o600)
