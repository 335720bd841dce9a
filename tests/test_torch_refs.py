"""Borrowed-reference protocol (reference reference_count.h:64,115-117
borrower registration + WaitForRefRemoved; reference_count.cc nested-ref
ownership for refs pickled inside other objects).

The r4 VERDICT's prescribed failing scenario: an actor stores a ref it
received inside an argument PAST the carrying task, the driver drops its
own handle, and the actor must still be able to get() the object.

The port's twin of `tests/test_refs.py`, case for case.
"""
import gc
import time

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture
def rt():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    yield rt
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Holder:
    def set(self, box):
        self.ref = box[0]          # borrow outlives the carrying task
        return True

    def read(self):
        return float(ray_tpu_torch.get(self.ref, timeout=15)[0])

    def drop(self):
        self.ref = None
        gc.collect()
        return True


def test_actor_stored_borrow_survives_driver_drop(rt):
    data = ray_tpu_torch.put(np.full(300_000, 5.0))   # shm-backed
    oid = data.object_id
    h = Holder.remote()
    assert ray_tpu_torch.get(h.set.remote([data]), timeout=60)
    del data                      # driver's only handle gone
    gc.collect()
    time.sleep(1.5)               # deletion (if wrongly triggered) lands
    # the actor's borrow keeps the object alive
    assert ray_tpu_torch.get(h.read.remote(), timeout=30) == 5.0
    # once the actor drops its borrow, the deferred decref frees it
    assert ray_tpu_torch.get(h.drop.remote(), timeout=30)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if rt.controller.unreferenced(oid) and not rt.store.contains(oid):
            break
        time.sleep(0.2)
    assert rt.controller.unreferenced(oid)
    assert not rt.store.contains(oid), "borrow release did not free object"


def test_put_containing_refs_keeps_inner_alive(rt):
    inner = ray_tpu_torch.put(np.full(200_000, 3.0))
    inner_id = inner.object_id
    outer = ray_tpu_torch.put([inner, "meta"])
    del inner                     # outer's containment keeps it counted
    gc.collect()
    time.sleep(1.0)
    got = ray_tpu_torch.get(outer, timeout=30)
    assert float(ray_tpu_torch.get(got[0], timeout=30)[0]) == 3.0
    del got
    # deleting the outer object cascades to the inner
    del outer
    gc.collect()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if not rt.store.contains(inner_id):
            break
        time.sleep(0.2)
    assert not rt.store.contains(inner_id), "containment release leaked"


def test_task_returning_ref(rt):
    @ray_tpu_torch.remote
    def make():
        return [ray_tpu_torch.put(np.full(150_000, 7.0))]

    box = ray_tpu_torch.get(make.remote(), timeout=60)
    gc.collect()
    time.sleep(1.0)               # worker-side borrow decrefs land
    assert float(ray_tpu_torch.get(box[0], timeout=30)[0]) == 7.0


def test_deferred_decref_parks_without_context():
    """Regression (ADVICE r5): a decref deferred while NO context is
    installed (shutdown / re-init gap) must stay parked and drain when
    the next context installs — not be silently dropped."""
    from ray_tpu_torch._private import context as _context
    from ray_tpu_torch._private import refs
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    assert _context.maybe_ctx() is None
    oid = "park_test_" + "0" * 10
    refs._deferred.append(oid)
    refs._flush_wake.set()
    refs._ensure_flusher()
    time.sleep(0.8)                     # several flusher wake cycles
    assert oid in refs._deferred        # parked, not dropped

    calls = []

    class _Ctx(ray_tpu_torch._private.context.BaseContext):
        def decref(self, object_id):
            calls.append(object_id)

    _context.set_ctx(_Ctx())            # install wakes the flusher
    try:
        deadline = time.monotonic() + 10
        while oid not in calls and time.monotonic() < deadline:
            time.sleep(0.05)
        assert oid in calls, "parked decref did not drain on install"
    finally:
        _context.set_ctx(None)


def test_parked_decref_set_is_bounded_and_drains_on_attach(
        monkeypatch):
    """r16 borrow-leak fix: with NO context installed, the deferred
    set is BOUNDED (oldest trimmed past _PARK_MAX, counted loudly)
    instead of growing for the process lifetime — and everything
    still parked drains the moment a context attaches."""
    from ray_tpu_torch._private import context as _context
    from ray_tpu_torch._private import refs
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    assert _context.maybe_ctx() is None
    monkeypatch.setattr(refs, "_PARK_MAX", 500)
    base_dropped = refs.dropped_parked
    refs._deferred.clear()
    for i in range(1300):
        refs._deferred.append(f"bound_test_{i}")
    refs._flush_wake.set()
    refs._ensure_flusher()
    deadline = time.monotonic() + 10
    while (len(refs._deferred) > 500
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert len(refs._deferred) <= 500
    assert refs.dropped_parked - base_dropped == 800
    # the NEWEST parked ids survived (oldest were trimmed)
    assert "bound_test_1299" in refs._deferred
    assert "bound_test_0" not in refs._deferred

    drained = []

    class _Ctx(ray_tpu_torch._private.context.BaseContext):
        def decref_batch(self, object_ids):
            drained.extend(object_ids)

    _context.set_ctx(_Ctx())
    try:
        deadline = time.monotonic() + 10
        while len(drained) < 500 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(drained) == 500 and not refs._deferred
        assert "bound_test_1299" in drained
    finally:
        _context.set_ctx(None)


def test_deferred_decrefs_flush_as_batches(rt):
    """The flusher drains in DECREF_BATCH-sized groups through the
    context's decref_batch hook (one frame per batch on wire-hop
    contexts)."""
    from ray_tpu_torch._private import refs
    batches = []
    orig = type(rt).decref_batch

    def spy(self, oids):
        batches.append(list(oids))
        orig(self, oids)

    type(rt).decref_batch = spy
    try:
        for i in range(10):
            refs._deferred.append("nonexistent_%02d" % i)
        refs._flush_wake.set()
        refs._ensure_flusher()
        deadline = time.monotonic() + 10
        while (sum(len(b) for b in batches) < 10
               and time.monotonic() < deadline):
            time.sleep(0.05)
        flat = [o for b in batches for o in b]
        assert all(o in flat for o in
                   ["nonexistent_%02d" % i for i in range(10)])
        assert all(len(b) <= 64 for b in batches)
    finally:
        type(rt).decref_batch = orig


def test_borrow_across_remote_agent(rt):
    """The borrow/decref messages relay through a real node agent."""
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    agent = NodeAgentProcess(num_cpus=2, resources={"bor": 4.0})
    try:
        deadline = time.monotonic() + 30
        while (len(rt.cluster.alive_nodes()) < 2
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert len(rt.cluster.alive_nodes()) >= 2

        data = ray_tpu_torch.put(np.full(250_000, 9.0))
        h = Holder.options(resources={"bor": 1.0}).remote()
        assert ray_tpu_torch.get(h.set.remote([data]), timeout=90)
        del data
        gc.collect()
        time.sleep(1.5)
        assert ray_tpu_torch.get(h.read.remote(), timeout=60) == 9.0
    finally:
        agent.terminate()
