"""Event-driven waiter core: registry semantics + no-thread parking.

Covers the replacement of thread-per-blocked-get (reference model:
raylet wait_manager.cc notification-driven waits).

The port's twin of `tests/test_waiters.py`, case for case.
"""
import ray_tpu_torch
import threading
import time

import pytest

from ray_tpu_torch._private.waiters import WaiterRegistry


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


def test_get_waiter_resolves_on_notify():
    present = set()
    reg = WaiterRegistry(lambda o: o in present)
    hits = []
    reg.add_get("a", lambda w, to: hits.append(("a", to)), timeout=5)
    assert hits == []
    present.add("a")
    reg.notify("a")
    assert hits == [("a", False)]
    reg.shutdown()


def test_get_waiter_timeout():
    reg = WaiterRegistry(lambda o: False)
    hits = []
    reg.add_get("x", lambda w, to: hits.append(to), timeout=0.1)
    deadline = time.time() + 3
    while not hits and time.time() < deadline:
        time.sleep(0.01)
    assert hits == [True]
    reg.shutdown()


def test_get_waiter_immediate_when_present():
    reg = WaiterRegistry(lambda o: True)
    hits = []
    reg.add_get("y", lambda w, to: hits.append(to), timeout=None)
    assert hits == [False]          # resolved synchronously
    assert reg.stats()["watched_ids"] == 0
    reg.shutdown()


def test_wait_waiter_threshold_and_order():
    present = set()
    reg = WaiterRegistry(lambda o: o in present)
    out = []
    reg.add_wait(["a", "b", "c"], 2, lambda w, r: out.append(r),
                 timeout=5)
    present.add("c")
    reg.notify("c")
    assert out == []                # 1 of 2
    present.add("a")
    reg.notify("a")
    assert out == [["a", "c"]]      # input order preserved
    reg.shutdown()


def test_wait_timeout_returns_partial():
    present = {"b"}
    reg = WaiterRegistry(lambda o: o in present)
    out = []
    reg.add_wait(["a", "b"], 2, lambda w, r: out.append(r), timeout=0.1)
    deadline = time.time() + 3
    while not out and time.time() < deadline:
        time.sleep(0.01)
    assert out == [["b"]]
    reg.shutdown()


def test_on_done_called_once():
    present = set()
    reg = WaiterRegistry(lambda o: o in present)
    done = []
    reg.add_get("z", lambda w, to: None, timeout=0.1,
                on_done=lambda: done.append(1))
    deadline = time.time() + 3
    while not done and time.time() < deadline:
        time.sleep(0.01)
    present.add("z")
    reg.notify("z")                 # late notify must not re-fire
    assert done == [1]
    reg.shutdown()


def test_parked_gets_add_no_driver_threads(rt):
    """20 worker-side gets blocked on one unsealed object must park in
    the registry, not in driver threads; sealing resolves all."""
    import ray_tpu_torch
    from ray_tpu_torch._private import context
    from ray_tpu_torch._private.refs import ObjectRef

    @ray_tpu_torch.remote(max_concurrency=20)
    class Getter:
        def fetch(self, box):
            return ray_tpu_torch.get(box[0]) + 1

    g = Getter.remote()
    assert ray_tpu_torch.get(g.fetch.remote([ray_tpu_torch.put(0)])) == 1

    ctx = context.get_ctx()
    pending = ObjectRef("pend_" + "0" * 15)
    ctx.addref(pending.object_id)
    futs = [g.fetch.remote([pending]) for _ in range(20)]
    deadline = time.time() + 10
    while ctx.waiters.stats()["watched_ids"] == 0 and time.time() < deadline:
        time.sleep(0.05)
    before = threading.active_count()
    time.sleep(0.3)
    assert threading.active_count() <= before   # no per-get threads
    ctx.store.put(41, object_id=pending.object_id)
    assert ray_tpu_torch.get(futs, timeout=30) == [42] * 20
    assert ctx.waiters.stats()["watched_ids"] == 0


@pytest.fixture
def rt():
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():       # one runtime per process
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
