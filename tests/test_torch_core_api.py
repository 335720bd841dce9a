"""Core task/actor/object API on the port: the twin of
`tests/test_core_api.py`, test for test, run on `ray_tpu_torch`'s own
single-host runtime.

Models the reference's python/ray/tests/test_basic*.py coverage: task
round-trips, object semantics, actor ordering, error propagation.

The runtime fixtures are this file's own (`tests/conftest.py` starts the
JAX runtime under the same names): `ray_cluster` reuses a live port
runtime or starts one with `ray_tpu_torch.init(num_cpus=4)`,
`fresh_cluster` starts an isolated one, and the port's runtime is shut
down when the module ends.
"""
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError, TaskError


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


@pytest.fixture()
def fresh_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    yield rt
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
def identity(x):
    return x


def test_task_roundtrip(ray_cluster):
    assert ray_tpu_torch.get(add.remote(1, 2)) == 3


def test_put_get(ray_cluster):
    ref = ray_tpu_torch.put({"k": [1, 2, 3]})
    assert ray_tpu_torch.get(ref) == {"k": [1, 2, 3]}


def test_large_object_shm(ray_cluster):
    arr = np.random.rand(512, 512)
    out = ray_tpu_torch.get(identity.remote(arr))
    np.testing.assert_array_equal(arr, out)


def test_object_ref_args(ray_cluster):
    a = ray_tpu_torch.put(10)
    b = ray_tpu_torch.put(20)
    assert ray_tpu_torch.get(add.remote(a, b)) == 30


def test_chained_tasks(ray_cluster):
    r = add.remote(1, 1)
    for _ in range(5):
        r = add.remote(r, 1)
    assert ray_tpu_torch.get(r) == 7


def test_nested_refs_pass_through(ray_cluster):
    @ray_tpu_torch.remote
    def takes_list(refs):
        return sum(ray_tpu_torch.get(refs))

    refs = [ray_tpu_torch.put(i) for i in range(4)]
    assert ray_tpu_torch.get(takes_list.remote(refs)) == 6


def test_num_returns(ray_cluster):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    r1, r2, r3 = three.remote()
    assert ray_tpu_torch.get([r1, r2, r3]) == [1, 2, 3]


def test_parallel_tasks(ray_cluster):
    refs = [add.remote(i, i) for i in range(16)]
    assert ray_tpu_torch.get(refs) == [2 * i for i in range(16)]


def test_wait(ray_cluster):
    refs = [add.remote(i, 0) for i in range(4)]
    ready, not_ready = ray_tpu_torch.wait(refs, num_returns=4, timeout=30)
    assert len(ready) == 4 and not not_ready


def test_wait_caps_num_returns(ray_cluster):
    refs = [add.remote(i, 0) for i in range(5)]
    ray_tpu_torch.get(refs)  # all finished
    ready, not_ready = ray_tpu_torch.wait(refs, num_returns=1)
    assert len(ready) == 1 and len(not_ready) == 4


def test_fire_and_forget_results_evicted(ray_cluster):
    import gc
    from ray_tpu_torch._private import context
    rt = context.get_ctx()
    for _ in range(5):
        add.remote(1, 1)  # refs dropped immediately
    gc.collect()
    time.sleep(2.0)
    stats = rt.state_op("object_store_stats")
    # Results of dropped-ref tasks must not accumulate. Other tests' objects
    # may exist; bound is loose but catches unbounded growth.
    before = stats["num_objects"]
    for _ in range(10):
        add.remote(2, 2)
    gc.collect()
    time.sleep(2.0)
    after = rt.state_op("object_store_stats")["num_objects"]
    assert after <= before + 2


def test_cancel_pending_task(ray_cluster):
    from ray_tpu_torch.exceptions import TaskCancelledError

    @ray_tpu_torch.remote
    def slow():
        time.sleep(3)
        return 1

    # Saturate CPUs so the victim stays queued.
    blockers = [slow.remote() for _ in range(4)]
    victim = slow.remote()
    time.sleep(0.2)
    ray_tpu_torch.cancel(victim)
    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(victim, timeout=30)
    assert isinstance(ei.value.cause, TaskCancelledError)
    ray_tpu_torch.get(blockers)


def test_wait_timeout(ray_cluster):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return 1

    ref = slow.remote()
    ready, not_ready = ray_tpu_torch.wait([ref], num_returns=1, timeout=0.1)
    assert not ready and not_ready == [ref]


def test_get_timeout(ray_cluster):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)

    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.1)


def test_error_propagation(ray_cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(boom.remote())
    assert isinstance(ei.value.cause, ValueError)
    assert "kaboom" in str(ei.value)


def test_error_through_dependency(ray_cluster):
    @ray_tpu_torch.remote
    def boom():
        raise RuntimeError("upstream")

    # A task consuming a failed upstream ref fails at dependency resolution.
    with pytest.raises(TaskError):
        ray_tpu_torch.get(add.remote(boom.remote(), 1))


def test_nested_task_submission(ray_cluster):
    @ray_tpu_torch.remote
    def outer(n):
        return sum(ray_tpu_torch.get([add.remote(i, 1) for i in range(n)]))

    assert ray_tpu_torch.get(outer.remote(3)) == 6


def test_options_override(ray_cluster):
    f = add.options(name="my_add", max_retries=0)
    assert ray_tpu_torch.get(f.remote(2, 2)) == 4


def test_call_directly_raises(ray_cluster):
    with pytest.raises(TypeError):
        add(1, 2)


def test_cluster_resources(ray_cluster):
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 4.0


# ---------------- actors ----------------
@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.v = start

    def inc(self, n=1):
        self.v += n
        return self.v

    def read(self):
        return self.v

    def boom(self):
        raise KeyError("actor-err")


def test_actor_basic(ray_cluster):
    c = Counter.remote(5)
    assert ray_tpu_torch.get(c.inc.remote()) == 6
    assert ray_tpu_torch.get(c.read.remote()) == 6


def test_actor_built_from_a_dropped_put_ref(ray_cluster):
    """The caller drops the constructor's ref at once: the runtime pins
    it for the actor's life (a restart runs the constructor again), so
    the actor still gets the value, and unpins it once the actor is
    dead for good."""
    from ray_tpu_torch._private import context
    v = np.arange(1 << 16)                  # 512 KiB: an shm segment
    ref = ray_tpu_torch.put(v)
    oid = ref.object_id
    c = Counter.remote(ref)
    del ref
    np.testing.assert_array_equal(
        ray_tpu_torch.get(c.read.remote(), timeout=30), v)
    controller = context.get_ctx().controller
    assert oid in controller.pinned_ids()
    ray_tpu_torch.kill(c)
    deadline = time.monotonic() + 10
    while oid in controller.pinned_ids() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert oid not in controller.pinned_ids()


def test_actor_ordering(ray_cluster):
    c = Counter.remote()
    refs = [c.inc.remote() for _ in range(10)]
    assert ray_tpu_torch.get(refs) == list(range(1, 11))


def test_actor_error(ray_cluster):
    c = Counter.remote()
    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(c.boom.remote())
    assert isinstance(ei.value.cause, KeyError)
    # Actor survives method errors.
    assert ray_tpu_torch.get(c.inc.remote()) == 1


def test_named_actor(ray_cluster):
    Counter.options(name="global_counter").remote(100)
    h = ray_tpu_torch.get_actor("global_counter")
    assert ray_tpu_torch.get(h.inc.remote()) == 101


def test_actor_handle_to_task(ray_cluster):
    c = Counter.remote()

    @ray_tpu_torch.remote
    def bump(handle):
        return ray_tpu_torch.get(handle.inc.remote())

    assert ray_tpu_torch.get(bump.remote(c)) == 1


def test_actor_method_num_returns(ray_cluster):
    @ray_tpu_torch.remote
    class Splitter:
        @ray_tpu_torch.method(num_returns=2)
        def split(self, pair):
            return pair[0], pair[1]

    s = Splitter.remote()
    a, b = s.split.remote((7, 9))
    assert ray_tpu_torch.get([a, b]) == [7, 9]


def test_async_actor(ray_cluster):
    import asyncio

    @ray_tpu_torch.remote
    class AsyncActor:
        async def work(self, x):
            await asyncio.sleep(0.01)
            return x * 2

    a = AsyncActor.remote()
    assert ray_tpu_torch.get([a.work.remote(i) for i in range(4)]) == [0, 2, 4, 6]


def test_actor_instantiation_direct_raises(ray_cluster):
    with pytest.raises(TypeError):
        Counter()


def test_state_api_lists_actors(ray_cluster):
    from ray_tpu_torch._private import context
    actors = context.get_ctx().state_op("list_actors")
    assert isinstance(actors, list) and len(actors) >= 1
    assert {"actor_id", "state", "name"} <= set(actors[0])


# -------------------------------------------------------- runtime envs
def test_runtime_env_env_vars_task(ray_cluster):
    """env_vars apply inside the task and are REVERTED afterwards (the
    pooled worker is reused); reference _private/runtime_env semantics."""
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RTPU_TEST_FLAG": "on"}})
    def probe():
        import os
        return os.environ.get("RTPU_TEST_FLAG")

    @ray_tpu_torch.remote
    def probe_clean():
        import os
        return os.environ.get("RTPU_TEST_FLAG")

    assert ray_tpu_torch.get(probe.remote()) == "on"
    assert ray_tpu_torch.get(probe_clean.remote()) is None


def test_runtime_env_working_dir_task(ray_cluster, tmp_path):
    d = tmp_path / "wd"
    d.mkdir()
    (d / "marker.txt").write_text("here")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(d)})
    def read_marker():
        return open("marker.txt").read()

    assert ray_tpu_torch.get(read_marker.remote()) == "here"


def test_runtime_env_actor_env_vars(ray_cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RTPU_ACTOR_VAR": "42"}})
    class EnvActor:
        def probe(self):
            import os
            return os.environ["RTPU_ACTOR_VAR"]

    a = EnvActor.remote()
    assert ray_tpu_torch.get(a.probe.remote()) == "42"


def test_runtime_env_unsupported_keys_raise(ray_cluster):
    with pytest.raises(ValueError, match="unsupported runtime_env"):
        ray_tpu_torch.remote(runtime_env={"nfs_mount": "/x"})(lambda: 1)

    with pytest.raises(TypeError, match="env_vars"):
        ray_tpu_torch.remote(runtime_env={"env_vars": {"A": 1}})(lambda: 1)

    with pytest.raises(ValueError, match="working_dir"):
        ray_tpu_torch.remote(runtime_env={"working_dir": "/nonexistent_xyz"})(
            lambda: 1)


# ------------------------------------------------------------- cancel
def test_cancel_running_task_nonforce(ray_cluster):
    """Non-force cancel raises TaskCancelledError inside the running
    task (reference CancelTask); pure-Python loops observe it."""
    from ray_tpu_torch.exceptions import TaskCancelledError, TaskError

    @ray_tpu_torch.remote
    def spin(n):
        import time
        t0 = time.time()
        x = 0
        while time.time() - t0 < n:   # bytecode loop: async-exc lands
            x += 1
        return x

    ref = spin.remote(60)
    import time
    time.sleep(2.0)                   # let it start executing
    ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(ref, timeout=30)
    assert isinstance(ei.value.cause, TaskCancelledError)


def test_cancel_running_task_force_no_retry(ray_cluster):
    """force=True kills the worker; the task must NOT be retried even
    with retries budgeted (cancel beats recovery)."""
    from ray_tpu_torch.exceptions import TaskCancelledError, TaskError

    @ray_tpu_torch.remote(max_retries=3)
    def sleep_forever():
        import time
        time.sleep(600)

    ref = sleep_forever.remote()
    import time
    time.sleep(2.0)
    ray_tpu_torch.cancel(ref, force=True)
    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(ref, timeout=30)
    assert isinstance(ei.value.cause, TaskCancelledError)


def test_cancel_infeasible_parked_task(ray_cluster):
    """A task parked as infeasible (no node can fit it) must still be
    cancellable — it sits in no node queue."""
    from ray_tpu_torch.exceptions import TaskCancelledError, TaskError

    @ray_tpu_torch.remote(num_cpus=10_000)
    def impossible():
        return 1

    ref = impossible.remote()
    import time
    time.sleep(0.3)
    ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(ref, timeout=20)
    assert isinstance(ei.value.cause, TaskCancelledError)


def test_pipelined_task_stolen_from_blocked_worker(fresh_cluster):
    """Deadlock regression: a task pipelined behind another task on the
    same worker's FIFO, where the front task then blocks in a nested
    get() on the queued one. The scheduler must steal the queued task
    back (UNQUEUE_TASK) and run it elsewhere — without that, the get
    waits on a task that can never start (its exec thread is the one
    blocking)."""
    import time as _t

    @ray_tpu_torch.remote(num_cpus=0)
    def inner():
        return 7

    @ray_tpu_torch.remote(num_cpus=0)
    def outer():
        ref = inner.remote()
        # give the scheduler time to pipeline `inner` behind us on this
        # worker (num_cpus=0 on a cold pool -> we are the only worker)
        _t.sleep(0.5)
        return ray_tpu_torch.get(ref)

    assert ray_tpu_torch.get(outer.remote(), timeout=90) == 7
