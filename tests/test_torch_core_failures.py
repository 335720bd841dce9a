"""Fault-tolerance tests: worker death, task retries, actor restarts.

Models the reference's kill-based fault injection strategy
(python/ray/_private/test_utils.py WorkerKillerActor:1597) with
self-terminating tasks instead of external killer actors.

The port's twin of `tests/test_core_failures.py`, case for case.
"""
import os
import tempfile
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError, TaskError, WorkerDiedError


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


def _attempt_file():
    f = tempfile.NamedTemporaryFile(prefix="rtt_attempt_", delete=False)
    f.write(b"0")
    f.close()
    return f.name


def test_task_retry_on_worker_death(fresh_cluster):
    path = _attempt_file()

    @ray_tpu_torch.remote(max_retries=2)
    def flaky(p):
        n = int(open(p).read())
        open(p, "w").write(str(n + 1))
        if n == 0:
            os._exit(1)  # simulate worker crash on first attempt
        return n

    assert ray_tpu_torch.get(flaky.remote(path), timeout=60) == 1
    os.unlink(path)


def test_task_failure_after_retries_exhausted(fresh_cluster):
    @ray_tpu_torch.remote(max_retries=0)
    def die():
        os._exit(1)

    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(die.remote(), timeout=60)
    assert isinstance(ei.value.cause, WorkerDiedError)


def test_actor_restart(fresh_cluster):
    # max_task_retries=0: the crashing call must NOT replay after restart
    # (it would deterministically crash the restarted actor too).
    @ray_tpu_torch.remote(max_restarts=1, max_task_retries=0)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def call(self):
            self.calls += 1
            return self.calls

        def crash(self):
            os._exit(1)

    a = Phoenix.remote()
    assert ray_tpu_torch.get(a.call.remote(), timeout=60) == 1
    crash_ref = a.crash.remote()
    # Calls in flight during the crash fail (max_task_retries=0); wait for
    # the restart to complete before checking state reset.
    time.sleep(3.0)
    # After restart, state is reset (fresh __init__), like the reference.
    assert ray_tpu_torch.get(a.call.remote(), timeout=60) == 1
    with pytest.raises(TaskError):
        ray_tpu_torch.get(crash_ref, timeout=60)


def test_actor_dead_after_max_restarts(fresh_cluster):
    @ray_tpu_torch.remote(max_restarts=0)
    class Mortal:
        def crash(self):
            os._exit(1)

        def ping(self):
            return "pong"

    a = Mortal.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    a.crash.remote()
    time.sleep(1.0)
    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(a.ping.remote(), timeout=60)
    assert isinstance(ei.value.cause, ActorDiedError)


def test_kill_actor(fresh_cluster):
    @ray_tpu_torch.remote(max_restarts=5)
    class Immortal:
        def ping(self):
            return "pong"

    a = Immortal.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    ray_tpu_torch.kill(a)  # no_restart=True overrides max_restarts
    time.sleep(1.0)
    with pytest.raises(TaskError):
        ray_tpu_torch.get(a.ping.remote(), timeout=60)


def test_actor_init_failure(fresh_cluster):
    @ray_tpu_torch.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("bad init")

        def ping(self):
            return "pong"

    a = Broken.remote()
    with pytest.raises(TaskError):
        ray_tpu_torch.get(a.ping.remote(), timeout=60)
