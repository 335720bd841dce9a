"""UNQUEUE_TASK steal-back protocol on the worker side.

Regression for the ADVICE r5 medium finding: a steal that raced AHEAD
of (or behind) the task's completion must refuse — replying ok after
the task ran left a poisoned ``_unqueued_tasks`` tombstone that
silently skipped a lineage-resubmitted task with the same id, hanging
its caller's ``get()`` forever.

The port's twin of `tests/test_worker_steal.py`, case for case.
"""
import threading
import time

import cloudpickle
import pytest

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.specs import TaskSpec
from ray_tpu_torch._private.worker_main import WorkerExecutor


class FakeConn:
    """Captures outbound frames; enough of Connection for the executor."""

    def __init__(self):
        self.sent = []
        self.replies = []
        self.lock = threading.Lock()

    def send(self, msg):
        with self.lock:
            self.sent.append(msg)

    send_lazy = send

    def flush(self):
        pass

    def reply(self, msg, **fields):
        with self.lock:
            self.replies.append(dict(fields))


class FakeCtx:
    worker_id = "w_test"

    def __init__(self, fns):
        self.conn = FakeConn()
        self._fns = {k: cloudpickle.dumps(v) for k, v in fns.items()}

    def get_function(self, func_id):
        return self._fns[func_id]

    def state_op(self, op, **kwargs):
        return None

    def kv_op(self, op, key, value=None, namespace="default", **kw):
        return None


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _task_dones(conn):
    with conn.lock:
        return [m for m in conn.sent
                if m.get("type") == protocol.TASK_DONE]


# module-level so cloudpickle saves them by reference (the "worker" is
# this same process); the gate lives in a global, not a closure, because
# an Event holds an unpicklable lock
_GATE = threading.Event()


def _fast_fn():
    return 42


def _gate_fn():
    _GATE.wait(10)


@pytest.fixture
def executor():
    _GATE.clear()
    ctx = FakeCtx({"f_fast": _fast_fn, "f_gate": _gate_fn})
    ex = WorkerExecutor(ctx)
    ex._gate = _GATE
    yield ex
    _GATE.set()
    ex.stop_event.set()


def _spec(tid, func="f_fast"):
    return TaskSpec(task_id=tid, func_id=func, return_ids=[tid + "r0"],
                    name=tid)


def test_unqueue_after_completion_refuses_and_leaves_no_tombstone(
        executor):
    conn = executor.ctx.conn
    executor.handle(conn, {"type": protocol.TASK, "spec": _spec("t1")})
    assert _wait_for(lambda: len(_task_dones(conn)) == 1)
    # the steal decision raced behind completion: must refuse
    executor.handle(conn, {"type": protocol.UNQUEUE_TASK,
                           "task_id": "t1", "rid": 1})
    assert conn.replies[-1] == {"ok": False}
    assert "t1" not in executor._steals._stolen
    # lineage resubmission reuses the same task id: it must RUN, not be
    # skipped by a stale tombstone
    executor.handle(conn, {"type": protocol.TASK, "spec": _spec("t1")})
    assert _wait_for(lambda: len(_task_dones(conn)) == 2), \
        "resubmitted task was silently skipped"


def test_unqueue_of_genuinely_queued_task_succeeds(executor):
    conn = executor.ctx.conn
    # t_block occupies the single exec thread; t2 is queued-not-started
    executor.handle(conn, {"type": protocol.TASK,
                           "spec": _spec("t_block", "f_gate")})
    assert _wait_for(lambda: "t_block" in executor._started_tasks)
    executor.handle(conn, {"type": protocol.TASK, "spec": _spec("t2")})
    executor.handle(conn, {"type": protocol.UNQUEUE_TASK,
                           "task_id": "t2", "rid": 2})
    assert conn.replies[-1] == {"ok": True}
    executor._gate.set()                      # unblock the exec thread
    assert _wait_for(lambda: len(_task_dones(conn)) == 1)
    # only t_block completed; the stolen t2 never ran and its tombstone
    # was consumed
    assert _task_dones(conn)[0]["task_id"] == "t_block"
    assert _wait_for(lambda: "t2" not in executor._steals._stolen)


def test_unqueue_of_started_task_refuses(executor):
    conn = executor.ctx.conn
    executor.handle(conn, {"type": protocol.TASK,
                           "spec": _spec("t_run", "f_gate")})
    assert _wait_for(lambda: "t_run" in executor._started_tasks)
    executor.handle(conn, {"type": protocol.UNQUEUE_TASK,
                           "task_id": "t_run", "rid": 3})
    assert conn.replies[-1] == {"ok": False}
    executor._gate.set()
    assert _wait_for(lambda: len(_task_dones(conn)) == 1)
