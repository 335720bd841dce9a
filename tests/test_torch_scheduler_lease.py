"""Worker-lease pipelining: resource accounting for piggybacked tasks.

The dispatch sweep may queue a task FIFO on a BUSY worker without
charging resources (reference worker-lease model): the task rides the
lease and is charged when its predecessor completes and hands its
share over. These tests pin the ledger invariants that keep that
sound:

- a worker never holds more than ONE charged task (spare capacity
  stays visible to idle/new workers instead of concentrating on a few
  deep pipelines),
- completion releases the finished task's share and promotes exactly
  one successor,
- a steal-back of an uncharged task releases nothing.

The port's twin of `tests/test_scheduler_lease.py`, case for case.
"""
import threading

import pytest

from ray_tpu_torch._private import scheduler as sched_mod
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.scheduler import BUSY, IDLE, Scheduler, WorkerRec
from ray_tpu_torch._private.specs import TaskSpec


class FakeConn:
    def __init__(self):
        self.sent = []
        self.meta = {}
        self.stolen = []

    def send(self, msg):
        self.sent.append(msg)

    send_lazy = send

    def flush(self):
        pass

    def enable_coalescing(self):
        pass

    def request_async(self, msg):
        class _Fut:
            def __init__(self):
                self.cbs = []

            def add_done_callback(self, fn):
                self.cbs.append(fn)

            def result(self, timeout=None):
                return self._reply

            def reply(self, **fields):
                self._reply = dict(fields)
                for fn in self.cbs:
                    fn(self)
        fut = _Fut()
        self.stolen.append((msg, fut))
        return fut


class FakeRuntime:
    def on_task_dispatched(self, spec, worker_id):
        pass

    def on_actor_dispatched(self, spec, worker_id):
        pass

    def on_unplaceable(self, spec, reason):
        pass


@pytest.fixture
def sched():
    s = Scheduler(FakeRuntime(), {"CPU": 2.0}, ("127.0.0.1", 0))
    # two registered idle workers; the dispatch loop thread is NOT
    # started — tests drive sweeps explicitly
    for i in range(2):
        rec = WorkerRec(worker_id=f"w{i}", conn=FakeConn(), state=IDLE)
        s._workers[rec.worker_id] = rec
    yield s
    s._running = False


def _specs(n, start=0):
    return [TaskSpec(task_id=f"t{start + i:03d}", func_id="f")
            for i in range(n)]


def _enqueue_all(s, specs):
    with s._cv:
        for spec in specs:
            s._pending.append(spec)
            s._queued_at[id(spec)] = 0.0
            s._demand_add(spec)
        s._try_dispatch_locked()


def _charged_count(rec):
    return sum(1 for (_, _, charged) in rec.task_res.values() if charged)


def test_piggyback_charges_at_most_one_per_worker(sched):
    depth = CONFIG.worker_pipeline_depth
    assert depth >= 2, "defaults changed; test assumes pipelining on"
    _enqueue_all(sched, _specs(2 * depth + 2))
    w0, w1 = sched._workers["w0"], sched._workers["w1"]
    # both workers saturated to full pipeline depth...
    assert len(w0.tasks) == depth and len(w1.tasks) == depth
    # ...but each holds exactly ONE resource charge; the node ledger
    # balances charges, not queue depth
    assert _charged_count(w0) == 1 and _charged_count(w1) == 1
    assert sched.avail["CPU"] == 0.0
    # the head of each FIFO is the charged task
    for rec in (w0, w1):
        head = next(iter(rec.task_res))
        assert rec.task_res[head][2] is True


def test_completion_promotes_successor_charge(sched):
    depth = CONFIG.worker_pipeline_depth
    _enqueue_all(sched, _specs(2 * depth))
    w0 = sched._workers["w0"]
    first, second = list(w0.tasks)[:2]
    before = len(w0.tasks)
    sched.task_finished("w0", first)
    # the finished charge was released and the successor charged in the
    # same step — the ledger never transiently over-frees
    assert sched.avail["CPU"] == 0.0
    assert w0.task_res[second][2] is True
    assert _charged_count(w0) == 1
    # refill hysteresis: one completion leaves >= depth-1 queued; the
    # sweep runs only once two slots are free
    assert len(w0.tasks) >= before - 1


def test_drain_to_empty_releases_everything(sched):
    depth = CONFIG.worker_pipeline_depth
    specs = _specs(2 * depth)
    _enqueue_all(sched, specs)
    for rec_name in ("w0", "w1"):
        rec = sched._workers[rec_name]
        while rec.tasks:
            sched.task_finished(rec_name, next(iter(rec.tasks)))
    assert sched.avail["CPU"] == 2.0
    assert not sched._pending
    assert sched._workers["w0"].state == IDLE


def test_steal_of_uncharged_task_releases_nothing(sched):
    depth = CONFIG.worker_pipeline_depth
    assert depth >= 2
    _enqueue_all(sched, _specs(2 * depth))
    w0 = sched._workers["w0"]
    # blocking w0 releases its ONE charge and steals its queued tail
    sched.worker_blocked("w0")
    assert sched.avail["CPU"] >= 1.0
    assert len(w0.conn.stolen) == len(w0.tasks) - 1
    # the worker confirms one steal of an UNCHARGED task: the requeue
    # path must not release a share it never held, and the spec goes
    # back to the pending queue
    tid = w0.conn.stolen[0][0]["task_id"]
    assert w0.task_res[tid][2] is False
    avail_before = dict(sched.avail)
    w0.conn.stolen[0][1].reply(ok=True)
    assert sched.avail == avail_before
    assert tid not in w0.tasks
    assert any(s.task_id == tid for s in sched._pending)


def test_steal_of_charged_task_hands_charge_down(sched):
    """A steal-back that removes a CHARGED pipelined task must promote
    the next queued task (lease handoff), or the rest of the chain
    runs uncharged and the ledger over-reports free capacity."""
    depth = CONFIG.worker_pipeline_depth
    assert depth >= 3, "needs a 3-deep chain"
    # confine the chain to one worker
    sched._workers.pop("w1")
    sched.total = {"CPU": 1.0}
    sched.avail = {"CPU": 1.0}
    a, b, c = _specs(3)
    _enqueue_all(sched, [a, b, c])
    w0 = sched._workers["w0"]
    assert list(w0.tasks) == ["t000", "t001", "t002"]
    assert _charged_count(w0) == 1
    # the head blocks: its charge is released, the tail is stolen
    sched.worker_blocked("w0")
    assert [m["task_id"] for m, _ in w0.conn.stolen] == ["t001", "t002"]
    # the head completes while blocked: t001 is promoted (mark-only)
    sched.task_finished("w0", "t000")
    assert w0.task_res["t001"][2] is True
    # the worker confirms the steal of the now-CHARGED t001; t002's
    # steal raced too late (ok=False -> no callback action)
    w0.conn.stolen[0][1].reply(ok=True)
    assert w0.task_res["t002"][2] is True, "lease handoff skipped"
    # unblock re-acquires exactly the marked charge
    sched.worker_unblocked("w0")
    assert sched.avail["CPU"] == 0.0


def test_pg_task_never_piggybacks(sched):
    """A placement-group task queued on a full bundle must stay in the
    pending queue (where remove_placement_group fails it fast), never
    pipeline behind the bundle's occupant."""
    assert sched.reserve_bundle("pg1", 0, {"CPU": 1.0})
    blocker = TaskSpec(task_id="blk", func_id="f",
                       placement_group_id="pg1",
                       placement_group_bundle_index=0)
    _enqueue_all(sched, [blocker])
    rec = next(r for r in sched._workers.values() if "blk" in r.tasks)
    assert rec.task_res["blk"][2] is True
    queued = TaskSpec(task_id="qd", func_id="f",
                      placement_group_id="pg1",
                      placement_group_bundle_index=0)
    _enqueue_all(sched, [queued])
    assert "qd" not in rec.tasks
    assert any(s.task_id == "qd" for s in sched._pending)


def test_piggyback_respects_depth_and_need(sched):
    # a spec needing MORE than its predecessor cannot ride the lease
    # (the predecessor's release would not cover it)
    _enqueue_all(sched, _specs(2))
    big = TaskSpec(task_id="big", func_id="f",
                   resources={"CPU": 2.0})
    _enqueue_all(sched, [big])
    assert all("big" not in rec.tasks
               for rec in sched._workers.values())
    assert any(s.task_id == "big" for s in sched._pending)
