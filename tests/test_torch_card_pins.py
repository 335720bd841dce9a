"""Cards pinned to leases: every card a worker reserves, and no other.

The runtime counts a `GPU` resource per node, and each lease that holds
`GPU` holds named cards: the node's card pool (or a placement-group
bundle's, carved out of it) gives the charge its cards, and the worker
sets `CUDA_VISIBLE_DEVICES` to them before the task or the actor's
constructor runs. A worker whose process has initialised CUDA keeps the
card set it saw then, so it takes only leases of those cards.

The tests need no card: the runtimes here are started with `num_gpus=8`
(and a node agent with `--num-gpus 2`), and a worker's CUDA context is
faked with `accelerators.gpu.mark_cuda_bound()`, the flag a process sets
when it initialised CUDA by a route the runtime cannot see. The runtime
fixtures are this file's own.
"""
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.accelerators import gpu
from ray_tpu_torch._private.accelerators.gpu import CardPool, sub_cards
from ray_tpu_torch._private.scheduler import IDLE, Scheduler, WorkerRec
from ray_tpu_torch._private.specs import TaskSpec
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)


@pytest.fixture(scope="module")
def eight_cards():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4, num_gpus=8)
    yield rt
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_gpus=1)
class OneCard:
    def cards(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


@ray_tpu_torch.remote(num_gpus=0.5)
class HalfCard:
    def cards(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def _kill_all(actors) -> None:
    for a in actors:
        ray_tpu_torch.kill(a)


def _wait_for(pred, within_s: float = 10.0) -> bool:
    end = time.monotonic() + within_s
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _gpus_free(rt, n: float) -> bool:
    """True once the head node's ledger is back to `n` free GPUs (a killed
    actor's card returns when its worker's death is processed)."""
    return _wait_for(lambda: abs(rt.scheduler.avail["GPU"] - n) < 1e-9)


# ------------------------------------------------------------ the pool
def test_card_pool_takes_whole_cards_and_packs_fractions():
    pool = CardPool.of_node(4)
    assert pool.choose(2) == ((0, 1.0), (1, 1.0))
    pool.charge(pool.choose(1))                     # card 0
    half = pool.choose(0.5)
    assert half == ((1, 0.5),)                      # least left that fits
    pool.charge(half)
    # the next half packs onto the half-used card, not a whole one
    assert pool.choose(0.5) == ((1, 0.5),)
    pool.charge(pool.choose(0.25))                  # 0.25 on card 1
    # 1.5: one whole free card and a half of another
    assert pool.choose(1.5) == ((2, 1.0), (3, 0.5))
    assert pool.choose(3) is None                   # 2 whole cards left
    assert pool.choose(1, only=[0]) is None         # card 0 is taken
    assert pool.choose(1, only=[3]) == ((3, 1.0),)
    assert pool.choose(2, only=[3]) is None
    pool.refund(((0, 1.0),))
    assert pool.choose(3) == ((0, 1.0), (2, 1.0), (3, 1.0))
    assert CardPool.of_node(1.5).free == {0: 1.0, 1: 0.5}
    # a task riding a lease takes its share of the same cards
    assert sub_cards(((3, 1.0),), 0.5) == ((3, 0.5),)
    assert sub_cards(((2, 1.0), (3, 1.0)), 2) == ((2, 1.0), (3, 1.0))
    assert sub_cards(((3, 0.5),), 1) is None
    assert sub_cards(None, 1) is None


def test_card_names_follow_the_nodes_visible_devices(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert gpu.card_names(3) == ["0", "1", "2"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert gpu.card_names(2) == ["3", "5"]
    assert gpu.card_names(4) == ["0", "1", "2", "3"]   # names too few
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-aa, GPU-bb")
    assert gpu.card_names(2) == ["GPU-aa", "GPU-bb"]


def test_a_bound_process_refuses_other_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(gpu, "_marked_bound", False)
    assert not gpu.cuda_bound()                 # a CPU-only torch
    pin = gpu.GPUAcceleratorManager.set_visible_accelerators
    pin(["4"])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "4"
    monkeypatch.setattr(gpu, "_marked_bound", True)
    assert gpu.cuda_bound()
    pin(["4"])                                  # the same card: fine
    with pytest.raises(RuntimeError, match="cannot be pinned"):
        pin(["5"])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "4"


# ------------------------------------------------------ the scheduler
class _Conn:
    def __init__(self):
        self.sent, self.meta = [], {}

    def send(self, msg):
        self.sent.append(msg)

    send_lazy = send

    def enable_coalescing(self):
        pass


class _Runtime:
    def on_task_dispatched(self, spec, worker_id):
        pass

    def on_actor_dispatched(self, spec, worker_id):
        pass

    def on_unplaceable(self, spec, reason):
        pass


def _sweep(s, specs):
    with s._cv:
        for spec in specs:
            s._pending.append(spec)
            s._queued_at[id(spec)] = 0.0
            s._demand_add(spec)
        s._try_dispatch_locked()


def test_pipelined_gpu_task_rides_only_its_workers_cards():
    """A third 1-card task on a 2-card node pipelines behind one of the
    two running ones and takes that worker's card; a worker bound to a
    card is passed over for a lease of the other."""
    s = Scheduler(_Runtime(), {"CPU": 4.0, "GPU": 2.0}, ("127.0.0.1", 0))
    for i in range(2):
        rec = WorkerRec(worker_id=f"w{i}", conn=_Conn(), state=IDLE)
        s._workers[rec.worker_id] = rec
    s._workers["w1"].bound_cards = "0"
    try:
        specs = [TaskSpec(task_id=f"t{i}", func_id="f",
                          resources={"GPU": 1.0}) for i in range(3)]
        _sweep(s, specs)
        w0, w1 = s._workers["w0"], s._workers["w1"]
        # card 0 goes to w1, the worker bound to it; card 1 to w0
        assert w1.task_cards["t0"] == ((0, 1.0),)
        assert w0.task_cards["t1"] == ((1, 1.0),)
        assert w1.conn.sent[0]["cards"] == "0"
        assert w0.conn.sent[0]["cards"] == "1"
        # t2 rides a running lease, uncharged, on that lease's card
        rode = w0 if "t2" in w0.tasks else w1
        assert rode.task_res["t2"][2] is False
        assert rode.conn.sent[-1]["cards"] == rode.conn.sent[0]["cards"]
        assert s._cards.free == {0: 0.0, 1: 0.0}
        first = next(iter(rode.tasks))
        s.task_finished(rode.worker_id, first)
        # the share passed to t2: still no card free
        assert rode.task_res["t2"][2] is True
        assert s._cards.free == {0: 0.0, 1: 0.0} and s.avail["GPU"] == 0.0
        s.task_finished(rode.worker_id, "t2")
        other = w1 if rode is w0 else w0
        s.task_finished(other.worker_id, next(iter(other.tasks)))
        assert s._cards.free == {0: 1.0, 1: 1.0} and s.avail["GPU"] == 2.0
    finally:
        s._running = False


def test_a_full_pool_stops_a_worker_bound_to_other_cards():
    """With the pool at its cap and every idle worker bound to another
    card, one of them is stopped so a worker for the lease can start."""
    s = Scheduler(_Runtime(), {"CPU": 4.0, "GPU": 2.0}, ("127.0.0.1", 0),
                  max_workers=1)
    rec = WorkerRec(worker_id="w0", conn=_Conn(), state=IDLE,
                    bound_cards="1")
    s._workers["w0"] = rec
    s.spawn_worker = lambda renv=None: None
    try:
        with s._cv:
            s._cards.charge(((1, 1.0),))     # card 1 is held elsewhere
        _sweep(s, [TaskSpec(task_id="t", func_id="f",
                            resources={"GPU": 1.0})])
        assert rec.state == "dead" and rec.conn.sent[-1]["type"] == \
            "shutdown"
        assert not rec.tasks
    finally:
        s._running = False


def test_a_blocked_worker_keeps_its_cards():
    """A worker blocked in `get` gives back its CPU (the nested-task rule)
    but not its card: its process stays pinned to it, so another lease
    must not get it meanwhile. Its death gives both back."""
    s = Scheduler(_Runtime(), {"CPU": 2.0, "GPU": 1.0}, ("127.0.0.1", 0))
    rec = WorkerRec(worker_id="w0", conn=_Conn(), state=IDLE)
    s._workers["w0"] = rec
    try:
        _sweep(s, [TaskSpec(task_id="t", func_id="f",
                            resources={"CPU": 1.0, "GPU": 1.0})])
        assert s.avail == {"CPU": 1.0, "GPU": 0.0}
        s.worker_blocked("w0")
        assert s.avail == {"CPU": 2.0, "GPU": 0.0}
        assert s._cards.free == {0: 0.0}
        s.worker_unblocked("w0")
        assert s.avail == {"CPU": 1.0, "GPU": 0.0}
        s.worker_blocked("w0")
        s.on_worker_lost("w0")                 # dies while blocked
        assert s.avail == {"CPU": 2.0, "GPU": 1.0}
        assert s._cards.free == {0: 1.0}
    finally:
        s._running = False


# ------------------------------------------------------- the runtime
def test_eight_one_card_actors_hold_eight_cards(eight_cards):
    actors = [OneCard.remote() for _ in range(8)]
    try:
        cards = ray_tpu_torch.get([a.cards.remote() for a in actors],
                                  timeout=60)
        assert sorted(cards) == [str(i) for i in range(8)]
        assert eight_cards.scheduler.avail["GPU"] == 0.0
    finally:
        _kill_all(actors)
    assert _gpus_free(eight_cards, 8.0)


def test_two_half_card_actors_share_one_card(eight_cards):
    actors = [HalfCard.remote() for _ in range(2)]
    try:
        a, b = ray_tpu_torch.get([x.cards.remote() for x in actors],
                                 timeout=60)
        assert a == b and len(a.split(",")) == 1
    finally:
        _kill_all(actors)
    assert _gpus_free(eight_cards, 8.0)


def test_a_two_card_task_gets_two_cards(eight_cards):
    @ray_tpu_torch.remote(num_gpus=2)
    def two():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    cards = ray_tpu_torch.get(two.remote(), timeout=60).split(",")
    assert len(cards) == 2 and len(set(cards)) == 2
    assert set(cards) <= {str(i) for i in range(8)}


def test_a_killed_actors_card_goes_to_the_next_lease(eight_cards):
    actors = [OneCard.remote() for _ in range(8)]
    try:
        cards = ray_tpu_torch.get([a.cards.remote() for a in actors],
                                  timeout=60)
        victim = cards.index("5")
        ray_tpu_torch.kill(actors[victim])
        assert _gpus_free(eight_cards, 1.0)
        late = OneCard.remote()
        actors[victim] = late
        assert ray_tpu_torch.get(late.cards.remote(), timeout=60) == "5"
    finally:
        _kill_all(actors)
    assert _gpus_free(eight_cards, 8.0)


def test_a_bundles_actors_get_the_bundles_cards(eight_cards):
    """Two bundles of two cards each: their four one-card actors hold
    four cards, two from each bundle, and an actor outside the group
    gets none of them."""
    pg = placement_group([{"CPU": 0.1, "GPU": 2.0}] * 2, strategy="PACK")
    actors = []
    try:
        assert pg.wait(30)
        for b in range(2):
            actors += [OneCard.options(num_cpus=0.05, placement_group=pg,
                                       placement_group_bundle_index=b)
                       .remote() for _ in range(2)]
        outside = OneCard.remote()
        actors.append(outside)
        got = ray_tpu_torch.get([a.cards.remote() for a in actors],
                                timeout=60)
        assert len(set(got)) == 5
        led = eight_cards.scheduler._bundles
        for b in range(2):
            mine = {str(i) for i in led[(pg.id, b)]["cards"].free}
            assert set(got[2 * b:2 * b + 2]) == mine
    finally:
        _kill_all(actors)
        remove_placement_group(pg)
    assert _gpus_free(eight_cards, 8.0)


def _worker_by_pid(rt, pid):
    for rec in rt.scheduler._workers.values():
        if rec.proc is not None and rec.proc.pid == pid:
            return rec
    return None


def test_a_cuda_bound_worker_is_never_handed_other_cards(eight_cards):
    """A 1-card task marks its worker's process CUDA-bound on card 0.
    While a placement group holds card 0, the next 1-card task (card 1)
    runs in another worker; a task of the group's (card 0) may reuse the
    bound one."""
    @ray_tpu_torch.remote(num_gpus=1)
    def touch_cuda():
        from ray_tpu_torch._private.accelerators import gpu as g
        g.mark_cuda_bound()
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    @ray_tpu_torch.remote(num_gpus=1)
    def where():
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    bound_pid, card = ray_tpu_torch.get(touch_cuda.remote(), timeout=60)
    assert card == "0"
    rec = _worker_by_pid(eight_cards, bound_pid)
    assert _wait_for(lambda: rec.state == IDLE and rec.bound_cards == "0")
    pg = placement_group([{"CPU": 0.1, "GPU": 1.0}])
    try:
        assert pg.wait(30)
        assert {i for i in eight_cards.scheduler._bundles[(pg.id, 0)]
                ["cards"].free} == {0}
        pid, card = ray_tpu_torch.get(where.remote(), timeout=60)
        assert card == "1" and pid != bound_pid
        pid, card = ray_tpu_torch.get(
            where.options(num_cpus=0.05, placement_group=pg,
                          placement_group_bundle_index=0).remote(),
            timeout=60)
        assert card == "0" and pid == bound_pid       # warm: its card
    finally:
        remove_placement_group(pg)


def test_an_agent_nodes_actors_hold_its_cards(eight_cards):
    """A node agent started with two cards leases them by name: its two
    one-card actors hold cards 0 and 1 of that node."""
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    agent = NodeAgentProcess(num_cpus=2, num_gpus=2,
                             resources={"agent_cards": 1.0})
    actors = []
    try:
        assert _wait_for(lambda: len(eight_cards.cluster.alive_nodes()) >= 2,
                         within_s=30)

        @ray_tpu_torch.remote(num_gpus=1, resources={"agent_cards": 0.1})
        class OnAgent:
            def where(self):
                return (os.environ.get("RAY_TPU_NODE_ID"),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        actors = [OnAgent.remote() for _ in range(2)]
        got = ray_tpu_torch.get([a.where.remote() for a in actors],
                                timeout=60)
        assert {n for n, _ in got} == {agent.node_id}
        assert sorted(c for _, c in got) == ["0", "1"]
    finally:
        _kill_all(actors)
        agent.terminate()
        agent.wait(10)


def _rank_zero_cls():
    """Rank 0 of a tp=2 replica on the CPU whose follower reserves a
    card, as a replica on the card does (made here: pickles by value)."""
    class RankZero:
        def __init__(self):
            from ray_tpu_torch.serve.llm.engine import LLMEngine
            self.eng = LLMEngine(model="tiny", mesh={"tp": 2}, num_pages=16,
                                 page_size=8, max_batch=2, device="cpu",
                                 ray_actor_options={"num_gpus": 1})

        def cards(self):
            return self.eng.engine_stats()["tp_cards"]

        def close(self):
            self.eng.close()
    return RankZero


def test_two_replica_groups_on_one_node_share_no_card(eight_cards):
    """Two tp=2 replicas of one card a rank on one 8-card node: four
    ranks, four cards, where a rank % count guess put both replicas'
    rank 1 on card 1."""
    cls = ray_tpu_torch.remote(num_gpus=1)(_rank_zero_cls())
    reps = [cls.remote() for _ in range(2)]
    try:
        got = ray_tpu_torch.get([r.cards.remote() for r in reps],
                                timeout=90)
        assert all(len(g) == 2 for g in got)
        cards = [c for g in got for c in g]
        assert len(set(cards)) == 4, got
        ray_tpu_torch.get([r.close.remote() for r in reps], timeout=60)
    finally:
        _kill_all(reps)


def test_a_cpu_task_keeps_the_pin_and_a_gpu_lease_repins():
    """On a runtime with one worker: a 3-card task pins it; a task with
    no `GPU` runs under that pin; a 1-card lease pins the same (unbound)
    worker anew."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=8)
    try:
        def where():
            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

        def run(**opts):
            out = ray_tpu_torch.get(
                ray_tpu_torch.remote(**opts)(where).remote(), timeout=60)
            rec = _worker_by_pid(rt, out[0])
            assert _wait_for(lambda: rec.state == IDLE)
            return out

        pid, cards = run(num_gpus=3)
        assert cards == "0,1,2"
        assert run(num_gpus=0) == (pid, "0,1,2")
        assert run(num_gpus=1) == (pid, "0")
        assert len(rt.scheduler._workers) == 1
    finally:
        ray_tpu_torch.shutdown()
