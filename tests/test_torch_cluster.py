"""Multi-node cluster + placement-group tests: the twin of
`tests/test_cluster.py`, test for test, on the port
(`ray_tpu_torch.cluster_utils.Cluster`, in-process nodes).

Parity with the reference's cluster_utils-based suites (SURVEY.md §4.2:
same-host multi-raylet simulation, killer-actor fault injection) and
bundle-policy tests (§2.1 N1b/N5). The twins of the two TPU pod-slice
cases (`test_tpu_slice_bundles_shape`,
`test_tpu_slice_placement_group_schedules_one_worker_per_host`) are in
`tests/test_torch_accelerators.py`, on the port's GPU slices.
`test_trainer_schedules_through_placement_group` runs `TorchTrainer`.
"""
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.exceptions import PlacementGroupUnschedulableError
from ray_tpu_torch.util import (placement_group, placement_group_table,
                          remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def _where():
    import os
    return os.environ["RAY_TPU_NODE_ID"]


@pytest.fixture()
def three_node_cluster():
    """Fresh 3-node cluster (2 CPUs each)."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    c = Cluster(initialize_head=False)
    n2 = c.add_node(num_cpus=2)
    n3 = c.add_node(num_cpus=2)
    yield c, n2, n3
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------- nodes
def test_nodes_register_and_aggregate_resources(three_node_cluster):
    c, _, _ = three_node_cluster
    assert len(c.alive_node_ids()) == 3
    assert ray_tpu_torch.cluster_resources()["CPU"] == 6.0


def test_tasks_schedule_across_nodes(three_node_cluster):
    c, _, _ = three_node_cluster

    @ray_tpu_torch.remote(num_cpus=2)
    def hold():
        import os
        import time as _t
        _t.sleep(1.5)
        return os.environ["RAY_TPU_NODE_ID"]

    # 3 concurrent 2-CPU tasks can only run if all three nodes are used.
    t0 = time.time()
    nodes = set(ray_tpu_torch.get([hold.remote() for _ in range(3)],
                            timeout=120))
    assert len(nodes) == 3
    assert time.time() - t0 < 60


def test_node_affinity_routes_and_custom_resources(three_node_cluster):
    c, n2, n3 = three_node_cluster
    strat = NodeAffinitySchedulingStrategy(node_id=n3)
    got = ray_tpu_torch.get(_where.options(scheduling_strategy=strat).remote(),
                      timeout=60)
    assert got == n3


@pytest.mark.slow    # ~12s (r16 tier-1 budget); node-death recovery
# keeps tier-1 siblings test_node_kill_restarts_actor_elsewhere +
# the delegated agent-death exactly-once test
def test_node_kill_detected_and_task_retried(three_node_cluster):
    c, n2, _ = three_node_cluster
    soft = NodeAffinitySchedulingStrategy(node_id=n2, soft=True)

    @ray_tpu_torch.remote(num_cpus=1, scheduling_strategy=soft)
    def slow():
        import os
        import time as _t
        _t.sleep(6)
        return os.environ["RAY_TPU_NODE_ID"]

    ref = slow.remote()
    time.sleep(2.0)
    c.kill_node(n2)   # abrupt: only heartbeat staleness reveals it
    assert ray_tpu_torch.get(ref, timeout=90) != n2
    assert len(c.alive_node_ids()) == 2


def test_node_kill_restarts_actor_elsewhere(three_node_cluster):
    c, n2, _ = three_node_cluster
    soft = NodeAffinitySchedulingStrategy(node_id=n2, soft=True)

    @ray_tpu_torch.remote(max_restarts=1, scheduling_strategy=soft)
    class A:
        def node(self):
            import os
            return os.environ["RAY_TPU_NODE_ID"]

    a = A.remote()
    assert ray_tpu_torch.get(a.node.remote(), timeout=60) == n2
    c.kill_node(n2)
    assert ray_tpu_torch.get(a.node.remote(), timeout=90) != n2


def test_hard_affinity_to_dead_node_fails_fast(three_node_cluster):
    c, n2, _ = three_node_cluster
    c.kill_node(n2)
    c.wait_for_nodes(2)
    time.sleep(4.0)   # health monitor marks it dead

    strat = NodeAffinitySchedulingStrategy(node_id=n2, soft=False)
    with pytest.raises(Exception):
        ray_tpu_torch.get(_where.options(scheduling_strategy=strat).remote(),
                    timeout=30)


# ------------------------------------------------------ placement groups
def test_pg_strict_spread_reserves_distinct_nodes(three_node_cluster):
    c, _, _ = three_node_cluster
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.wait(30)
    entry = placement_group_table(pg)
    assert entry["state"] == "CREATED"
    assert len(set(entry["bundle_nodes"])) == 3
    locs = ray_tpu_torch.get(
        [_where.options(placement_group=pg,
                        placement_group_bundle_index=i).remote()
         for i in range(3)], timeout=120)
    assert sorted(locs) == sorted(entry["bundle_nodes"])
    remove_placement_group(pg)


def test_pg_strict_pack_one_node(three_node_cluster):
    c, _, _ = three_node_cluster
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    assert pg.wait(30)
    entry = placement_group_table(pg)
    assert len(set(entry["bundle_nodes"])) == 1
    remove_placement_group(pg)


def test_pg_reservation_accounting_and_release(three_node_cluster):
    c, _, _ = three_node_cluster
    before = ray_tpu_torch.available_resources()["CPU"]
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(30)
    assert ray_tpu_torch.available_resources()["CPU"] == before - 2
    remove_placement_group(pg)
    deadline = time.time() + 10
    while time.time() < deadline:
        if ray_tpu_torch.available_resources()["CPU"] == before:
            break
        time.sleep(0.1)
    assert ray_tpu_torch.available_resources()["CPU"] == before


def test_pg_unschedulable_raises(three_node_cluster):
    with pytest.raises(PlacementGroupUnschedulableError):
        placement_group([{"CPU": 64}], strategy="STRICT_PACK")
    with pytest.raises(PlacementGroupUnschedulableError):
        placement_group([{"CPU": 1}] * 5, strategy="STRICT_SPREAD")


def test_pg_removed_while_task_queued_fails_fast(three_node_cluster):
    """A task parked on a full PG bundle must fail (not hang forever)
    when the PG is removed out from under it."""
    @ray_tpu_torch.remote(num_cpus=1)
    def _sleeper(sec):
        time.sleep(sec)
        return "done"

    @ray_tpu_torch.remote(num_cpus=1)
    def _queued():
        return "ran"

    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.wait(30)
    blocker = _sleeper.options(
        placement_group=pg, placement_group_bundle_index=0).remote(20)
    time.sleep(1.0)  # let the blocker occupy the bundle
    ref = _queued.options(
        placement_group=pg, placement_group_bundle_index=0).remote()
    remove_placement_group(pg)
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=30)
    del blocker


def test_pg_reschedules_after_node_death(three_node_cluster):
    c, n2, _ = three_node_cluster
    pg = placement_group([{"CPU": 1}] * 2, strategy="SPREAD")
    assert pg.wait(30)
    entry = placement_group_table(pg)
    victim = entry["bundle_nodes"][0]
    c.kill_node(victim)
    deadline = time.time() + 30
    ok = False
    while time.time() < deadline:
        entry = placement_group_table(pg)
        if (entry["state"] == "CREATED"
                and victim not in entry["bundle_nodes"]):
            ok = True
            break
        time.sleep(0.2)
    assert ok, f"PG did not reschedule off dead node: {entry}"
    remove_placement_group(pg)


# ------------------------------------------------------------- trainer
def test_trainer_schedules_through_placement_group():
    """VERDICT r1 #4 done-criterion: the TorchTrainer worker group rides
    a PG and an unsatisfiable group raises instead of hanging."""
    from ray_tpu_torch.train import TorchTrainer, ScalingConfig, RunConfig
    import tempfile
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)

    def loop(config):
        from ray_tpu_torch import train as rt_train
        rt_train.report({"done": 1})

    with tempfile.TemporaryDirectory() as d:
        result = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="pgtest", storage_path=d)).fit()
        assert result.error is None
        # PG is cleaned up after fit
        assert all(e["state"] == "REMOVED"
                   for e in placement_group_table().values())

        with pytest.raises(Exception, match="placement|capacity|fit"):
            TorchTrainer(
                loop,
                scaling_config=ScalingConfig(
                    num_workers=2,
                    resources_per_worker={"CPU": 64}),
                run_config=RunConfig(name="pgbig", storage_path=d)).fit()
    ray_tpu_torch.shutdown()


# -------------------------------------------------- node-label scheduling
def test_node_label_scheduling():
    """NodeLabelSchedulingStrategy: hard constraints filter nodes, soft
    constraints prefer, infeasible labels park until a matching node
    joins (reference NodeLabelSchedulingStrategy + label match exprs)."""
    from ray_tpu_torch.util.scheduling_strategies import (
        DoesNotExist, Exists, In, NodeLabelSchedulingStrategy)

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, labels={"region": "us", "tier": "head"})
    try:
        c = Cluster(initialize_head=False)
        n2 = c.add_node(num_cpus=2,
                        labels={"region": "eu", "accel": "v5e"})
        n3 = c.add_node(num_cpus=2, labels={"region": "eu"})

        def where(strategy):
            return ray_tpu_torch.get(_where.options(
                scheduling_strategy=strategy).remote(), timeout=120)

        assert where(NodeLabelSchedulingStrategy(
            hard={"accel": Exists()})) == n2
        # plain string is sugar for In(value); ops compose per-key
        assert where(NodeLabelSchedulingStrategy(
            hard={"region": "eu", "accel": DoesNotExist()})) == n3
        assert where(NodeLabelSchedulingStrategy(
            soft={"accel": In("v5e")})) == n2
        # soft-only constraint that nothing satisfies still schedules
        # (anywhere — soft never makes a task infeasible)
        assert where(NodeLabelSchedulingStrategy(
            soft={"accel": In("nonexistent")}))

        # hard-infeasible parks until a matching node joins
        ref = _where.options(
            scheduling_strategy=NodeLabelSchedulingStrategy(
                hard={"region": In("ap")})).remote()
        ready, _ = ray_tpu_torch.wait([ref], timeout=3)
        assert not ready
        n4 = c.add_node(num_cpus=1, labels={"region": "ap"})
        assert ray_tpu_torch.get(ref, timeout=120) == n4

        # labels surface on the state API
        from ray_tpu_torch.util import state
        by_id = {n["node_id"]: n for n in state.list_nodes()}
        assert by_id[n2]["labels"]["accel"] == "v5e"
    finally:
        ray_tpu_torch.shutdown()
