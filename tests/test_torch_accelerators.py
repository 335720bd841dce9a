"""The port's GPU accelerator manager, slice placement groups and
`ScalingConfig(topology=...)`: twins of the pod-slice cases of
`tests/test_cluster.py` (`test_tpu_slice_bundles_shape`,
`test_tpu_slice_placement_group_schedules_one_worker_per_host`), on
`ray_tpu_torch/_private/accelerators/gpu.py` and
`ray_tpu_torch/util/accelerators/gpu.py`, plus the topology cases of the
JAX `ScalingConfig` (`ray_tpu/train/config.py:109-135`) and the
accelerator type's refusals.

A GPU host type reads "<generation>-<cards>", 8 cards a host: "h100-32"
is four 8-card hosts, as "v4-32" is four 4-chip hosts in the JAX test.
The runtime fixtures are this file's own, and a live port runtime is
shut down when the module ends.
"""
import os
import tempfile

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.accelerators import gpu as accel
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.train import ElasticConfig, ScalingConfig
from ray_tpu_torch.util.placement_group import (placement_group_table,
                                                remove_placement_group)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


def _fresh_runtime(num_cpus=2):
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=num_cpus)


def _slice_cluster(hosts: int, pod: str) -> Cluster:
    """`hosts` simulated 8-card hosts advertising the slice's resources:
    {pod: 1} on each, the head resource on host 0."""
    c = Cluster(initialize_head=False)
    for i in range(hosts):
        extra = {"GPU": 8, pod: 1}
        if i == 0:
            extra["GPU-h100-head"] = 1
        c.add_node(num_cpus=2, resources=extra)
    return c


# --------------------------------------------------- slice placement
def test_gpu_slice_bundles_shape():
    from ray_tpu_torch.util.accelerators.gpu import slice_bundles
    bundles = slice_bundles("h100-32", pod_name="my-pod")
    # h100-32 = 32 cards, 8 per host -> 4 hosts
    assert len(bundles) == 4
    assert all(b["GPU"] == 8.0 and b["my-pod"] == 1.0 for b in bundles)
    assert bundles[0]["GPU-h100-head"] == 1.0
    assert all("GPU-h100-head" not in b for b in bundles[1:])


def test_gpu_slice_placement_group_schedules_one_worker_per_host():
    from ray_tpu_torch.util.accelerators.gpu import slice_placement_group
    _fresh_runtime()
    _slice_cluster(2, "my-slice")       # a 2-host h100-16 slice
    pg = slice_placement_group("h100-16", pod_name="my-slice")
    try:
        assert pg.wait(30)
        entry = placement_group_table(pg)
        assert len(set(entry["bundle_nodes"])) == 2
    finally:
        remove_placement_group(pg)
        ray_tpu_torch.shutdown()


def _run_topology(topology: str, per_host: int) -> None:
    """TorchTrainer over a 2-host slice of `topology` (on the CPU: gloo,
    the cards hidden): one worker bundle a host, STRICT_SPREAD, and each
    worker runs one rank a card, `per_host` ranks on each host, the
    first `per_host` in the head bundle."""
    from ray_tpu_torch.train import RunConfig, TorchConfig, TorchTrainer
    _fresh_runtime()
    c = _slice_cluster(2, "my-slice")
    head_host = next(n["node_id"] for n in c.list_nodes()
                     if "GPU-h100-head" in n["resources"])
    world = 2 * per_host

    def loop(config):
        import os

        from ray_tpu_torch import train as rt_train
        ctx = rt_train.get_context()
        with open(os.path.join(config["dir"],
                               f"rank{ctx.get_world_rank()}"), "w") as f:
            f.write(" ".join([os.environ["RAY_TPU_NODE_ID"],
                              str(ctx.get_local_rank()),
                              str(ctx.get_local_world_size()),
                              str(ctx.get_node_rank())]))
        rt_train.report({"world": ctx.get_world_size()})

    try:
        with tempfile.TemporaryDirectory() as d:
            result = TorchTrainer(
                loop, train_loop_config={"dir": d},
                scaling_config=ScalingConfig(topology=topology,
                                             pod_name="my-slice"),
                backend_config=TorchConfig(platform="cpu"),
                run_config=RunConfig(name="slice", storage_path=d)).fit()
            assert result.error is None, result.error
            assert result.metrics["world"] == world
            placed = [open(os.path.join(d, f"rank{r}")).read().split()
                      for r in range(world)]
        hosts = [p[0] for p in placed]
        assert len(set(hosts)) == 2
        assert set(hosts) <= set(c.alive_node_ids())
        assert set(hosts[:per_host]) == {head_host}
        assert hosts.count(head_host) == per_host
        assert [int(p[1]) for p in placed] == list(range(per_host)) * 2
        assert {int(p[2]) for p in placed} == {per_host}
        assert [int(p[3]) for p in placed] == [0] * per_host + [1] * per_host
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.slow
def test_topology_trainer_places_one_worker_per_host():
    """`ScalingConfig(topology="h100-16")` runs two workers, one on each
    host of the slice, in its STRICT_SPREAD placement group. A JAX
    worker drives its host's 8 chips; here each worker runs one rank a
    card: 16 ranks joined in one gloo group, 8 on each host, ranks 0-7
    in the head bundle. Slow: 16 processes import torch to join (9 s
    alone); `test_topology_trainer_runs_a_rank_per_card` is its fast
    sibling."""
    _run_topology("h100-16", 8)


def test_topology_trainer_runs_a_rank_per_card(monkeypatch):
    """The 4-rank sibling of the case above: hosts of 2 cards, so
    "h100-4" is a 2-host slice of 4 ranks, 2 on each host."""
    monkeypatch.setitem(accel._CARDS_PER_HOST, "h100", 2)
    assert (accel.num_hosts("h100-4"), accel.cards_per_host("h100-4")) == (2, 2)
    _run_topology("h100-4", 2)


def test_list_actors_reports_placement_group_and_bundle():
    """The state API names each actor's placement group and bundle index
    (None and -1 outside a group), so a caller can see where a slice's
    workers were put."""
    from ray_tpu_torch.util.placement_group import placement_group
    from ray_tpu_torch.util.state import list_actors
    _fresh_runtime(num_cpus=4)

    @ray_tpu_torch.remote(num_cpus=1)
    class Where:
        def ping(self):
            return "ok"

    pg = placement_group([{"CPU": 1.0}, {"CPU": 1.0}], strategy="PACK")
    try:
        assert pg.wait(30)
        inside = Where.options(placement_group=pg,
                               placement_group_bundle_index=1).remote()
        outside = Where.remote()
        assert ray_tpu_torch.get([inside.ping.remote(),
                                  outside.ping.remote()]) == ["ok", "ok"]
        rows = {a["actor_id"]: a for a in list_actors()}
        assert (rows[inside._actor_id]["placement_group_id"],
                rows[inside._actor_id]["placement_group_bundle_index"]) \
            == (pg.id, 1)
        assert (rows[outside._actor_id]["placement_group_id"],
                rows[outside._actor_id]["placement_group_bundle_index"]) \
            == (None, -1)
    finally:
        remove_placement_group(pg)
        ray_tpu_torch.shutdown()


# ------------------------------------------------ ScalingConfig(topology)
def test_scaling_config_topology_resources_and_bundles():
    s = ScalingConfig(topology="h100-16", pod_name="p")
    assert s.num_workers == 2 and s.use_gpu
    assert s.placement_strategy == "STRICT_SPREAD"
    assert s.worker_resources() == {"CPU": 1.0, "GPU": 8.0}
    assert s.worker_bundles() == [
        {"CPU": 1.0, "GPU": 8.0, "p": 1.0, "GPU-h100-head": 1.0},
        {"CPU": 1.0, "GPU": 8.0, "p": 1.0}]
    # one host with one card: "h100-1"
    one = ScalingConfig(num_workers=1, topology="h100-1",
                        resources_per_worker={"CPU": 2.0})
    assert one.num_workers == 1
    assert one.worker_resources() == {"CPU": 2.0, "GPU": 1.0}
    assert one.worker_bundles() == [
        {"CPU": 2.0, "GPU": 1.0, "GPU-h100-head": 1.0}]
    assert ScalingConfig(num_workers=3).worker_bundles() is None


def test_scaling_config_topology_refusals():
    with pytest.raises(ValueError, match="contradicts"):
        ScalingConfig(num_workers=3, topology="h100-16")
    # a slice preempts atomically: elastic is rejected loudly
    with pytest.raises(ValueError, match="elastic"):
        ScalingConfig(num_workers=2, topology="h100-16",
                      elastic=ElasticConfig())
    with pytest.raises(ValueError, match="unknown GPU generation"):
        ScalingConfig(topology="v4-16")


# ---------------------------------------------------- accelerator type
@pytest.mark.parametrize("bad", ["h100", "h100-", "h100-x", "h100-8-2",
                                 "h100-0", ""])
def test_parse_accelerator_type_refuses_malformed(bad):
    with pytest.raises(ValueError, match="malformed"):
        accel.parse_accelerator_type(bad)


def test_accelerator_type_arithmetic():
    assert accel.parse_accelerator_type("H100-16") == ("h100", 16)
    with pytest.raises(ValueError, match="unknown GPU generation"):
        accel.parse_accelerator_type("v5e-8")
    with pytest.raises(ValueError, match="unknown GPU generation"):
        accel.parse_accelerator_type("-8")
    assert (accel.num_hosts("h100-1"), accel.cards_per_host("h100-1")) == (1, 1)
    assert (accel.num_hosts("h100-8"), accel.cards_per_host("h100-8")) == (1, 8)
    assert (accel.num_hosts("h100-12"),
            accel.cards_per_host("h100-12")) == (2, 8)
    assert accel.head_resource_name("h200-24") == "GPU-h200-head"


def test_accelerator_manager_env(monkeypatch):
    m = accel.GPUAcceleratorManager
    assert m.RESOURCE_NAME == "GPU"
    # detection is the runtime's own probe (0 on a host without cards)
    from ray_tpu_torch._private.runtime import detect_num_gpus
    assert m.get_current_node_num_accelerators() == detect_num_gpus()
    for var in ("RAY_TPU_POD_NAME", "RAY_TPU_ACCELERATOR_TYPE",
                "RAY_TPU_POD_WORKER_ID"):
        monkeypatch.delenv(var, raising=False)
    assert m.get_current_node_additional_resources() == {}
    monkeypatch.setenv("RAY_TPU_POD_NAME", "slice-a")
    monkeypatch.setenv("RAY_TPU_ACCELERATOR_TYPE", "h100-16")
    assert m.get_current_node_accelerator_type() == "h100-16"
    assert m.get_current_node_additional_resources() == {
        "slice-a": 1.0, "GPU-h100-head": 1.0}
    monkeypatch.setenv("RAY_TPU_POD_WORKER_ID", "1")
    assert m.get_current_pod_worker_id() == 1
    assert m.get_current_node_additional_resources() == {"slice-a": 1.0}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    m.set_visible_accelerators([2, 5])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,5"
