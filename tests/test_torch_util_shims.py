"""The port's ActorPool and the trainer's placement group: twins of the
actor-pool cases of `tests/test_util_shims.py` and of
`tests/test_cluster.py::test_trainer_schedules_through_placement_group`,
on the port's runtime (reference P17: ActorPool; VERDICT r1 #4: the
trainer's worker group rides a placement group).

The runtime fixtures are this file's own: `ray_cluster` reuses a live
port runtime or starts one with `ray_tpu_torch.init(num_cpus=4)`, and
the runtime is shut down when the module ends.
"""
import tempfile

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


def _make_worker():
    @ray_tpu_torch.remote
    class PoolWorker:
        def __init__(self, factor):
            self.factor = factor

        def ping(self):
            return "pong"

        def mul(self, x):
            return x * self.factor

        def slow_mul(self, x):
            import time
            time.sleep(0.05 * (x % 3))
            return x * self.factor
    return PoolWorker


def test_actor_pool_ordered_map(ray_cluster):
    W = _make_worker()
    pool = ActorPool([W.remote(10) for _ in range(3)])
    out = list(pool.map(lambda a, v: a.mul.remote(v), range(8)))
    assert out == [v * 10 for v in range(8)]       # submission order
    assert pool.num_idle == 3


def test_actor_pool_unordered_and_backpressure(ray_cluster):
    W = _make_worker()
    pool = ActorPool([W.remote(2) for _ in range(2)])
    # 6 submissions over 2 actors: 4 queue host-side
    out = sorted(pool.map_unordered(
        lambda a, v: a.slow_mul.remote(v), range(6)))
    assert out == [v * 2 for v in range(6)]
    assert pool.num_pending == 0


def test_actor_pool_submit_get_next(ray_cluster):
    W = _make_worker()
    pool = ActorPool([W.remote(1)])
    pool.submit(lambda a, v: a.mul.remote(v), 7)
    pool.submit(lambda a, v: a.mul.remote(v), 8)   # queued (1 actor)
    assert pool.has_next()
    assert pool.get_next() == 7
    assert pool.get_next() == 8
    assert not pool.has_next()
    with pytest.raises(StopIteration):
        pool.get_next()


def test_trainer_schedules_through_placement_group():
    """TorchTrainer's worker group rides a placement group, and an
    unsatisfiable group raises instead of hanging."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.util.placement_group import placement_group_table
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)

    def loop(config):
        from ray_tpu_torch import train as rt_train
        rt_train.report({"done": 1})

    try:
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
                    run_config=RunConfig(name="pgbig",
                                         storage_path=d)).fit()
            # a GPU worker on a host with no card cannot be placed either
            with pytest.raises(Exception, match="placement|capacity|fit"):
                TorchTrainer(
                    loop,
                    scaling_config=ScalingConfig(num_workers=1,
                                                 use_gpu=True),
                    run_config=RunConfig(name="pggpu",
                                         storage_path=d)).fit()
    finally:
        ray_tpu_torch.shutdown()
