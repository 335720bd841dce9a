"""Host-side collective group across actor processes.

Parity target: reference util/collective tests (allreduce/allgather/
broadcast/reducescatter/send/recv between actors over the gloo CPU
backend) — here over the coordinator-actor + shm transport. The twin of
`tests/test_collective.py`, test for test, on `ray_tpu_torch.util.collective`.
"""
import numpy as np
import pytest

import ray_tpu_torch


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
    class Worker:
        def __init__(self, rank, world, group):
            self._rank = rank
            self._group = group
            from ray_tpu_torch.util import collective
            collective.init_collective_group(world, rank,
                                             group_name=group)

        def ping(self):
            return "pong"

        def do_allreduce(self, op="sum"):
            from ray_tpu_torch.util import collective
            return collective.allreduce(
                np.full(4, float(self._rank + 1)), op=op,
                group_name=self._group)

        def do_allgather(self):
            from ray_tpu_torch.util import collective
            return collective.allgather(np.array([self._rank]),
                                        group_name=self._group)

        def do_broadcast(self):
            from ray_tpu_torch.util import collective
            return collective.broadcast(
                np.full(3, float(self._rank)), src_rank=1,
                group_name=self._group)

        def do_reducescatter(self):
            from ray_tpu_torch.util import collective
            return collective.reducescatter(
                np.arange(6, dtype=np.float64), group_name=self._group)

        def do_p2p(self):
            from ray_tpu_torch.util import collective
            if self._rank == 0:
                collective.send(np.array([41.0]), dst_rank=1,
                                group_name=self._group)
                collective.send(np.array([42.0]), dst_rank=1,
                                group_name=self._group)
                return None
            a = collective.recv(0, group_name=self._group)
            b = collective.recv(0, group_name=self._group)
            return [float(a[0]), float(b[0])]

        def do_barrier(self):
            from ray_tpu_torch.util import collective
            collective.barrier(group_name=self._group)
            return True
    return Worker


def test_collective_allreduce_allgather_broadcast(ray_cluster):
    Worker = _make_worker()
    # rank 0 first (it creates the coordinator), then the rest
    ws = [Worker.remote(r, 3, "g1") for r in range(3)]
    ray_tpu_torch.get([w.ping.remote() for w in ws])

    out = ray_tpu_torch.get([w.do_allreduce.remote() for w in ws])
    for o in out:
        np.testing.assert_array_equal(o, np.full(4, 6.0))  # 1+2+3

    out = ray_tpu_torch.get([w.do_allreduce.remote("max") for w in ws])
    for o in out:
        np.testing.assert_array_equal(o, np.full(4, 3.0))

    out = ray_tpu_torch.get([w.do_allgather.remote() for w in ws])
    for o in out:
        assert [int(x[0]) for x in o] == [0, 1, 2]

    out = ray_tpu_torch.get([w.do_broadcast.remote() for w in ws])
    for o in out:
        np.testing.assert_array_equal(o, np.full(3, 1.0))  # src_rank=1

    out = ray_tpu_torch.get([w.do_barrier.remote() for w in ws])
    assert out == [True, True, True]
    for w in ws:
        ray_tpu_torch.kill(w)


def test_collective_reducescatter_and_p2p(ray_cluster):
    Worker = _make_worker()
    ws = [Worker.remote(r, 2, "g2") for r in range(2)]
    ray_tpu_torch.get([w.ping.remote() for w in ws])

    out = ray_tpu_torch.get([w.do_reducescatter.remote() for w in ws])
    np.testing.assert_array_equal(out[0], np.array([0., 2., 4.]))
    np.testing.assert_array_equal(out[1], np.array([6., 8., 10.]))

    res = ray_tpu_torch.get([w.do_p2p.remote() for w in ws])
    assert res[1] == [41.0, 42.0]      # ordered p2p delivery
    for w in ws:
        ray_tpu_torch.kill(w)


def test_collective_requires_init(ray_cluster):
    from ray_tpu_torch.util import collective
    with pytest.raises(RuntimeError, match="not initialized"):
        collective.allreduce(np.ones(2), group_name="nope")


def _make_tensor_worker():
    @ray_tpu_torch.remote
    class TensorWorker:
        def __init__(self, rank, world, group):
            self._rank = rank
            self._group = group
            from ray_tpu_torch.util import collective
            collective.init_collective_group(world, rank,
                                             group_name=group)

        def reduce(self):
            import torch

            from ray_tpu_torch.util import collective
            bf = torch.full((4,), 1.5 * (self._rank + 1),
                            dtype=torch.bfloat16)
            f32 = torch.arange(3, dtype=torch.float32) + self._rank
            return (collective.allreduce(bf, group_name=self._group),
                    collective.allreduce(f32, group_name=self._group),
                    collective.reducescatter(
                        torch.ones(4, dtype=torch.bfloat16),
                        group_name=self._group))
    return TensorWorker


def test_collective_takes_torch_tensors(ray_cluster):
    """Torch tensors in: an f32 tensor comes back as numpy, as the JAX
    module returns numpy for a jax.Array; a bf16 tensor (numpy has no
    bfloat16) travels as its bytes and dtype, is reduced in bf16 and
    comes back as a bf16 tensor, exactly."""
    import torch
    TensorWorker = _make_tensor_worker()
    ws = [TensorWorker.remote(r, 2, "g_t") for r in range(2)]
    for bf, f32, rs in ray_tpu_torch.get([w.reduce.remote() for w in ws]):
        assert isinstance(bf, torch.Tensor) and bf.dtype == torch.bfloat16
        assert torch.equal(bf, torch.full((4,), 4.5, dtype=torch.bfloat16))
        assert isinstance(f32, np.ndarray)
        np.testing.assert_array_equal(f32, np.array([1.0, 3.0, 5.0]))
        assert rs.dtype == torch.bfloat16 and rs.shape == (2,)
        assert torch.equal(rs, torch.full((2,), 2.0, dtype=torch.bfloat16))
    for w in ws:
        ray_tpu_torch.kill(w)
