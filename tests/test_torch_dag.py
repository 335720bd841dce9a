"""Compiled DAGs (P9): bind/compile/execute over actor pipelines. The
twin of `tests/test_dag.py`, test for test, on the port (`ray_tpu_torch.dag`,
`ray_tpu_torch/experimental/`); its raw-frame case carries torch tensors
where the JAX case carries `jax.Array`s."""
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import CompiledDAG, InputNode, MultiOutputNode


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


def _stage_cls():
    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, tag):
            self.tag = tag
            self.calls = 0

        def ping(self):
            return "pong"

        def work(self, x):
            self.calls += 1
            return f"{x}->{self.tag}"

        def merge(self, a, b):
            return f"({a}+{b})"

        def num_calls(self):
            return self.calls
    return Stage


def test_dag_linear_pipeline(ray_cluster):
    Stage = _stage_cls()
    a, b, c = Stage.remote("a"), Stage.remote("b"), Stage.remote("c")
    with InputNode() as inp:
        x = a.work.bind(inp)
        y = b.work.bind(x)
        z = c.work.bind(y)
    dag = z.experimental_compile()
    assert isinstance(dag, CompiledDAG)
    out = ray_tpu_torch.get(dag.execute("in"), timeout=60)
    assert out == "in->a->b->c"
    # reusable: consecutive executes pipeline through the same actors
    refs = [dag.execute(i) for i in range(5)]
    assert ray_tpu_torch.get(refs, timeout=60) == [
        f"{i}->a->b->c" for i in range(5)]
    assert dag.num_executions == 6


def test_dag_fan_in_fan_out(ray_cluster):
    Stage = _stage_cls()
    a, b, m = Stage.remote("a"), Stage.remote("b"), Stage.remote("m")
    with InputNode() as inp:
        left = a.work.bind(inp)
        right = b.work.bind(inp)
        merged = m.merge.bind(left, right)
        dag = MultiOutputNode([merged, left]).experimental_compile()
    out_ref, left_ref = dag.execute("x")
    assert ray_tpu_torch.get(out_ref, timeout=60) == "(x->a+x->b)"
    assert ray_tpu_torch.get(left_ref, timeout=60) == "x->a"


def test_dag_validation(ray_cluster):
    Stage = _stage_cls()
    a = Stage.remote("a")
    with InputNode() as inp:
        x = a.work.bind(inp)
    dag = x.experimental_compile()
    with pytest.raises(TypeError, match="exactly 1 input"):
        dag.execute()
    with pytest.raises(TypeError, match="exactly 1 input"):
        dag.execute(1, 2)
    # cycles are rejected
    n1 = a.work.bind("seed")
    n1.upstream.append(n1)
    with pytest.raises(ValueError, match="cycle"):
        n1.experimental_compile()


def test_dag_constant_args_without_input(ray_cluster):
    Stage = _stage_cls()
    a, b = Stage.remote("a"), Stage.remote("b")
    dag = b.work.bind(a.work.bind("k")).experimental_compile()
    assert ray_tpu_torch.get(dag.execute(), timeout=60) == "k->a->b"


# --------------------------------------------- shm-channel fast path
def test_channel_dag_chain_and_pipelining(ray_cluster):
    """VERDICT r3 item 8 gate: zero-copy mutable shm channels — a
    compiled chain executes with no per-hop task submission, results
    arrive in order, pipelined executes overlap."""
    Stage = _stage_cls()
    a, b = Stage.remote("a"), Stage.remote("b")
    with InputNode() as inp:
        y = b.work.bind(a.work.bind(inp))
    dag = y.experimental_compile(enable_shm_channels=True)
    try:
        for i in range(4):
            assert dag.execute(f"m{i}").get() == f"m{i}->a->b"
        refs = [dag.execute(f"p{i}") for i in range(4)]
        assert [r.get() for r in refs] == [f"p{i}->a->b"
                                           for i in range(4)]
        # ray_tpu_torch.get understands CompiledDAGRef
        assert ray_tpu_torch.get(dag.execute("z")) == "z->a->b"
    finally:
        dag.teardown()


def test_channel_dag_multi_output_and_fanout(ray_cluster):
    Stage = _stage_cls()
    a, b, m = Stage.remote("a"), Stage.remote("b"), Stage.remote("m")
    with InputNode() as inp:
        u = a.work.bind(inp)
        dag = MultiOutputNode([b.work.bind(u), m.work.bind(u)]
                              ).experimental_compile(
                                  enable_shm_channels=True)
    try:
        assert dag.execute("x").get() == ["x->a->b", "x->a->m"]
    finally:
        dag.teardown()


def test_channel_dag_error_propagates_and_pipeline_survives(ray_cluster):
    @ray_tpu_torch.remote
    class Flaky:
        def work(self, x):
            if x == "bad":
                raise ValueError("boom-x")
            return f"ok:{x}"

    f = Flaky.remote()
    with InputNode() as inp:
        dag = f.work.bind(inp).experimental_compile(
            enable_shm_channels=True)
    try:
        with pytest.raises(RuntimeError, match="boom-x"):
            dag.execute("bad").get()
        # the exec loop survives the error and keeps serving
        assert dag.execute("fine").get() == "ok:fine"
    finally:
        dag.teardown()


def test_channel_dag_capacity_and_teardown(ray_cluster):
    import os
    Stage = _stage_cls()
    a = Stage.remote("a")
    with InputNode() as inp:
        dag = a.work.bind(inp).experimental_compile(
            enable_shm_channels=True, buffer_size_bytes=1 << 12)
    try:
        with pytest.raises(ValueError, match="exceeds channel capacity"):
            dag.execute("y" * (1 << 13))
    finally:
        dag.teardown()
    # teardown unlinked the channel segments
    names = [n for n in os.listdir("/dev/shm") if "_ch_" in n]
    for ch in dag._channels.values():
        assert ch.name not in names


def test_channel_dag_raw_array_fast_path(ray_cluster):
    """Tensor channels: ndarrays and torch tensors ride a raw shm frame
    (one memcpy in, one out) instead of a pickle stream; tensors
    round-trip as tensors (reference torch_tensor_nccl_channel.py
    intent, over host bytes)."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Scale:
        def work(self, x):
            return x * 2.0

    @ray_tpu_torch.remote
    class Shift:
        def work(self, x):
            import torch
            return torch.as_tensor(x) + 1.0     # returns a torch.Tensor

    a, b = Scale.remote(), Shift.remote()
    with InputNode() as inp:
        out = b.work.bind(a.work.bind(inp))
    dag = out.experimental_compile(enable_shm_channels=True,
                                   buffer_size_bytes=8 << 20)
    try:
        x = np.arange(16384, dtype=np.float32).reshape(128, 128)
        # first get covers the actor's cold torch import
        got = dag.execute(x).get(timeout=240.0)
        for trial in range(2):              # slot reuse across executes
            got = dag.execute(x).get(timeout=60.0)
            expect = x * 2.0 + 1.0
            assert np.allclose(got.numpy(), expect)
        # the tensor type survives the channel hop back to the driver
        assert isinstance(got, torch.Tensor)
    finally:
        dag.teardown()


# ------------------------------------------------- collective nodes
def test_dag_allreduce_collective_nodes(ray_cluster):
    """allreduce_bind: per-actor shards reduce inside the DAG; each
    participant continues with the reduced value (reference aDAG
    collective nodes, torch_tensor_nccl_channel / collective ops)."""
    from ray_tpu_torch.dag import MultiOutputNode, allreduce_bind

    @ray_tpu_torch.remote
    class Shard:
        def __init__(self, scale):
            self.scale = scale

        def compute(self, x):
            return np.asarray(x, dtype=np.float64) * self.scale

        def tag(self, reduced):
            return (self.scale, np.asarray(reduced))

    actors = [Shard.remote(s) for s in (1.0, 2.0, 3.0)]
    with InputNode() as inp:
        shards = [a.compute.bind(inp) for a in actors]
        reduced = allreduce_bind(shards, op="sum")
        outs = [a.tag.bind(r) for a, r in zip(actors, reduced)]
        dag_out = MultiOutputNode(outs)

    dag = dag_out.experimental_compile()
    try:
        x = np.array([1.0, 10.0])
        for round_i in range(2):          # group reused across executes
            results = ray_tpu_torch.get(dag.execute(x + round_i), timeout=120)
            want = (x + round_i) * 6.0    # 1x + 2x + 3x
            scales = sorted(s for s, _ in results)
            assert scales == [1.0, 2.0, 3.0]
            for _s, arr in results:
                np.testing.assert_allclose(arr, want)
    finally:
        dag.teardown()

    # mixed ops + validation
    with pytest.raises(ValueError, match="distinct actors"):
        with InputNode() as inp:
            s0 = actors[0].compute.bind(inp)
            s1 = actors[0].compute.bind(inp)
            allreduce_bind([s0, s1])


def test_dag_allreduce_ops(ray_cluster):
    from ray_tpu_torch.dag import MultiOutputNode, allreduce_bind

    @ray_tpu_torch.remote
    class A:
        def __init__(self, v):
            self.v = v

        def emit(self, _):
            return np.array([self.v], dtype=np.float64)

    actors = [A.remote(v) for v in (4.0, 6.0)]
    for op, want in (("max", 6.0), ("mean", 5.0), ("prod", 24.0)):
        with InputNode() as inp:
            outs = allreduce_bind([a.emit.bind(inp) for a in actors],
                                  op=op)
            dag_out = MultiOutputNode(outs)
        dag = dag_out.experimental_compile()
        try:
            r = ray_tpu_torch.get(dag.execute(0), timeout=120)
            assert all(abs(float(arr[0]) - want) < 1e-9 for arr in r), (
                op, r)
        finally:
            dag.teardown()
