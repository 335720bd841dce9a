"""One rank a card inside a worker's bundle (`gpus_per_worker`, `topology`).

A JAX worker drives every chip of its bundle; a PyTorch process drives
one card. So `ScalingConfig(num_workers=2, gpus_per_worker=2)` keeps the
JAX package's two bundles of two cards, and runs two ranks in each, each
pinned by the runtime to a card of its own: a process group of four,
world rank `bundle * 2 + local`.

On two simulated nodes of `GPU: 2` (no card is needed: the group runs
gloo with the cards hidden, `TorchConfig(platform="cpu")`):

- the group's ranks, nodes and pinned cards;
- one 3-step AdamW run of `tiny()` from the JAX package's seed-0
  parameters, each rank on a quarter of every batch, its losses held to
  the JAX package's one process over
  `ray_tpu.parallel.prepare_mesh(dp=4, devices=jax.devices()[:4])` (the
  forced CPU devices of `tests/conftest.py`), and the context and mesh
  hosts every rank saw in that run;
- the elastic configuration of two-card workers, whose bounds count
  workers, the refusal of a negative card count, and a Tune trial of
  two ranks.

The runtime fixtures are this file's own.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import ray_tpu_torch
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.parallel import prepare_mesh as jprepare_mesh
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.train import (ElasticConfig, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)
from ray_tpu_torch.train.worker_group import WorkerGroup

STEPS, BATCH, SEQ = 3, 8, 32


@pytest.fixture(scope="module")
def two_nodes():
    """A head with no card and two simulated nodes of two cards."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    c = Cluster(initialize_head=False)
    nodes = [c.add_node(num_cpus=2, num_gpus=2) for _ in range(2)]
    yield nodes
    ray_tpu_torch.shutdown()


def _tokens() -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, 256, (STEPS * BATCH, SEQ)).astype(np.int64)


def _jax_dp4_losses(jparams, tokens) -> list:
    """`optax.adamw(1e-4)` on `jax.value_and_grad(Transformer.loss)`, one
    process over a dp=4 mesh: parameters replicated, each batch's rows
    split over dp."""
    mesh = jprepare_mesh(dp=4, devices=jax.devices()[:4])
    rows, whole = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())
    jmodel = JTransformer(jtiny())
    opt = optax.adamw(1e-4)

    @jax.jit
    def step(p, st, toks):
        loss, g = jax.value_and_grad(jmodel.loss)(p, {"tokens": toks})
        updates, st = opt.update(g, st, p)
        return optax.apply_updates(p, updates), st, loss
    params = jax.device_put(jparams, whole)
    state = opt.init(params)
    losses = []
    for i in range(STEPS):
        toks = jax.device_put(
            jnp.asarray(tokens[i * BATCH:(i + 1) * BATCH], jnp.int32), rows)
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    return losses


def make_dp_loop():
    def loop(config):
        import os

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import bench as b
        from ray_tpu_torch import train as rt_train
        from ray_tpu_torch.models.config import tiny as t
        from ray_tpu_torch.models.convert import params_from_jax as p_f_j
        from ray_tpu_torch.models.transformer import Transformer as T
        from ray_tpu_torch.parallel import mesh as m
        # four ranks share this host's cores: each rank's full intra-op
        # pool spinning beside the others' slowed the run about 6-fold
        torch.set_num_threads(1)
        ctx = rt_train.get_context()
        rank, world = dist.get_rank(), dist.get_world_size()
        seen = [None] * world
        dist.all_gather_object(seen, {
            "rank": ctx.get_world_rank(), "local": ctx.get_local_rank(),
            "local_world": ctx.get_local_world_size(),
            "node_rank": ctx.get_node_rank(),
            "node": os.environ["RAY_TPU_NODE_ID"]})
        mesh = m.prepare_mesh(m.MeshSpec(dp=2, tp=2), device="cpu")
        tp_group = mesh["tp"].mesh.tolist()
        hosts = m._rank_hosts(world)
        cfg = t()
        model = T(cfg)
        params = p_f_j(config["params"], cfg, device="cpu")
        opt = b.make_optimizer(params)
        tokens = torch.as_tensor(config["tokens"])
        part = config["batch"] // world
        for i in range(config["steps"]):
            rows = tokens[i * config["batch"]:(i + 1) * config["batch"]]
            opt.zero_grad(set_to_none=True)
            loss = model.loss(params, {"tokens": rows[rank * part:
                                                      (rank + 1) * part]})
            loss.backward()
            for p in b.leaves(params):          # the mean of the ranks'
                dist.all_reduce(p.grad)         # grads is the batch's
                p.grad /= world
            opt.step()
            whole = loss.detach().clone()
            dist.all_reduce(whole)
            rt_train.report({"loss": whole.item() / world, "step": i,
                             "seen": seen, "hosts": hosts,
                             "tp_group": tp_group})
    return loop


@pytest.fixture(scope="module")
def four_rank_run(two_nodes, tmp_path_factory):
    """The 4-rank run, with the JAX reference computed meanwhile."""
    jparams = jax.jit(JTransformer(jtiny()).init)(jax.random.PRNGKey(0))
    tokens = _tokens()
    trainer = TorchTrainer(
        make_dp_loop(),
        train_loop_config={
            "params": jax.tree_util.tree_map(np.asarray, jparams),
            "tokens": tokens, "batch": BATCH, "steps": STEPS},
        scaling_config=ScalingConfig(num_workers=2, gpus_per_worker=2),
        run_config=RunConfig(name="local_ranks",
                             storage_path=str(tmp_path_factory.mktemp("r"))),
        backend_config=TorchConfig(distributed=True, platform="cpu"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fitting = pool.submit(trainer.fit)
        want = _jax_dp4_losses(jparams, tokens)
        result = fitting.result(timeout=120)
    return result, want


def test_two_workers_of_two_cards_run_four_pinned_ranks(two_nodes):
    """Bundle b runs world ranks 2b and 2b+1 on one node, each pinned to
    a card of the bundle's own: cards 0 and 1 on each node."""
    def placement():
        import os
        return {"node_id": os.environ["RAY_TPU_NODE_ID"],
                "cards": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "pid": os.getpid()}

    scaling = ScalingConfig(num_workers=2, gpus_per_worker=2)
    assert scaling.use_gpu and scaling.ranks_per_worker() == 2
    group = WorkerGroup.from_scaling(scaling)
    group.start()
    try:
        assert (group.num_workers, group.world_size) == (2, 4)
        where = group.run_on_all(placement)        # by world rank
    finally:
        group.shutdown()
    assert where[0]["node_id"] == where[1]["node_id"]
    assert where[2]["node_id"] == where[3]["node_id"]
    assert {where[0]["node_id"], where[2]["node_id"]} == set(two_nodes)
    assert sorted([where[0]["cards"], where[1]["cards"]]) == ["0", "1"]
    assert sorted([where[2]["cards"], where[3]["cards"]]) == ["0", "1"]
    assert len({p["pid"] for p in where}) == 4


def test_each_rank_knows_its_local_rank_and_node(four_rank_run, two_nodes):
    result, _ = four_rank_run
    assert result.error is None, result.error
    seen = result.metrics["seen"]
    assert [s["rank"] for s in seen] == [0, 1, 2, 3]
    assert [s["local"] for s in seen] == [0, 1, 0, 1]
    assert [s["local_world"] for s in seen] == [2, 2, 2, 2]
    assert [s["node_rank"] for s in seen] == [0, 0, 1, 1]
    nodes = [s["node"] for s in seen]
    assert nodes[0] == nodes[1] and nodes[2] == nodes[3]
    assert set(nodes) == set(two_nodes)


def test_mesh_counts_the_trainers_nodes_as_hosts(four_rank_run):
    """The two simulated nodes share this machine, but the mesh sees two
    hosts, and tp stays within each node's ranks."""
    result, _ = four_rank_run
    assert result.error is None, result.error
    hosts = result.metrics["hosts"]
    assert len(set(hosts)) == 2 and hosts[0] == hosts[1]
    assert sorted(result.metrics["tp_group"]) == [0, 1]   # rank 0's


def test_four_ranks_match_the_jax_dp4_mesh(four_rank_run):
    """Losses within rtol 1e-5 of the JAX package's one process on a
    dp=4 mesh: f32 through 2 layers from the same parameters, the same
    rows and AdamW; the loss is a mean over equal token counts, so the
    ranks' mean is the batch's, and the mean of their grads is its
    grad. Only the order of f32 sums differs."""
    result, want = four_rank_run
    assert result.error is None, result.error
    assert [m["step"] for m in result.metrics_history] == list(range(STEPS))
    got = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_elastic_accepts_workers_of_several_cards():
    """An elastic group of two-card workers runs two ranks a worker, and
    its bounds count workers (bundles), not ranks: a floor above the
    worker count is refused even though it is below the rank count."""
    s = ScalingConfig(num_workers=2, gpus_per_worker=2,
                      elastic=ElasticConfig(min_workers=1, max_workers=2))
    assert s.ranks_per_worker() == 2
    assert s.worker_resources()["GPU"] == 2.0
    assert (s.num_workers, s.elastic.min_workers,
            s.elastic.max_workers) == (2, 1, 2)
    with pytest.raises(ValueError, match="min_workers=3"):
        ScalingConfig(num_workers=2, gpus_per_worker=2,
                      elastic=ElasticConfig(min_workers=3))
    with pytest.raises(ValueError, match="gpus_per_worker"):
        ScalingConfig(num_workers=2, gpus_per_worker=-1)
    # one card a worker stays elastic, one rank a worker
    s = ScalingConfig(num_workers=2, gpus_per_worker=1,
                      elastic=ElasticConfig())
    assert s.ranks_per_worker() == 1


def test_ranks_per_worker_follows_the_bundle():
    assert ScalingConfig(num_workers=3).ranks_per_worker() == 1
    assert ScalingConfig(num_workers=3, use_gpu=True).ranks_per_worker() == 1
    assert ScalingConfig(num_workers=3,
                         gpus_per_worker=4).ranks_per_worker() == 4
    s = ScalingConfig(topology="h100-16")
    assert (s.num_workers, s.ranks_per_worker()) == (2, 8)
    assert s.worker_resources()["GPU"] == 8.0


def test_tune_trial_of_a_two_card_worker_runs_two_ranks(two_nodes,
                                                         tmp_path):
    """A Tune trial of `gpus_per_worker=2` runs its two ranks through the
    same worker group as TorchTrainer."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.tuner import TuneConfig

    def loop(config):
        from ray_tpu_torch import train as rt_train
        ctx = rt_train.get_context()
        rt_train.report({"loss": config["x"], "world": ctx.get_world_size(),
                         "local_world": ctx.get_local_world_size()})

    trainer = TorchTrainer(
        loop, train_loop_config={"x": 0.0},
        scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=2),
        backend_config=TorchConfig(distributed=False, platform="cpu"))
    grid = tune.Tuner(
        trainer, param_space={"x": tune.grid_search([1.0])},
        tune_config=TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(name="tune_ranks", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0, [t.error for t in grid.trials]
    best = grid.get_best_result()
    assert (best.metrics["world"], best.metrics["local_world"]) == (2, 2)
