"""Elastic training with workers of several cards.

`ScalingConfig(num_workers=2, gpus_per_worker=2,
elastic=ElasticConfig(...))`: each worker is a bundle of two cards that
runs two ranks, one a card, each pinned by the runtime to a card of its
own (world rank `bundle * 2 + local`, as `TorchTrainer`'s group). The
elastic bounds count bundles, as the JAX package counts hosts, so the
group shrinks and grows by whole bundles: a lost node takes its two
ranks with it, a joining one brings two.

On simulated nodes of `GPU: 2` under a head with no card (no card is
needed: the numpy loops never touch CUDA, and the model's loop runs gloo
with the cards hidden, `TorchConfig(platform="cpu")`):

- (a) a node lost mid-run: every step once and in order, `world` 4
  before the loss and 2 after it, each bundle's two ranks on one node
  with distinct cards and local ranks 0 and 1, the survivor's cards
  back in its pool;
- (b) a node joining: 2 ranks grow to 4;
- (c) the dataset's resplit: each group's ranks read every row once;
- a rank's own error stays the user's failure, while a survivor's error
  after its peers' node died (as a gloo collective fails) reshapes;
- (d) the same node loss through the JAX package, two chips a worker:
  equal `(step, loss)` histories, the port's `world` twice the JAX one;
- (e) `tiny()` trained from the JAX package's seed-0 parameters with
  AdamW state in the checkpoint, shrinking from 4 ranks to 2, every
  step's loss held to the JAX package's one process on a dp=4 mesh
  (`slow`: two groups of fresh rank processes import torch), and its
  fast sibling: the same numerics, 4 ranks then 2 through a checkpoint,
  on a pool of gloo ranks (`tests/torch_ranks.py`).

The runtime fixtures are this file's own.
"""
import concurrent.futures
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import chaos
import ray_tpu_torch
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.parallel import prepare_mesh as jprepare_mesh
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.train import (ElasticConfig, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)
from torch_ranks import RankPool

CARDS = 2                       # cards a node, and a worker's bundle
ROWS = 24                       # dataset rows, read once a group


@pytest.fixture(scope="module", autouse=True)
def _own_tmpdir_and_runtime_down(tmp_path_factory):
    """A temp directory for this module's workers (a worker killed with
    its node may leave its `rtt_ckpt_*` dir behind), and the runtime
    down at the module's end."""
    prev = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = str(tmp_path_factory.mktemp("worker_tmp"))
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    if prev is None:
        os.environ.pop("TMPDIR", None)
    else:
        os.environ["TMPDIR"] = prev


@pytest.fixture()
def fast_heartbeat():
    """1 s death detection, in both packages' configs."""
    from ray_tpu._private.config import CONFIG as JAX_CONFIG
    prev = os.environ.get("RAY_TPU_HEARTBEAT_TIMEOUT_S")
    os.environ["RAY_TPU_HEARTBEAT_TIMEOUT_S"] = "1.0"
    CONFIG.reload()
    JAX_CONFIG.reload()
    yield
    if prev is None:
        os.environ.pop("RAY_TPU_HEARTBEAT_TIMEOUT_S", None)
    else:
        os.environ["RAY_TPU_HEARTBEAT_TIMEOUT_S"] = prev
    CONFIG.reload()
    JAX_CONFIG.reload()


def _head(package: str):
    """A fresh runtime of `package` whose head holds one CPU and no
    accelerator: every worker bundle lands on an added node."""
    import importlib
    pkg = importlib.import_module(package)
    if pkg.is_initialized():
        pkg.shutdown()
    if package == "ray_tpu_torch":
        return pkg, pkg.init(num_cpus=1, num_gpus=0)
    return pkg, pkg.init(num_cpus=1)


def _node(rt, package: str) -> str:
    """A simulated node of CARDS cards (`GPU` for the port, `TPU` for
    the JAX package)."""
    accel = "GPU" if package == "ray_tpu_torch" else "TPU"
    return rt.cluster.add_node({"CPU": 2.0, accel: float(CARDS)}).node_id


def make_bundle_loop(package: str):
    """The numpy loop of `test_torch_elastic.py::_shrink_history` for
    `package`: state (w, step), a loss that is a pure function of w, a
    checkpoint from rank 0 each step. With `config["log"]` each rank
    also appends, when its loop starts, its ranks, node, pinned cards
    and the rows of its dataset shard (`config["rows"]`) to that file;
    with `config["fail"]` = (rank, step) that rank raises at that step.
    With `config["peers"]` (a directory) the ranks stand in for a
    collective: each writes its pid there, and raises at a step's start
    once a peer's process is gone, as a gloo collective fails when its
    peer closed the connection."""
    def loop(config):
        import importlib as _il
        import json as _json
        import os as _os
        import time as _t

        import numpy as _np
        rt_train = _il.import_module(package + ".train")
        ctx = rt_train.get_context()
        if config.get("log"):
            rows = None
            if config.get("rows"):
                rows = [int(v) for b in rt_train.get_dataset_shard(
                    "train").iter_batches(batch_size=5) for v in b["id"]]
            line = _json.dumps({
                "world": ctx.get_world_size(), "rank": ctx.get_world_rank(),
                "local": ctx.get_local_rank(),
                "local_world": ctx.get_local_world_size(),
                "node_rank": ctx.get_node_rank(),
                "node": _os.environ.get("RAY_TPU_NODE_ID"),
                "cards": _os.environ.get("CUDA_VISIBLE_DEVICES"),
                "pid": _os.getpid(), "rows": rows})
            with open(config["log"], "a") as f:
                f.write(line + "\n")
        peers = []
        if config.get("peers"):
            world = ctx.get_world_size()
            mine = _os.path.join(config["peers"],
                                 f"{world}_{ctx.get_world_rank()}")
            with open(mine + ".tmp", "w") as f:
                f.write(str(_os.getpid()))
            _os.replace(mine + ".tmp", mine)
            peers = [_os.path.join(config["peers"], f"{world}_{r}")
                     for r in range(world)]

        def peer_gone() -> bool:
            for path in peers:
                while not _os.path.exists(path):
                    _t.sleep(0.01)
                with open(path) as f:
                    pid = int(f.read())
                try:
                    with open(f"/proc/{pid}/stat") as f:
                        if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                            return True
                except OSError:
                    return True
            return False
        state = {"w": _np.float64(0.0), "step": _np.int64(-1)}
        restored = rt_train.get_checkpoint()
        if restored is not None:
            state = restored.load_state()
        for step in range(int(state["step"]) + 1, config["steps"]):
            _t.sleep(config["step_time"])
            if config.get("fail") == [ctx.get_world_rank(), step]:
                raise ValueError(f"the loop's own error at step {step}")
            if peer_gone():
                raise RuntimeError("a peer's process is gone")
            w = float(state["w"]) + 1.0
            state = {"w": _np.float64(w), "step": _np.int64(step)}
            ckpt = None
            if (ctx.get_world_rank() == 0
                    and rt_train.should_checkpoint(step)):
                d = rt_train.make_temp_checkpoint_dir()
                ckpt = rt_train.Checkpoint.from_state(d, state)
            rt_train.report({"loss": 1.0 / (1.0 + w), "step": step,
                             "world": ctx.get_world_size()}, ckpt)
    return loop


def _fit(package: str, tmp_path, name: str, *, steps: int, log=None,
         datasets=None, fail=None, peers=None):
    """Two elastic workers of CARDS cards (min 1, max 2) of `package`
    over the numpy loop, no failure retried; the fit's Result."""
    import importlib
    train = importlib.import_module(package + ".train")
    if package == "ray_tpu_torch":
        trainer_cls, backend = train.TorchTrainer, train.TorchConfig
        scaling = train.ScalingConfig(
            num_workers=2, gpus_per_worker=CARDS,
            elastic=train.ElasticConfig(min_workers=1, max_workers=2))
    else:
        trainer_cls, backend = train.JaxTrainer, train.JaxConfig
        scaling = train.ScalingConfig(
            num_workers=2, resources_per_worker={"CPU": 1, "TPU": CARDS},
            elastic=train.ElasticConfig(min_workers=1, max_workers=2))
    config = {"steps": steps, "step_time": 0.1, "fail": fail,
              "peers": peers}
    if log is not None:
        config.update(log=str(log), rows=datasets is not None)
    return trainer_cls(
        make_bundle_loop(package), train_loop_config=config,
        scaling_config=scaling,
        run_config=train.RunConfig(
            name=name, storage_path=str(tmp_path),
            failure_config=train.FailureConfig(max_failures=0)),
        backend_config=backend(distributed=False),
        **({"datasets": datasets} if datasets else {})).fit()


def _shrink(package: str, tmp_path, name: str, steps: int = 5, log=None,
            datasets=None) -> tuple:
    """Two nodes of CARDS cards, two elastic workers, the second node
    killed once two checkpoints are registered: the fit's Result and,
    for the port, each node's card pool after the runtime's work."""
    pkg, rt = _head(package)
    try:
        nodes = [_node(rt, package) for _ in range(2)]
        ckpt_dir = os.path.join(str(tmp_path), name, "checkpoints")
        chaos.when(lambda: len(os.listdir(ckpt_dir)) >= 2,
                   chaos.kill_node, rt.cluster, nodes[1])
        result = _fit(package, tmp_path, name, steps=steps, log=log,
                      datasets=datasets)
        pools = {}
        if package == "ray_tpu_torch":
            survivor = rt.cluster.get_node(nodes[0]).scheduler
            chaos.wait_for(lambda: survivor._cards.free
                           == {i: 1.0 for i in range(CARDS)}, 10)
            pools = {nodes[0]: dict(survivor._cards.free)}
    finally:
        pkg.shutdown()
    assert result.error is None, result.error
    return result, pools, nodes


def _groups(log) -> list:
    """The log's loop starts cut into groups: each group's ranks start
    together, and a group starts only after the one before it ended."""
    with open(log) as f:
        starts = [json.loads(line) for line in f]
    groups = []
    while starts:
        world = starts[0]["world"]
        group = sorted(starts[:world], key=lambda s: s["rank"])
        assert [s["rank"] for s in group] == list(range(world)), starts
        groups.append(group)
        starts = starts[world:]
    return groups


def _assert_bundles(group: list) -> None:
    """Bundle b holds world ranks 2b and 2b+1 on one node, local ranks
    0 and 1 of 2 on cards "0" and "1"; the bundles are on distinct
    nodes, and every rank is a process of its own."""
    assert len(group) % CARDS == 0
    bundles = [group[b:b + CARDS] for b in range(0, len(group), CARDS)]
    for b, ranks in enumerate(bundles):
        assert len({r["node"] for r in ranks}) == 1, ranks
        assert [r["local"] for r in ranks] == list(range(CARDS)), ranks
        assert {r["local_world"] for r in ranks} == {CARDS}, ranks
        assert {r["node_rank"] for r in ranks} == {b}, ranks
        assert sorted(r["cards"] for r in ranks) == ["0", "1"], ranks
    assert len({r[0]["node"] for r in bundles}) == len(bundles)
    assert len({r["pid"] for r in group}) == len(group)


@pytest.fixture(scope="module")
def shrink_run(tmp_path_factory):
    """(a) and (c)'s run: the port's shrink with a dataset of ROWS rows
    and every rank's start logged. Death detection at 1 s, as
    `fast_heartbeat` (module scope, so set here)."""
    from ray_tpu_torch import data as rd
    tmp = tmp_path_factory.mktemp("shrink")
    prev = os.environ.get("RAY_TPU_HEARTBEAT_TIMEOUT_S")
    os.environ["RAY_TPU_HEARTBEAT_TIMEOUT_S"] = "1.0"
    CONFIG.reload()
    try:
        log = tmp / "starts.jsonl"
        ds = rd.range(ROWS, override_num_blocks=4)
        result, pools, nodes = _shrink("ray_tpu_torch", tmp, "shrink",
                                       log=log, datasets={"train": ds})
    finally:
        if prev is None:
            os.environ.pop("RAY_TPU_HEARTBEAT_TIMEOUT_S", None)
        else:
            os.environ["RAY_TPU_HEARTBEAT_TIMEOUT_S"] = prev
        CONFIG.reload()
    return result, pools, nodes, _groups(log)


def test_shrink_by_a_whole_bundle_on_node_loss(shrink_run):
    """(a) Four ranks on two nodes; the second node dies once two
    checkpoints are registered, and its two ranks leave together: the
    group goes on with the surviving bundle's two ranks, restored from
    the latest checkpoint. Every step once and in order; `world` 4
    before the loss and 2 after it; the survivor's two cards back in
    its pool once the run is over."""
    result, pools, nodes, groups = shrink_run
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(5))
    worlds = [m["world"] for m in hist]
    assert worlds[0] == 4 and worlds[-1] == 2, worlds
    assert worlds == sorted(worlds, reverse=True), worlds
    assert [m["loss"] for m in hist] == [1.0 / (2.0 + k) for k in range(5)]
    el = result.artifacts["elastic"]
    assert el["reshapes"] >= 1 and el["restores"] >= 1
    assert el["final_world_size"] == 1          # workers: bundles
    assert [len(g) for g in groups] == [4, 2]
    for group in groups:
        _assert_bundles(group)
    assert {r["node"] for r in groups[0]} == set(nodes)
    assert {r["node"] for r in groups[1]} == {nodes[0]}
    assert pools == {nodes[0]: {i: 1.0 for i in range(CARDS)}}


def test_resplit_reads_every_row_once_per_group(shrink_run):
    """(c) The datasets split over ranks, not bundles: in the group of
    four and again in the group of two, the ranks' shards together
    hold every row exactly once, and `_dataset_shards` stays a pure
    function of the rank count."""
    import cloudpickle

    from ray_tpu_torch import data as rd
    *_, groups = shrink_run
    for group in groups:
        rows = [v for r in group for v in r["rows"]]
        assert sorted(rows) == list(range(ROWS)), group
        assert all(r["rows"] for r in group), group
    trainer = TorchTrainer(
        lambda config: None,
        scaling_config=ScalingConfig(num_workers=2, gpus_per_worker=CARDS,
                                     elastic=ElasticConfig()),
        datasets={"train": rd.range(ROWS, override_num_blocks=4)})

    def shards(n):
        return [sorted(int(r["id"]) for r in
                       cloudpickle.loads(b)["train"].take_all())
                for b in trainer._dataset_shards(n)]
    assert shards(4) == shards(4)
    for n in (4, 2):
        got = shards(n)
        assert len(got) == n and all(got)
        assert sorted(v for s in got for v in s) == list(range(ROWS))


def test_grow_by_a_whole_bundle_on_node_join(fast_heartbeat, tmp_path):
    """(b) One node of two cards runs one bundle of two ranks; a second
    node joins once two checkpoints are registered, and the group grows
    to two bundles of two ranks, every step once and in order."""
    pkg, rt = _head("ray_tpu_torch")
    log = tmp_path / "starts.jsonl"
    try:
        first = _node(rt, "ray_tpu_torch")
        ckpt_dir = os.path.join(str(tmp_path), "grow", "checkpoints")
        joined = []
        chaos.when(lambda: len(os.listdir(ckpt_dir)) >= 2,
                   lambda: joined.append(_node(rt, "ray_tpu_torch")))
        result = _fit("ray_tpu_torch", tmp_path, "grow", steps=8, log=log)
    finally:
        pkg.shutdown()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(8))
    assert hist[0]["world"] == 2 and hist[-1]["world"] == 4
    el = result.artifacts["elastic"]
    assert el["reshapes"] >= 1 and el["final_world_size"] == 2
    groups = _groups(log)
    assert [len(g) for g in groups] == [2, 4]
    for group in groups:
        _assert_bundles(group)
    assert {r["node"] for r in groups[0]} == {first}
    assert {r["node"] for r in groups[1]} == {first, *joined}


def test_a_ranks_own_error_is_the_users_failure(fast_heartbeat, tmp_path):
    """A rank of a two-card bundle that raises on its own, with every
    node alive, is the user's failure (`max_failures=0`: the fit ends
    with it), not a lost peer: no reshape, no restore."""
    pkg, rt = _head("ray_tpu_torch")
    try:
        for _ in range(2):
            _node(rt, "ray_tpu_torch")
        result = _fit("ray_tpu_torch", tmp_path, "own_error", steps=5,
                      fail=[1, 2])
    finally:
        pkg.shutdown()
    assert result.error is not None
    assert "the loop's own error at step 2" in str(result.error)
    el = result.artifacts["elastic"]
    assert (el["reshapes"], el["restores"]) == (0, 0)
    assert [m["step"] for m in result.metrics_history] == [0, 1]


def test_a_survivors_error_after_its_peers_died_is_a_reshape(
        fast_heartbeat, tmp_path, caplog):
    """The node of ranks 2 and 3 dies once two checkpoints are
    registered, and ranks 0 and 1 raise on their own at their next step
    (as a gloo collective fails when its peer is gone), before the dead
    ranks' ActorError reaches the trainer. The loop finds the lost node
    and reshapes to the surviving bundle instead of counting the user's
    failure (`max_failures=0`)."""
    pkg, rt = _head("ray_tpu_torch")
    log, peers = tmp_path / "starts.jsonl", tmp_path / "peers"
    peers.mkdir()

    def kill_ranks_2_and_3():
        with open(log) as f:
            node = next(r["node"] for r in map(json.loads, f)
                        if r["rank"] == 2)
        chaos.kill_node(rt.cluster, node)
    try:
        for _ in range(2):
            _node(rt, "ray_tpu_torch")
        ckpt_dir = os.path.join(str(tmp_path), "survivor", "checkpoints")
        chaos.when(lambda: len(os.listdir(ckpt_dir)) >= 2,
                   kill_ranks_2_and_3)
        with caplog.at_level("WARNING", logger="ray_tpu_torch.train.elastic"):
            result = _fit("ray_tpu_torch", tmp_path, "survivor", steps=5,
                          log=log, peers=str(peers))
    finally:
        pkg.shutdown()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(5))
    assert hist[0]["world"] == 4 and hist[-1]["world"] == 2
    assert "a rank failed after its group lost a peer" in caplog.text
    assert "a peer's process is gone" in caplog.text
    assert [len(g) for g in _groups(log)] == [4, 2]


def test_bundle_shrink_matches_the_jax_package(fast_heartbeat, shrink_run,
                                               tmp_path):
    """(d) The node loss of (a) through the JAX package, whose workers
    each take two chips of a `TPU: 2` node (`resources_per_worker`):
    the two `(step, loss)` histories are equal, and the port's `world`
    (ranks) is twice the JAX package's (processes, one a worker) at
    the first step and at the last. When the death lands between steps
    is timing, so the steps between are held only to each package's
    own order."""
    port = shrink_run[0].metrics_history
    jax_result, _, _ = _shrink("ray_tpu", tmp_path, "jax_shrink")
    jhist = jax_result.metrics_history
    assert ([(m["step"], m["loss"]) for m in port]
            == [(m["step"], m["loss"]) for m in jhist])
    assert jax_result.artifacts["elastic"]["final_world_size"] == 1
    for i in (0, -1):
        assert port[i]["world"] == CARDS * jhist[i]["world"]
    assert [jhist[0]["world"], jhist[-1]["world"]] == [2, 1]


# ----------------------------------------------- the model's numerics
STEPS, BATCH, SEQ = 6, 8, 32
RESPLIT_AT = 3                  # the sibling's first step on two ranks


def _tokens() -> np.ndarray:
    return np.random.default_rng(11).integers(
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


def _model_config(jparams, tokens, stop: int = STEPS) -> dict:
    return {"params": jax.tree_util.tree_map(np.asarray, jparams),
            "tokens": tokens, "batch": BATCH, "stop": stop,
            "step_time": 0.1}


def model_run(config: dict, restored, on_step) -> None:
    """This rank's part of training `tiny()` from the JAX seed-0
    parameters with AdamW: each step's batch split evenly over the
    ranks of the process group, the ranks' grads averaged over it.
    Starts after `restored`'s step (its parameters and optimizer state)
    or at 0, and runs to `config["stop"]`; after each step calls
    `on_step(step, the ranks' mean loss, state)`, where `state()` gives
    the parameters, the optimizer's state and the step to checkpoint."""
    import time as _t

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import bench as b
    from ray_tpu_torch.models.config import tiny as t
    from ray_tpu_torch.models.convert import params_from_jax as p_f_j
    from ray_tpu_torch.models.transformer import Transformer as T
    torch.set_num_threads(1)        # the ranks share this host's cores
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = t()
    model = T(cfg)
    params = p_f_j(config["params"], cfg, device="cpu")
    opt = b.make_optimizer(params)
    start = 0
    if restored is not None:
        with torch.no_grad():
            for p, s in zip(b.leaves(params), b.leaves(restored["params"])):
                p.copy_(torch.as_tensor(s))
        opt.load_state_dict(restored["opt"])
        start = int(restored["step"]) + 1
    tokens = torch.as_tensor(config["tokens"])
    part = config["batch"] // world
    for i in range(start, config["stop"]):
        _t.sleep(config["step_time"])
        rows = tokens[i * config["batch"]:(i + 1) * config["batch"]]
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, {"tokens": rows[rank * part:
                                                  (rank + 1) * part]})
        loss.backward()
        for p in b.leaves(params):
            dist.all_reduce(p.grad)
            p.grad /= world
        opt.step()
        whole = loss.detach().clone()
        dist.all_reduce(whole)
        on_step(i, whole.item() / world, lambda: {
            "params": params, "opt": opt.state_dict(), "step": i})


def model_loop(config):
    """(e)'s `train_loop_per_worker`: `model_run` under the elastic
    trainer, resumed from `get_checkpoint()`, rank 0 checkpointing every
    step."""
    import torch.distributed as dist

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.train import Checkpoint
    ckpt = rt_train.get_checkpoint()
    restored = ckpt.load_state() if ckpt is not None else None
    rank, world = dist.get_rank(), dist.get_world_size()

    def on_step(i, loss, state):
        saved = None
        if rank == 0 and rt_train.should_checkpoint(i):
            saved = Checkpoint.from_state(
                rt_train.make_temp_checkpoint_dir(), state())
        rt_train.report({"loss": loss, "step": i, "world": world,
                         "restored": restored is not None}, saved)
    model_run(config, restored, on_step)


def resplit_part(config: dict, ckpt_dir: str, restore: bool) -> list:
    """(e)'s fast sibling on a pool rank: `model_run` to
    `config["stop"]`, rank 0 then checkpointing the state to `ckpt_dir`;
    or, with `restore`, from that checkpoint on. The ranks' mean loss of
    each step."""
    import torch.distributed as dist

    from ray_tpu_torch.train import Checkpoint
    restored = Checkpoint(ckpt_dir).load_state() if restore else None
    losses = []

    def on_step(i, loss, state):
        losses.append(loss)
        if (not restore and dist.get_rank() == 0
                and i == config["stop"] - 1):
            Checkpoint.from_state(ckpt_dir, state())
    model_run(config, restored, on_step)
    return losses


@pytest.mark.slow
def test_model_losses_across_a_shrink_match_the_jax_dp4_mesh(
        fast_heartbeat, tmp_path):
    """(e) Four gloo ranks on two nodes train `tiny()` (2 layers, f32);
    the second node dies once two checkpoints are registered, and two
    ranks resume from the latest one, parameters and AdamW state. Every
    step's loss, before and after the restore, is within rtol 1e-5 of
    the JAX package's one process on a dp=4 mesh from the same
    parameters and rows: the loss is a mean over equal token counts,
    so the mean of the ranks' grads is the batch's at 4 ranks and at 2,
    and the restore is exact; only the order of f32 sums differs.
    `slow`: ~16 s, two groups whose every rank imports torch in a fresh
    process (~3 s each here); its fast sibling below runs the same
    numerics on a pool of ranks."""
    import cloudpickle
    jparams = jax.jit(JTransformer(jtiny()).init)(jax.random.PRNGKey(0))
    tokens = _tokens()
    pkg, rt = _head("ray_tpu_torch")
    module = sys.modules[__name__]
    try:
        nodes = [_node(rt, "ray_tpu_torch") for _ in range(2)]
        ckpt_dir = os.path.join(str(tmp_path), "model", "checkpoints")
        chaos.when(lambda: len(os.listdir(ckpt_dir)) >= 2,
                   chaos.kill_node, rt.cluster, nodes[1])
        trainer = TorchTrainer(
            model_loop, train_loop_config=_model_config(jparams, tokens),
            scaling_config=ScalingConfig(
                num_workers=2, gpus_per_worker=CARDS,
                elastic=ElasticConfig(min_workers=1, max_workers=2)),
            run_config=RunConfig(name="model", storage_path=str(tmp_path)),
            backend_config=TorchConfig(distributed=True, platform="cpu"))
        # the workers do not import this module: its functions travel
        # by value, as the rank pool sends them
        cloudpickle.register_pickle_by_value(module)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fitting = pool.submit(trainer.fit)
            want = _jax_dp4_losses(jparams, tokens)
            result = fitting.result(timeout=120)
    finally:
        cloudpickle.unregister_pickle_by_value(module)
        pkg.shutdown()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(STEPS))
    worlds = [m["world"] for m in hist]
    assert worlds[0] == 4 and worlds[-1] == 2, worlds
    assert hist[-1]["restored"]                 # the 2 ranks restored
    assert result.artifacts["elastic"]["restores"] >= 1
    np.testing.assert_allclose([m["loss"] for m in hist], want, rtol=1e-5)


@pytest.fixture(scope="module")
def rank_pool():
    pool = RankPool(4)
    yield pool
    pool.close()


def test_model_losses_across_a_resplit_match_the_jax_dp4_mesh(rank_pool,
                                                              tmp_path):
    """(e)'s fast sibling, without the runtime: four gloo ranks of a pool
    run `model_run` for steps 0-2 and rank 0 checkpoints the parameters
    and AdamW state through the port's `Checkpoint`; two ranks restore
    it and run steps 3-5 on half of each batch. Every loss within rtol
    1e-5 of the JAX package's dp=4 mesh, as in (e)."""
    jparams = jax.jit(JTransformer(jtiny()).init)(jax.random.PRNGKey(0))
    tokens = _tokens()
    want = _jax_dp4_losses(jparams, tokens)
    ckpt = str(tmp_path / "ckpt")
    four = rank_pool.run(4, resplit_part,
                         _model_config(jparams, tokens, RESPLIT_AT) |
                         {"step_time": 0.0}, ckpt, False)
    two = rank_pool.run(2, resplit_part,
                        _model_config(jparams, tokens) | {"step_time": 0.0},
                        ckpt, True)
    assert all(r == four[0] for r in four) and two[0] == two[1]
    assert len(four[0]) == RESPLIT_AT and len(two[0]) == STEPS - RESPLIT_AT
    np.testing.assert_allclose(four[0] + two[0], want, rtol=1e-5)
