"""The port's trainer and data ingestion held to the JAX package on the CPU.

- `TorchTrainer`, one CPU worker, trains `tiny()` from the JAX package's
  parameters (`params_from_jax`) on seeded batches that reach it through
  a Dataset and `iter_torch_batches`; its reported losses and final
  parameters must match `jax.value_and_grad(Transformer.loss)` with
  `optax.adamw` over the same steps, computed here. The JAX model runs
  its plain attention, as its own CPU tests do.
- One Dataset pipeline (`from_numpy` → `map_batches` →
  `random_shuffle(seed)` → `iter_batches`) gives identical batches
  through both packages.
- A 2-worker gloo run of `tiny()` under DDP, each rank on half the
  batch, gives the losses and parameters of one process on the whole
  batch.

The runtime fixtures are this file's own, on the port's runtime.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu_torch import bench
from ray_tpu_torch import data as rd
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                 TorchTrainer)

STEPS, BATCH, SEQ = 3, 4, 32


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


def _tokens(seed: int = 3) -> np.ndarray:
    """STEPS batches of BATCH rows, one after another."""
    return np.random.default_rng(seed).integers(
        0, 256, (STEPS * BATCH, SEQ)).astype(np.int64)


def _jax_run(jparams, tokens):
    """`optax.adamw(1e-4)` on `jax.value_and_grad(Transformer.loss)`, one
    step a batch: the losses and the final parameters by port name."""
    jmodel = JTransformer(jtiny())
    opt = optax.adamw(1e-4)

    @jax.jit
    def step(p, st, toks):
        loss, g = jax.value_and_grad(jmodel.loss)(p, {"tokens": toks})
        updates, st = opt.update(g, st, p)
        return optax.apply_updates(p, updates), st, loss
    state = opt.init(jparams)
    losses = []
    for i in range(STEPS):
        toks = jnp.asarray(tokens[i * BATCH:(i + 1) * BATCH], jnp.int32)
        jparams, state, loss = step(jparams, state, toks)
        losses.append(float(loss))
    return losses, _by_name(jax.tree_util.tree_map(np.asarray, jparams))


def _by_name(tree) -> dict:
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for i in range(jtiny().n_layers):
        for n, arr in tree["layers"].items():
            out[f"layers.{i}.{n}"] = arr[i]
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    return out


def _port_by_name(params) -> dict:
    names = ["embed"]
    for i, layer in enumerate(params["layers"]):
        names.extend(f"layers.{i}.{n}" for n in layer)
    names.append("final_norm")
    if "lm_head" in params:
        names.append("lm_head")
    return dict(zip(names, bench.leaves(params)))


def make_tiny_loop():
    def loop(config):
        from ray_tpu_torch import bench as b
        from ray_tpu_torch import train as rt_train
        from ray_tpu_torch.models.config import tiny as t
        from ray_tpu_torch.models.convert import params_from_jax as p_f_j
        from ray_tpu_torch.models.transformer import Transformer as T
        from ray_tpu_torch.train import Checkpoint
        cfg = t()
        model = T(cfg)
        params = p_f_j(config["params"], cfg, device="cpu")
        opt = b.make_optimizer(params)
        shard = rt_train.get_dataset_shard("train")
        batches = shard.iter_torch_batches(batch_size=config["batch"],
                                           device="cpu")
        for i, batch in enumerate(batches):
            loss = b.train_step(model, params, opt, batch).item()
            ckpt = None
            if i == config["steps"] - 1:
                ckpt = Checkpoint.from_state(
                    rt_train.make_temp_checkpoint_dir(), {"params": params})
            rt_train.report({"loss": loss, "step": i}, ckpt)
    return loop


@pytest.mark.usefixtures("ray_cluster")
def test_torch_trainer_tiny_losses_match_optax(tmp_path):
    """Losses rtol 1e-5 and parameters atol 3e-6 after three steps, on
    the terms of `test_torch_train.py::test_three_adamw_steps_match_optax`,
    which holds `bench.train_step` in the calling process: f32 through 2
    layers, sum order only; Adam carries a near-zero grad's relative
    error into a step of up to the learning rate, 1e-4, and each of the
    three steps, on a batch of its own, may add 1% of it (1e-6)."""
    jparams = jax.jit(JTransformer(jtiny()).init)(jax.random.PRNGKey(0))
    tokens = _tokens()
    trainer = TorchTrainer(
        make_tiny_loop(),
        train_loop_config={
            "params": jax.tree_util.tree_map(np.asarray, jparams),
            "batch": BATCH, "steps": STEPS},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="parity", storage_path=str(tmp_path)),
        backend_config=TorchConfig(platform="cpu"),
        datasets={"train": rd.from_numpy({"tokens": tokens})})
    # the worker trains while this process compiles the JAX reference
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fitting = pool.submit(trainer.fit)
        want_losses, want_params = _jax_run(jparams, tokens)
        result = fitting.result(timeout=120)
    assert result.error is None
    assert [m["step"] for m in result.metrics_history] == list(range(STEPS))
    losses = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = _port_by_name(result.checkpoint.load_state()["params"])
    assert set(got) == set(want_params)
    for key, t in got.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), want_params[key], atol=3e-6,
                                   rtol=0, err_msg=key)


def test_dataset_pipeline_gives_identical_batches_in_both_packages():
    """from_numpy -> map_batches -> random_shuffle(seed) -> iter_batches:
    the same columns, rows and order through `ray_tpu.data` and
    `ray_tpu_torch.data` (both copies of one implementation, run
    locally or on whichever runtime is up)."""
    cols = {"x": np.arange(120), "y": np.arange(120) * 0.5}

    def scale(batch):
        return {"x": batch["x"] * 3, "y": batch["y"] + 1.0,
                "z": batch["x"] % 7}

    def batches(pkg):
        ds = (pkg.from_numpy(dict(cols), override_num_blocks=4)
              .map_batches(scale, batch_size=16)
              .random_shuffle(seed=11))
        return list(ds.iter_batches(batch_size=32, drop_last=False))

    got, want = batches(rd), batches(jdata)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    rows = np.concatenate([b["x"] for b in got])
    assert sorted(rows.tolist()) == list(range(0, 360, 3))
    assert rows.tolist() != sorted(rows.tolist())       # really shuffled


def make_ddp_loop():
    def loop(config):
        import torch
        import torch.distributed as dist
        from torch.nn.parallel import DistributedDataParallel

        from ray_tpu_torch import bench as b
        from ray_tpu_torch import train as rt_train
        from ray_tpu_torch.models.config import tiny as t
        from ray_tpu_torch.models.transformer import Transformer as T

        class LM(torch.nn.Module):
            """The port's params as one module's parameters, so DDP
            reduces their grads; forward is the loss."""

            def __init__(self, model, params):
                super().__init__()
                self.model = model
                self.params = {
                    "embed": torch.nn.Parameter(params["embed"]),
                    "layers": [{k: torch.nn.Parameter(v)
                                for k, v in layer.items()}
                               for layer in params["layers"]],
                    "final_norm": torch.nn.Parameter(params["final_norm"])}
                if "lm_head" in params:
                    self.params["lm_head"] = torch.nn.Parameter(
                        params["lm_head"])
                self.leaves = torch.nn.ParameterList(
                    b.leaves(self.params))

            def forward(self, tokens):
                return self.model.loss(self.params, {"tokens": tokens})

        cfg = t()
        model = T(cfg)
        lm = LM(model, model.init(0, device="cpu"))
        ddp = DistributedDataParallel(lm)
        opt = b.make_optimizer(lm.params)
        rank, world = dist.get_rank(), dist.get_world_size()
        tokens = torch.as_tensor(config["tokens"])
        half = config["batch"] // world
        for i in range(config["steps"]):
            rows = tokens[i * config["batch"]:(i + 1) * config["batch"]]
            opt.zero_grad(set_to_none=True)
            loss = ddp(rows[rank * half:(rank + 1) * half])
            loss.backward()                  # DDP averages the grads
            opt.step()
            whole = loss.detach().clone()
            dist.all_reduce(whole)
            rt_train.report({"loss": whole.item() / world, "step": i,
                             "embed_sum": lm.params["embed"].sum().item()})
    return loop


@pytest.mark.usefixtures("ray_cluster")
def test_ddp_two_gloo_workers_match_one_process(tmp_path):
    """Two gloo ranks under DDP, each on half of every batch, against
    `bench.train_step` on the whole batch in this process from the same
    init: the loss is a mean over equal token counts, so the ranks'
    mean is the whole batch's, and DDP's averaged grads are its grads.
    They differ only in the order f32 sums run: losses rtol 1e-5, the
    embedding's sum atol 1e-4 (8,192 entries moved by AdamW steps of
    ~1e-4)."""
    tokens = _tokens(seed=5)
    model = Transformer(tiny())
    params = model.init(0, device="cpu")
    opt = bench.make_optimizer(params)
    want, sums = [], []
    for i in range(STEPS):
        rows = torch.as_tensor(tokens[i * BATCH:(i + 1) * BATCH])
        want.append(bench.train_step(model, params, opt,
                                     {"tokens": rows}).item())
        sums.append(params["embed"].sum().item())
    result = TorchTrainer(
        make_ddp_loop(),
        train_loop_config={"tokens": tokens, "batch": BATCH,
                           "steps": STEPS},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ddp", storage_path=str(tmp_path)),
        backend_config=TorchConfig(distributed=True, platform="cpu"),
    ).fit()
    assert result.error is None
    got = [m["loss"] for m in result.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        [m["embed_sum"] for m in result.metrics_history], sums, atol=1e-4)
