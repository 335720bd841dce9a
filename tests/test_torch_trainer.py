"""TorchTrainer end-to-end tests (CPU workers, real multiprocess actors):
the twin of `tests/test_train.py`, test for test, on the port.

The optax-state case becomes a torch AdamW `state_dict` round trip, the
orbax cases use `torch.distributed.checkpoint`, the jax.distributed case
is a 2-worker gloo `all_reduce` (`platform="cpu"`), and the slow
real-model case is `tests/test_torch_trainer_parity.py`'s parity test.
The runtime fixtures are this file's own: `ray_cluster` reuses a live
port runtime, `fresh_cluster` starts an isolated one.
"""
import os
from typing import Any, NamedTuple

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import train as rt_train
from ray_tpu_torch.train import (Checkpoint, CheckpointConfig,
                                 CheckpointManager, FailureConfig, RunConfig,
                                 ScalingConfig, TorchConfig, TorchTrainer)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


@pytest.fixture()
def fresh_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    yield rt
    ray_tpu_torch.shutdown()


class Pair(NamedTuple):
    a: Any
    b: Any


def test_checkpoint_roundtrip(tmp_path):
    state = {"w": np.arange(6.0).reshape(2, 3), "step": np.int64(7)}
    ckpt = Checkpoint.from_state(str(tmp_path / "c1"), state,
                                 metadata={"step": 7})
    loaded = ckpt.load_state()
    np.testing.assert_allclose(loaded["w"], state["w"])
    assert loaded["step"] == 7
    assert ckpt.metadata() == {"step": 7}


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "mgr"), num_to_keep=2)
    paths = []
    for i in range(4):
        c = Checkpoint.from_state(str(tmp_path / f"tmp{i}"),
                                  {"i": np.int64(i)})
        managed = mgr.register(c, {"loss": 10.0 - i})
        paths.append(managed.path)
    assert len(mgr.checkpoints()) == 2
    # latest survives
    assert mgr.latest is not None
    assert int(mgr.latest.load_state()["i"]) == 3


def test_checkpoint_manager_best_score(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "mgr"), num_to_keep=2,
                            score_attribute="acc", score_order="max")
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        c = Checkpoint.from_state(str(tmp_path / f"t{i}"),
                                  {"acc": np.float64(acc)})
        mgr.register(c, {"acc": acc})
    accs = sorted(float(c.load_state()["acc"]) for c in mgr.checkpoints())
    assert accs == [0.5, 0.9]  # 0.1 evicted
    assert float(mgr.best.load_state()["acc"]) == 0.9


def test_pytree_scalar_nonbuiltin_dtypes(tmp_path):
    """0-d bfloat16/fp8 leaves crashed the r2 encoder (VERDICT weak 5b):
    a 0-d tensor can't be viewed as bytes. numpy has no bf16 or fp8, so
    such tensors ride as raw bytes with a dtype tag."""
    import torch

    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
    tree = {"s": torch.tensor(1.5, dtype=torch.bfloat16),
            "v": torch.arange(4, dtype=torch.bfloat16),
            "e": torch.tensor([0.5, -2.0], dtype=torch.float8_e4m3fn),
            "f": np.float32(2.0)}
    save_pytree(tree, str(tmp_path / "p"))
    back = load_pytree(str(tmp_path / "p"))
    assert back["s"].shape == () and back["s"].dtype == torch.bfloat16
    assert float(back["s"]) == 1.5
    assert back["v"].dtype == torch.bfloat16
    np.testing.assert_allclose(back["v"].float().numpy(), [0, 1, 2, 3])
    assert back["e"].dtype == torch.float8_e4m3fn
    assert back["e"].float().tolist() == [0.5, -2.0]
    assert isinstance(back["f"], np.ndarray) and back["f"] == 2.0


def test_pytree_adamw_state_dict_roundtrip(tmp_path):
    """A torch AdamW `state_dict` (int keys, tensor `step`, bf16
    moments, param_groups of Python values) and a NamedTuple must
    survive exactly — the resume path depends on it."""
    import torch

    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(2, 3, generator=gen).to(torch.bfloat16),
              torch.randn(3, generator=gen)]
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-2)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    state = {"opt": opt.state_dict(), "pair": Pair(params[1].detach(), 3)}
    save_pytree(state, str(tmp_path / "opt"))
    back = load_pytree(str(tmp_path / "opt"))
    assert type(back["pair"]) is Pair and back["pair"].b == 3
    sd, want = back["opt"], state["opt"]
    assert sd["param_groups"] == want["param_groups"]
    assert list(sd["state"]) == [0, 1]              # int keys kept
    for i in (0, 1):
        for k, v in want["state"][i].items():
            got = sd["state"][i][k]
            assert got.dtype == v.dtype and got.shape == v.shape, k
            assert torch.equal(got, v), k
    # usable directly: a fresh optimizer loaded from it steps the same
    twin = [p.detach().clone().requires_grad_(True) for p in params]
    opt2 = torch.optim.AdamW(twin, lr=1e-3, weight_decay=1e-2)
    opt2.load_state_dict(sd)
    for p, q in zip(params, twin):
        p.grad = q.grad = torch.full_like(p, 0.5)
    opt.step()
    opt2.step()
    for p, q in zip(params, twin):
        assert torch.equal(p, q)


def test_pytree_dcp_engine(tmp_path):
    """The "orbax" engine (torch.distributed.checkpoint) round-trips
    dict trees into a target; without one it refuses, as orbax does
    for custom treedefs."""
    import torch

    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
    tree = {"w": np.arange(6.0).reshape(2, 3),
            "s": torch.tensor(2.5, dtype=torch.bfloat16),
            "n": {"t": torch.arange(4.0)}}
    save_pytree(tree, str(tmp_path / "oc"), engine="orbax")
    with pytest.raises(ValueError, match="target"):
        load_pytree(str(tmp_path / "oc"))
    target = {"w": None, "s": torch.zeros((), dtype=torch.bfloat16),
              "n": {"t": torch.zeros(4)}}
    back = load_pytree(str(tmp_path / "oc"), target=target)
    np.testing.assert_allclose(np.asarray(back["w"]), tree["w"])
    assert float(back["s"]) == 2.5
    assert back["n"]["t"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_pytree_dcp_async_save_no_tear(tmp_path):
    """Back-to-back async saves on one path: the second must barrier on
    the first (no rmtree under an in-flight write) and the final state
    must be the second tree."""
    import torch

    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree
    p = str(tmp_path / "ac")
    save_pytree({"x": torch.full((1000,), 1.0)}, p, engine="orbax",
                async_save=True)
    h = save_pytree({"x": torch.full((1000,), 2.0)}, p, engine="orbax",
                    async_save=True)
    h.wait_until_finished()
    back = load_pytree(p, target={"x": torch.zeros(1000)})
    assert torch.equal(back["x"], torch.full((1000,), 2.0))


def test_checkpoint_pack_unpack_and_register_bytes(tmp_path):
    """The cross-host transport: dir -> tar bytes -> managed dir."""
    from ray_tpu_torch.train.checkpoint import pack_dir
    c = Checkpoint.from_state(str(tmp_path / "src"),
                              {"x": np.arange(3)}, metadata={"k": 1})
    data = pack_dir(c.path)
    assert isinstance(data, bytes) and len(data) > 0
    mgr = CheckpointManager(str(tmp_path / "mgr"))
    managed = mgr.register_bytes(data, {"loss": 1.0})
    assert managed.path.startswith(mgr.root)
    assert managed.load_state()["x"].tolist() == [0, 1, 2]
    assert managed.metadata() == {"k": 1}


# NOTE: train loops are built by factories so cloudpickle serialises the
# nested function by value — workers cannot import the test module.
def make_simple_loop():
    def loop(config):
        from ray_tpu_torch import train as rt_train
        ctx = rt_train.get_context()
        for step in range(config["steps"]):
            loss = float(config["base"] - step + ctx.get_world_rank() * 0.1)
            rt_train.report({"loss": loss, "step": step,
                             "rank": ctx.get_world_rank()})
    return loop


def make_ckpt_loop():
    def loop(config):
        import os as _os
        import numpy as _np
        from ray_tpu_torch import train as rt_train
        from ray_tpu_torch.train import Checkpoint
        ctx = rt_train.get_context()
        start = 0
        restored = rt_train.get_checkpoint()
        if restored is not None:
            start = int(restored.load_state()["step"]) + 1
        for step in range(start, config["steps"]):
            if config.get("fail_at") is not None and \
                    step == config["fail_at"] and restored is None and \
                    ctx.get_world_rank() == 0:
                _os._exit(1)  # hard-kill this worker process
            ckpt = None
            if ctx.get_world_rank() == 0:
                d = rt_train.make_temp_checkpoint_dir()
                ckpt = Checkpoint.from_state(d, {"step": _np.int64(step)})
            rt_train.report({"loss": 1.0 / (step + 1), "step": step}, ckpt)
    return loop


@pytest.mark.usefixtures("ray_cluster")
def test_trainer_two_workers(tmp_path):
    trainer = TorchTrainer(
        make_simple_loop(),
        train_loop_config={"steps": 3, "base": 5.0},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t2", storage_path=str(tmp_path)),
        backend_config=TorchConfig(distributed=False),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.metrics["rank"] == 0
    assert len(result.metrics_history) == 3


@pytest.mark.usefixtures("ray_cluster")
def test_trainer_checkpoints_and_retention(tmp_path):
    trainer = TorchTrainer(
        make_ckpt_loop(),
        train_loop_config={"steps": 4},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="ck", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=2)),
        backend_config=TorchConfig(distributed=False),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.checkpoint is not None
    assert int(result.checkpoint.load_state()["step"]) == 3
    ckpt_dir = os.path.join(result.path, "checkpoints")
    assert len(os.listdir(ckpt_dir)) == 2  # retention applied


@pytest.mark.usefixtures("ray_cluster")
def test_trainer_two_worker_checkpoints_no_shared_fs_assumption(tmp_path):
    """Both ranks report checkpoints every step; rank-0's arrives at the
    driver as BYTES (object store transport), rank temp dirs are
    reclaimed by the workers themselves, and the driver never touches a
    worker-local path (VERDICT r2 weak 5a)."""
    import glob
    import tempfile
    before = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                        "rtt_ckpt_*")))

    def make_loop():
        def loop(config):
            import numpy as _np

            from ray_tpu_torch import train as rt_train
            from ray_tpu_torch.train import Checkpoint
            rank = rt_train.get_context().get_world_rank()
            for step in range(3):
                d = rt_train.make_temp_checkpoint_dir()
                ckpt = Checkpoint.from_state(
                    d, {"step": _np.int64(step), "rank": _np.int64(rank)})
                rt_train.report({"step": step}, ckpt)
        return loop

    trainer = TorchTrainer(
        make_loop(),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ck2", storage_path=str(tmp_path),
                             checkpoint_config=CheckpointConfig()),
        backend_config=TorchConfig(distributed=False),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.checkpoint is not None
    state = result.checkpoint.load_state()
    assert int(state["step"]) == 2
    assert int(state["rank"]) == 0          # rank-0's checkpoint won
    # every session temp dir was reclaimed worker-side
    after = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                       "rtt_ckpt_*")))
    assert after - before == set()


def test_trainer_restart_from_checkpoint_after_failure(tmp_path,
                                                       fresh_cluster):
    trainer = TorchTrainer(
        make_ckpt_loop(),
        train_loop_config={"steps": 5, "fail_at": 2},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="ft", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=2)),
        backend_config=TorchConfig(distributed=False),
    )
    result = trainer.fit()
    assert result.error is None
    # completed despite the injected death, resuming from step >= 1
    assert int(result.metrics["step"]) == 4


def test_trainer_checkpoint_over_the_frame_limit_restores(tmp_path,
                                                         monkeypatch):
    """A checkpoint larger than `wire_max_frame_bytes` (here 8 MiB; 1 GiB
    by default, and the bench model's is ~5.7 GB) reaches the driver
    and comes back to a restarted worker: its tar rides out of band.
    As `bytes` it was pickled in band into one frame, and the end that
    read it killed the connection, so the worker died at every report
    of it (ROADMAP queue 3, item 8)."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    monkeypatch.setenv("RAY_TPU_WIRE_MAX_FRAME_BYTES", str(8 << 20))
    from ray_tpu_torch._private.config import CONFIG
    CONFIG.reload()

    def make_loop():
        def loop(config):
            import os as _os

            import numpy as _np

            from ray_tpu_torch import train as rt_train
            from ray_tpu_torch.train import Checkpoint
            blob = _np.random.default_rng(0).integers(
                0, 255, 24 << 20, dtype=_np.uint8)
            restored = rt_train.get_checkpoint()
            if restored is None:
                d = rt_train.make_temp_checkpoint_dir()
                rt_train.report({"step": 0}, Checkpoint.from_state(
                    d, {"blob": blob, "step": _np.int64(0)}))
                # returns once the driver holds the checkpoint
                rt_train.report({"step": 1})
                _os._exit(1)
            state = restored.load_state()
            rt_train.report({"step": int(state["step"]) + 1,
                             "same": bool(_np.array_equal(state["blob"],
                                                          blob))})
        return loop

    ray_tpu_torch.init(num_cpus=4)
    try:
        result = TorchTrainer(
            make_loop(),
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(
                name="big", storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=1)),
            backend_config=TorchConfig(distributed=False),
        ).fit()
    finally:
        ray_tpu_torch.shutdown()
        monkeypatch.delenv("RAY_TPU_WIRE_MAX_FRAME_BYTES")
        CONFIG.reload()
    assert result.error is None
    assert [m["step"] for m in result.metrics_history] == [0, 1, 1]
    assert result.metrics["same"] is True


def test_trainer_exhausts_max_failures(tmp_path, fresh_cluster):
    def always_fail(config):
        raise RuntimeError("boom")

    trainer = TorchTrainer(
        always_fail,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="mf", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=0)),
        backend_config=TorchConfig(distributed=False),
    )
    result = trainer.fit()
    assert result.error is not None


@pytest.mark.usefixtures("ray_cluster")
def test_trainer_gloo_all_reduce_two_processes(tmp_path):
    """TorchBackend joins 2 worker actors into one gloo process group
    (platform="cpu"); an all_reduce spans both processes (the
    multi-process template)."""
    def make_loop():
        def loop(config):
            import torch
            import torch.distributed as dist

            from ray_tpu_torch import train as rt_train
            rank = dist.get_rank()
            x = torch.arange(4.0) + 4 * rank      # rank r holds 4r..4r+3
            dist.all_reduce(x)
            rt_train.report({"procs": dist.get_world_size(),
                             "backend": dist.get_backend(),
                             "rank": rank, "sum": x.tolist()})
        return loop

    result = TorchTrainer(
        make_loop(),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="dist", storage_path=str(tmp_path)),
        backend_config=TorchConfig(distributed=True, platform="cpu"),
    ).fit()
    assert result.error is None
    assert result.metrics["procs"] == 2
    assert result.metrics["backend"] == "gloo"
    assert result.metrics["rank"] == 0
    # arange(4) + arange(4, 8), summed across both processes
    assert result.metrics["sum"] == [4.0, 6.0, 8.0, 10.0]


def test_report_outside_session_is_noop():
    rt_train.report({"x": 1})
    ctx = rt_train.get_context()
    assert ctx.get_world_size() == 1
