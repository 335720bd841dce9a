"""The port's process-group bootstrap (`ray_tpu_torch.parallel.dist`) and
its device rule for batches, without a card and without a group: what a
single process does, which variables a launcher fans out, and that a
join or a batch that needs a card raises instead of falling back."""
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from ray_tpu_torch import data as rd
from ray_tpu_torch.parallel import dist


def test_one_process_without_a_coordinator_makes_no_group(monkeypatch):
    monkeypatch.setattr(dist, "_initialized", False)
    dist.initialize_distributed(num_processes=1)
    assert dist.is_distributed_initialized()
    assert not tdist.is_initialized()
    assert dist.process_index() == 0 and dist.process_count() == 1


def test_coordinator_env_picks_the_process_group_variables(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("NCCL_DEBUG", "WARN")
    monkeypatch.setenv("TORCH_NCCL_BLOCKING_WAIT", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    env = dist.coordinator_env()
    assert env["MASTER_ADDR"] == "10.0.0.1"
    assert env["NCCL_DEBUG"] == "WARN"
    assert env["TORCH_NCCL_BLOCKING_WAIT"] == "1"
    assert "JAX_PLATFORMS" not in env


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "with no card")
def test_an_nccl_join_without_a_card_raises_and_makes_no_gloo_group(
        monkeypatch):
    monkeypatch.setattr(dist, "_initialized", False)
    with pytest.raises((RuntimeError, AssertionError)):
        dist.initialize_distributed("127.0.0.1:1", 2, 0, backend="nccl")
    assert not dist.is_distributed_initialized()
    assert not tdist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "with no card")
def test_iter_torch_batches_needs_the_card_unless_asked_for_the_cpu():
    ds = rd.from_numpy({"x": np.arange(8)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(ds.iterator().iter_torch_batches(batch_size=4)))
    got = next(iter(ds.iterator().iter_torch_batches(batch_size=4,
                                                     device="cpu")))
    assert got["x"].device.type == "cpu" and got["x"].tolist() == [0, 1,
                                                                   2, 3]
