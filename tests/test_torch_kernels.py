"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Tests marked `cuda` need an NVIDIA GPU and skip without one. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest`: the repo's conftest imports JAX.) The unmarked tests
check what needs no card: how kernels are built and located, and that
`chip_smoke.py` refuses to run without one.
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (flash_attention,
                                         flash_attention_reference)
from ray_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from ray_tpu_torch.serve.llm.engine import EngineCore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(1, 64), (8, 4096), (1000, 4096),
                                    (33, 8192)])
def test_rms_norm_kernel_matches_plain(dev, dtype, rows, d):
    gen = torch.Generator(device=dev).manual_seed(rows + d)
    x = (3 * torch.randn(rows, d, generator=gen, device=dev)).to(dtype)
    w = 0.1 * torch.randn(d, generator=gen, device=dev)
    before = rms_norm.launches
    y = rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    tol = (dict(rtol=2 ** -7, atol=1e-6) if dtype == torch.bfloat16
           else dict(rtol=1e-5, atol=1e-5))
    torch.testing.assert_close(y.float(), rms_norm_reference(x, w, 1e-5)
                               .float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,s,d", [(4, 4, 1, 64), (8, 2, 100, 64),
                                       (32, 8, 1000, 128)])
def test_flash_kernel_matches_plain(dev, h, kvh, s, d, causal):
    gen = torch.Generator(device=dev).manual_seed(s + h)

    def r(heads):
        return torch.randn(2, heads, s, d, generator=gen,
                           device=dev).bfloat16()
    q, k, v = r(h), r(kvh), r(kvh)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rlse = flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), ro.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_flash_kernel_takes_strided_inputs(dev):
    """q/k/v as transposed views of (b, s, h, d) projections, as the
    model passes them: no copy, same result."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(1, 70, 12, 64, generator=gen, device=dev).bfloat16()
    q, k, v = (x[:, :, 0:8], x[:, :, 8:10], x[:, :, 10:12])
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wrappers_raise_on_shapes_the_kernels_do_not_take(dev):
    bf = torch.bfloat16
    before = (rms_norm.launches, flash_attention.launches)
    with pytest.raises(ValueError):
        rms_norm(torch.ones(4, 4100, device=dev, dtype=bf),
                 torch.zeros(4100, device=dev))
    with pytest.raises(ValueError):
        rms_norm(torch.ones(64, 8, device=dev).T, torch.zeros(64, device=dev))
    with pytest.raises(TypeError):
        rms_norm(torch.ones(4, 64, device=dev, dtype=torch.float16),
                 torch.zeros(64, device=dev))
    q = torch.ones(1, 2, 8, 96, device=dev, dtype=bf)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    q = torch.ones(1, 2, 8, 64, device=dev)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.ones(1, 3, 8, 64, device=dev, dtype=bf)
    kv = torch.ones(1, 2, 8, 64, device=dev, dtype=bf)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv)
    q = torch.ones(1, 2, 8, 64, device=dev, dtype=bf, requires_grad=True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q)
    assert (rms_norm.launches, flash_attention.launches) == before


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu_plain_path(dev):
    """A small bf16 model (head_dim 64) served on the card through both
    kernels gives the logits of the CPU plain path, and the engine goes
    through the kernels on every layer."""
    cfg = dataclasses.replace(tiny(), d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=512, dtype="bfloat16")
    params = Transformer(cfg).init(0, device=dev)
    core = EngineCore(cfg, params, num_pages=32, page_size=8, max_batch=4)
    assert core.device == dev
    rms_norm.launches = flash_attention.launches = 0
    core.submit(list(range(1, 40)), max_tokens=6, rid="a")
    core.submit([5, 6, 7], max_tokens=4, rid="b")
    steps = 0
    while core.has_work:
        core.step()
        steps += 1
    assert flash_attention.launches == cfg.n_layers * 2
    assert rms_norm.launches == (2 * cfg.n_layers + 1) * (2 + steps)
    assert core.stats()["free_pages"] == 32
    cpu = {k: ([{n: t.cpu() for n, t in layer.items()} for layer in v]
               if k == "layers" else v.cpu()) for k, v in params.items()}
    toks = torch.arange(1, 40)[None]
    model = Transformer(cfg)
    with torch.inference_mode():
        got = model.apply(params, toks.to(dev)).cpu()
        want = model.apply(cpu, toks)
    assert (got - want).abs().max() <= 0.05 * want.abs().max()


# ---------------------------------------------------------- no card needed
def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    a = _build.library_path("flash_fwd")
    assert a.parent == _build.BUILD_DIR
    assert a.name.startswith("libflash_fwd-") and a.suffix == ".so"
    assert _build.library_path("flash_fwd") == a
    assert _build.library_path("rms_norm") != a
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("flash_fwd") != a


def test_every_kernel_source_is_listed():
    on_disk = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert on_disk == sorted(_build.SOURCES)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in out.stderr.lower()
