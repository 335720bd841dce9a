"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Tests marked `cuda` need an NVIDIA GPU and skip without one. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest`: the repo's conftest imports JAX.) The unmarked tests
check what needs no card: how kernels are built and located, and that
`chip_smoke.py` refuses to run without one.
"""
import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys

import pytest
import torch

from ray_tpu_torch import bench
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import cast_for_serving
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (_flash_bwd_cuda, flash_attention,
                                         flash_attention_bwd_reference,
                                         flash_attention_reference,
                                         mha_reference)
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
    before = (rms_norm.launches, flash_attention.launches,
              flash_attention.dkdv_launches, flash_attention.dq_launches)
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
    q = torch.ones(1, 2, 64, 64, device=dev, dtype=bf)
    lse = torch.zeros(1, 2, 64, device=dev)
    with pytest.raises(TypeError):                       # f32 dO
        _flash_bwd_cuda(q, q, q, q, lse, q.float(), True, 0.125)
    with pytest.raises(ValueError):                      # (b, h, 8, sq) lse
        _flash_bwd_cuda(q, q, q, q, lse[:, :, None].expand(1, 2, 8, 64), q,
                        True, 0.125)
    with pytest.raises(ValueError):                      # d stride 2
        _flash_bwd_cuda(q, q, q, q, lse, torch.ones(
            1, 2, 64, 128, device=dev, dtype=bf)[..., ::2], True, 0.125)
    assert (rms_norm.launches, flash_attention.launches,
            flash_attention.dkdv_launches, flash_attention.dq_launches) \
        == before


@pytest.mark.cuda
def test_rms_norm_kernel_takes_a_bf16_weight(dev):
    """The bench model trains with bf16 parameters: a bf16 w launches the
    kernel (it used to raise) and is read in f32."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (3 * torch.randn(4096, 2048, generator=gen, device=dev)).bfloat16()
    w = (0.1 * torch.randn(2048, generator=gen, device=dev)).bfloat16()
    before = rms_norm.launches
    y = rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    torch.testing.assert_close(y.float(), rms_norm_reference(x, w, 1e-5)
                               .float(), rtol=2 ** -7, atol=1e-6)


def _bwd_inputs(dev, b, h, kvh, s, d, causal, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(heads):
        return torch.randn(b, heads, s, d, generator=gen,
                           device=dev).bfloat16()
    q, k, v, do = r(h), r(kvh), r(kvh), r(h)
    o, lse = flash_attention_reference(q, k, v, causal)
    return q, k, v, o, lse, do


def _assert_rel(got, want, rel, floor=0.0):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * max(want.float().abs().max().item(), floor), err


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,s,d", [
    (4, 4, 64, 64), (8, 2, 100, 64), (32, 8, 1000, 128),
    # the edges of the kernels' 64-row tiles: a lone row, one short of a
    # tile, a tile, one past, ...
    *((4, 2, s, d) for s in (1, 63, 64, 65, 127, 129, 200)
      for d in (64, 128)),
    # GQA groups of 1, 4 and 8, summed in a dK/dV block
    (8, 8, 129, 128), (8, 2, 129, 128), (8, 1, 129, 128)])
def test_flash_bwd_kernels_match_plain(dev, h, kvh, s, d, causal):
    """dK/dV and dQ against the plain backward, GQA and ragged s; both
    round P and dS to bf16, so 1e-2 of max|ref| (chip_smoke.py TOL). At
    s = 1 dQ and dK are 0 in exact arithmetic (P = 1, O = V, so dP =
    delta) and max|ref| is rounding noise: it is taken as at least
    1e-3."""
    q, k, v, o, lse, do = _bwd_inputs(dev, 2, h, kvh, s, d, causal, s + h)
    before = (flash_attention.dkdv_launches, flash_attention.dq_launches)
    got = _flash_bwd_cuda(q, k, v, o, lse, do, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (flash_attention.dkdv_launches, flash_attention.dq_launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _assert_rel(g, w, 1e-2, 1e-3 if s == 1 else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,s,d", [(16, 16, 2048, 128), (8, 2, 129, 64)])
def test_flash_bwd_kernels_are_deterministic(dev, h, kvh, s, d):
    """No atomics and a fixed order of sums: two launches on the same
    inputs give the same bits."""
    ins = _bwd_inputs(dev, 2, h, kvh, s, d, True, 21)
    first = _flash_bwd_cuda(*ins, True, d ** -0.5)
    second = _flash_bwd_cuda(*ins, True, d ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_takes_a_strided_do(dev):
    """dO as the model hands it back: a transposed view of (b, s, h, d)
    memory. Same bits as a contiguous dO."""
    q, k, v, o, lse, do = _bwd_inputs(dev, 1, 8, 2, 130, 128, True, 4)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    for a, b in zip(_flash_bwd_cuda(q, k, v, o, lse, strided, True, 0.1),
                    _flash_bwd_cuda(q, k, v, o, lse, do, True, 0.1)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,s,d", [(4, 4, 256, 128), (8, 2, 77, 64)])
def test_flash_function_grads_match_autograd_reference(dev, h, kvh, s, d):
    """Gradients through flash_attention (forward kernel, then both
    backward kernels) against autograd through mha_reference in f32 on
    the same values: 2e-2 of max|ref| (chip_smoke.py TOL)."""
    q, k, v, _, _, g = _bwd_inputs(dev, 2, h, kvh, s, d, True, 11)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*ins), ins, g)
    refs = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(mha_reference(*refs), refs, g.float())
    for a, w in zip(got, want):
        _assert_rel(a, w, 2e-2)


@pytest.mark.cuda
def test_gradient_flows_through_both_wrappers_on_the_card(dev):
    """A training step of a small bf16 model on the card goes through
    every kernel, forward and backward (both wrappers used to raise
    under autograd), and its grads agree with the CPU plain path in f32
    on the same parameter values: 5e-2 of each grad's max|ref|."""
    cfg = dataclasses.replace(tiny(), d_model=256, n_heads=2, n_kv_heads=2,
                              d_ff=512, dtype="bfloat16",
                              param_dtype="bfloat16")
    cpu = Transformer(cfg).init(0, device="cpu")
    on_card = {k: ([{n: t.to(dev) for n, t in layer.items()} for layer in v]
                   if k == "layers" else v.to(dev)) for k, v in cpu.items()}
    f32 = {k: ([{n: t.float() for n, t in layer.items()} for layer in v]
               if k == "layers" else v.float()) for k, v in cpu.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 96),
                         generator=torch.Generator().manual_seed(1))
    grads = []
    for c, p, t in ((cfg, on_card, toks.to(dev)),
                    (dataclasses.replace(cfg, dtype="float32",
                                         param_dtype="float32"), f32, toks)):
        leaves = bench.leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        counts = (flash_attention.launches, flash_attention.dkdv_launches,
                  flash_attention.dq_launches, rms_norm.launches)
        grads.append(torch.autograd.grad(
            Transformer(c).loss(p, {"tokens": t}), leaves))
        added = [a - b for a, b in zip(
            (flash_attention.launches, flash_attention.dkdv_launches,
             flash_attention.dq_launches, rms_norm.launches), counts)]
        assert added == ([2, 2, 2, 5] if p is on_card else [0, 0, 0, 0])
    for g, w in zip(*grads):
        _assert_rel(g.cpu(), w, 5e-2)


@pytest.mark.cuda
def test_save_attn_remat_refuses_on_the_card(dev):
    cfg = dataclasses.replace(tiny(), d_model=256, n_heads=2, n_kv_heads=2,
                              dtype="bfloat16", remat=True,
                              remat_policy="save_attn")
    params = Transformer(cfg).init(0, device=dev)
    with pytest.raises(NotImplementedError, match="save_attn"):
        Transformer(cfg).loss(params, {"tokens": torch.zeros(
            1, 64, dtype=torch.long, device=dev)})


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu_plain_path(dev):
    """A small bf16 model (head_dim 64) served on the card through both
    kernels gives the logits of the CPU plain path, and the engine goes
    through the kernels on every layer."""
    cfg = dataclasses.replace(tiny(), d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=512, dtype="bfloat16")
    params = cast_for_serving(Transformer(cfg).init(0, device=dev), cfg)
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


def test_a_header_edit_renames_every_library(monkeypatch, tmp_path):
    """The kernels include csrc/*.cuh: editing a header must rebuild them
    all, never load a library built from the old header."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for n in _build.SOURCES:
        assert _build.library_path(n) != before[n], n


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 178 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 4096 bytes smem
"""


def test_chip_smoke_reads_registers_and_spills_from_ptxas():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    got = chip_smoke.ptxas_resources(PTXAS_LOG)
    assert got == {
        "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEvNS_6ParamsE": {
            "registers": 178, "spill_store_bytes": 0, "spill_load_bytes": 0,
            "smem_static_bytes": 0},
        "_Z6kernelv": {"registers": 255, "spill_store_bytes": 12,
                       "spill_load_bytes": 16, "smem_static_bytes": 4096}}


def test_every_kernel_source_is_listed():
    on_disk = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert on_disk == sorted(_build.SOURCES)
    assert {"flash_fwd", "flash_bwd", "rms_norm"} <= set(_build.SOURCES)


def test_bench_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


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
