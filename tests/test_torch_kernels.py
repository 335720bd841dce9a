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

import numpy as np
import pytest
import torch

from ray_tpu_torch import bench
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import cast_for_serving
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops import _build, attention
from ray_tpu_torch.ops.attention import (_flash_bwd_cuda, flash_attention,
                                         flash_attention_bwd_reference,
                                         flash_attention_reference,
                                         mha_reference)
from ray_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from ray_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                            paged_decode_attention_reference)
from ray_tpu_torch.serve.llm.engine import EngineCore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    """chip_smoke.py as a module (it imports no JAX, and needs no card to
    import): its case lists and log parsers are tested here."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ------------------------------------------------------------ on the card
@pytest.fixture
def one_rank_mesh(dev):
    """The one-rank nccl mesh `prepare_mesh` makes on the card when the
    process has no group (every axis of size 1)."""
    from ray_tpu_torch.parallel import MeshSpec, prepare_mesh
    return prepare_mesh(MeshSpec())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_inside_local_map_gives_the_direct_calls_bits(one_rank_mesh,
                                                            causal):
    """`flash_attention_sharded` on a one-rank nccl mesh launches the
    same kernels on the same tensors as the direct call: O and the grads
    of q, k and v bit-equal, forward and backward."""
    from torch.distributed.tensor import DTensor, Replicate

    from ray_tpu_torch.ops.sharded import flash_attention_sharded
    from ray_tpu_torch.parallel.mesh import compute_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = compute_mesh(one_rank_mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(2, h, 512, 128, generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (16, 4, 4))
    do = torch.randn(2, 16, 512, 128, generator=gen, device=dev,
                     dtype=torch.bfloat16)

    def grads(run):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = run(*leaves)
        out.backward(do)
        return out.detach(), [t.grad for t in leaves]

    want, want_g = grads(lambda *a: flash_attention(*a, causal=causal))
    before = (attention.flash_attention.launches,
              attention.flash_attention.dkdv_launches,
              attention.flash_attention.dq_launches)

    def sharded(*a):
        d = [DTensor.from_local(t, mesh, [Replicate()]) for t in a]
        return flash_attention_sharded(*d, mesh, causal=causal).to_local()
    got, got_g = grads(sharded)
    torch.cuda.synchronize()
    assert (attention.flash_attention.launches,
            attention.flash_attention.dkdv_launches,
            attention.flash_attention.dq_launches) == tuple(
                n + 1 for n in before)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rms_norm_inside_local_map_gives_the_direct_calls_bits(
        one_rank_mesh):
    from torch.distributed.tensor import DTensor, Replicate

    from ray_tpu_torch.ops.sharded import rms_norm_sharded
    from ray_tpu_torch.parallel.mesh import compute_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = compute_mesh(one_rank_mesh)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 2048, 2048, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    w = 0.1 * torch.randn(2048, generator=gen, device=dev,
                          dtype=torch.bfloat16)
    g = torch.randn_like(x)

    def grads(run):
        xs, ws = (t.detach().clone().requires_grad_(True) for t in (x, w))
        y = run(xs, ws)
        y.backward(g)
        return y.detach(), xs.grad, ws.grad

    want = grads(lambda a, b: rms_norm(a, b, 1e-5))
    before = rms_norm.launches
    got = grads(lambda a, b: rms_norm_sharded(
        DTensor.from_local(a, mesh, [Replicate()]),
        DTensor.from_local(b, mesh, [Replicate()]), 1e-5).to_local())
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", [
    *((2, h, kvh, s, s, d, causal)
      for h, kvh, s, d in ((4, 4, 1, 64), (8, 2, 100, 64), (32, 8, 1000, 128))
      for causal in (True, False)),
    # chip_smoke.py's: the main paths' shapes, sq != sk, and every edge of
    # the kernel's 64-row warpgroup tiles, 128-row blocks and K/V tiles at
    # both head dims, GQA groups 1, 4 and 8, both masks
    *chip_smoke.FWD_CASES])
def test_flash_kernel_matches_plain(dev, b, h, kvh, sq, sk, d, causal):
    gen = torch.Generator(device=dev).manual_seed(sq + 3 * sk + h)

    def r(heads, s):
        return torch.randn(b, heads, s, d, generator=gen,
                           device=dev).bfloat16()
    q, k, v = r(h, sq), r(kvh, sk), r(kvh, sk)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rlse = flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(o.float(), ro.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh", [(1, 32, 8), (2, 16, 16)])
def test_flash_fwd_kernel_is_deterministic(dev, b, h, kvh):
    """No atomics and a fixed order of sums: two launches at the llama3-8b
    prefill and training shapes give the same O and lse bits."""
    gen = torch.Generator(device=dev).manual_seed(h)
    q, k, v = (torch.randn(b, heads, 2048, 128, generator=gen,
                           device=dev).bfloat16() for heads in (h, kvh, kvh))
    first = flash_attention(q, k, v, causal=True, return_lse=True)
    second = flash_attention(q, k, v, causal=True, return_lse=True)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


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


# chip_smoke.PAGED_CASES by name: the chat cell's shape (256 rows,
# contexts 16-4,096, 32 / 8 heads, head_dim 128, page 16), llama3-8b's
# 8-row decode steps (512-page tables: several chunks a row), head_dim 64
# at page 8 (the engine tests' model)
PAGED_SHAPES = {"chat": chip_smoke.PAGED_CASES[0],
                "rows8": chip_smoke.PAGED_CASES[1],
                "hd64": chip_smoke.PAGED_CASES[3]}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(PAGED_SHAPES))
def test_paged_decode_kernel_matches_plain(dev, shape):
    """Active rows' outputs within a bf16 ulp of the plain version's, and
    both caches bit-equal after the write: each writing row's new k / v
    in its slot, nothing from the inactive row or the row whose own page
    is unassigned."""
    rows, heads, kvh, hd, ps, max_pages, contexts = PAGED_SHAPES[shape]
    args = chip_smoke.paged_inputs(rows, heads, kvh, hd, ps, max_pages,
                                   contexts, dev, 31)
    before = paged_decode_attention.launches
    got, gk, gv = chip_smoke.run_paged(paged_decode_attention, args)
    assert paged_decode_attention.launches == before + 1
    want, wk, wv = chip_smoke.run_paged(paged_decode_attention_reference,
                                        args)
    act = args["active"]
    torch.testing.assert_close(got[act].float(), want[act].float(),
                               **chip_smoke.TOL["paged_o"])
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    pt, pos = args["page_tables"].long(), args["positions"].long()
    own = pt[torch.arange(rows, device=dev), pos // ps]
    writers = act & (own >= 0)
    assert not writers[-1] and not writers[1]
    changed = (gk != args["k_cache"]).any(-1).any(-1)
    assert int(changed.sum()) == int(writers.sum())
    assert changed[own[writers], (pos % ps)[writers]].all()


@pytest.mark.cuda
def test_paged_decode_kernel_is_deterministic(dev):
    """No atomics and a fixed order of sums: two launches at the chat
    cell's shape give the same bits."""
    rows, heads, kvh, hd, ps, max_pages, contexts = PAGED_SHAPES["chat"]
    args = chip_smoke.paged_inputs(rows, heads, kvh, hd, ps, max_pages,
                                   contexts, dev, 32)
    a = chip_smoke.run_paged(paged_decode_attention, args)
    b = chip_smoke.run_paged(paged_decode_attention, args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_paged_decode_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    before = paged_decode_attention.launches
    for what, args in chip_smoke.paged_refusals(dev):
        with pytest.raises((TypeError, ValueError)):
            paged_decode_attention(**args)
    assert paged_decode_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_kernel_matches_plain_at_the_training_shape(dev, dtype):
    """(4096, 2048) with a bf16 w, as the bench model trains: two warps a
    row, and every block walks more than one row."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = (3 * torch.randn(4096, 2048, generator=gen, device=dev)).to(dtype)
    w = (0.1 * torch.randn(2048, generator=gen, device=dev)).bfloat16()
    before = rms_norm.launches
    y = rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    tol = (dict(rtol=2 ** -7, atol=1e-6) if dtype == torch.bfloat16
           else dict(rtol=1e-5, atol=1e-5))
    torch.testing.assert_close(y.float(), rms_norm_reference(x, w, 1e-5)
                               .float(), **tol)


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


def _flash_op_layouts(q, k, v):
    """(real, fake) (shape, stride, dtype) of the flash op's O and lse:
    its kernel for q's device, and its fake under FakeTensorMode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def layout(outs):
        return [(tuple(t.shape), t.stride(), t.dtype) for t in outs]
    real = layout(attention.flash_fwd(q, k, v, True, 0.125))
    with FakeTensorMode() as mode:
        fake = layout(attention.flash_fwd(
            *(mode.from_tensor(t) for t in (q, k, v)), True, 0.125))
    return real, fake


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,s,d", [(1, 32, 8, 300, 128),
                                         (2, 4, 4, 64, 64)])
def test_flash_op_fake_matches_the_kernel(dev, b, h, kvh, s, d):
    gen = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn(b, n, s, d, generator=gen, device=dev)
               .bfloat16() for n in (h, kvh, kvh))
    real, fake = _flash_op_layouts(q, k, v)
    assert real == fake


@pytest.mark.cuda
def test_save_attn_remat_on_the_card_keeps_the_forward(dev):
    """A loss-and-backward step of a 2-layer bf16 model under remat:
    full remat launches the flash forward twice a layer, save_attn once;
    dK/dV and dQ once a layer in both. Loss and grads are bitwise
    equal: both kernels are deterministic, so the recomputed O and lse
    are the saved ones."""
    base = dataclasses.replace(tiny(), d_model=256, n_heads=2, n_kv_heads=2,
                               d_ff=512, dtype="bfloat16",
                               param_dtype="bfloat16", remat=True)
    params = Transformer(base).init(0, device=dev)
    toks = torch.randint(0, base.vocab_size, (2, 96), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    out = {}
    for policy in ("full", "save_attn"):
        leaves = bench.leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        before = (flash_attention.launches, flash_attention.dkdv_launches,
                  flash_attention.dq_launches)
        model = Transformer(dataclasses.replace(base, remat_policy=policy))
        loss = model.loss(params, {"tokens": toks})
        grads = torch.autograd.grad(loss, leaves)
        added = [a - b for a, b in zip(
            (flash_attention.launches, flash_attention.dkdv_launches,
             flash_attention.dq_launches), before)]
        out[policy] = (loss, grads, added)
    assert out["full"][2] == [4, 2, 2]
    assert out["save_attn"][2] == [2, 2, 2]
    assert torch.equal(out["full"][0], out["save_attn"][0])
    assert all(torch.equal(a, b)
               for a, b in zip(out["full"][1], out["save_attn"][1]))


@pytest.mark.cuda
def test_llm_engine_on_the_card_streams_the_core_tokens(dev):
    """LLMEngine on the card: the tokens pushed over its stream equal
    EngineCore's greedy tokens for the same prompts and weights."""
    import queue
    import time

    from ray_tpu_torch.serve.llm import LLMEngine, stream_client
    cfg = dataclasses.replace(tiny(), d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=512, dtype="bfloat16")
    params = cast_for_serving(Transformer(cfg).init(0, device=dev), cfg)
    prompts = {"a": list(range(1, 40)), "b": [5, 6, 7], "c": [9] * 20}
    core = EngineCore(cfg, params, num_pages=32, page_size=8, max_batch=4)
    for rid, p in prompts.items():
        core.submit(p, max_tokens=6, rid=rid)
    want = {}
    while core.has_work:
        for ev in core.step():
            if ev["token"] is not None:
                want.setdefault(ev["rid"], []).append(ev["token"])
    del core
    eng = LLMEngine(model=cfg, weights=params, num_pages=32, page_size=8,
                    max_batch=4)
    try:
        sinks = {}
        for rid, p in prompts.items():
            acc = eng.generate(p, max_tokens=6, rid=rid)
            sinks[rid] = queue.Queue()
            assert stream_client().subscribe(
                acc["stream"], rid, acc["incarnation"], 0, 0, sinks[rid])
        deadline = time.monotonic() + 60
        for rid, sink in sinks.items():
            toks, msg = [], {"done": False}
            while not msg["done"]:
                msg = sink.get(timeout=max(0.0, deadline - time.monotonic()))
                assert msg.get("err") is None, msg
                toks.extend(msg["toks"][max(0, len(toks) - msg["base"]):])
            assert toks == want[rid], rid
    finally:
        eng.close()


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
    paged_decode_attention.launches = 0
    core.submit(list(range(1, 40)), max_tokens=6, rid="a")
    core.submit([5, 6, 7], max_tokens=4, rid="b")
    steps = 0
    while core.has_work:
        core.step()
        steps += 1
    assert flash_attention.launches == cfg.n_layers * 2
    assert rms_norm.launches == (2 * cfg.n_layers + 1) * (2 + steps)
    # every step decodes once, through the kernel on every layer
    assert paged_decode_attention.launches == cfg.n_layers * steps
    assert core.stats()["free_pages"] == 32
    cpu = {k: ([{n: t.cpu() for n, t in layer.items()} for layer in v]
               if k == "layers" else v.cpu()) for k, v in params.items()}
    toks = torch.arange(1, 40)[None]
    model = Transformer(cfg)
    with torch.inference_mode():
        got = model.apply(params, toks.to(dev)).cpu()
        want = model.apply(cpu, toks)
    assert (got - want).abs().max() <= 0.05 * want.abs().max()



@pytest.mark.cuda
def test_iter_torch_batches_on_the_card(dev):
    """Batches land on the card with the values and dtypes asked for
    (a dtype by name, bf16 included), and `stats` counts them."""
    from ray_tpu_torch import data as rd
    x = np.arange(64 * 8).reshape(64, 8)
    ds = rd.from_numpy({"tokens": x, "f": x * 0.5})
    stats = {}
    got = list(ds.iterator().iter_torch_batches(
        batch_size=16, dtypes={"tokens": "int32", "f": torch.bfloat16},
        stats=stats))
    assert len(got) == 4 and stats["num_batches"] == 4
    for i, b in enumerate(got):
        assert b["tokens"].device == dev and b["f"].device == dev
        assert b["tokens"].dtype == torch.int32
        assert b["f"].dtype == torch.bfloat16
        rows = x[16 * i:16 * (i + 1)]
        assert torch.equal(b["tokens"].cpu(),
                           torch.from_numpy(rows).to(torch.int32))
        assert torch.equal(b["f"].cpu(),
                           torch.from_numpy(rows * 0.5).to(torch.bfloat16))


@pytest.mark.cuda
def test_iter_torch_batches_a_kernel_at_once_sees_the_whole_batch(dev):
    """Each batch (64 MiB, copied on the side stream) is read by a
    kernel on the consumer's stream the moment it is handed out, while
    the next batch's copy is in flight: every sum must be the batch's
    own, so the consumer's stream waited on the copy."""
    from ray_tpu_torch import data as rd
    rows, cols, n = 512, 16384, 6
    x = np.arange(rows * n, dtype=np.int64)[:, None].repeat(cols, 1)
    ds = rd.from_numpy({"x": x})
    sums = []
    for b in ds.iterator().iter_torch_batches(batch_size=rows):
        sums.append(b["x"].sum())                 # queued at once
        torch.cuda._sleep(1_000_000)              # a busy step
    got = [int(s) for s in sums]
    want = [int(x[rows * i:rows * (i + 1)].sum()) for i in range(n)]
    assert got == want


@pytest.mark.cuda
def test_iter_torch_batches_abandoned_consumer_retires_threads(dev):
    import threading
    import time

    from ray_tpu_torch import data as rd

    def data_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith(("data-prefetch", "data-producer"))]
    ds = rd.from_numpy({"x": np.arange(4096)})
    it = iter(ds.iterator().iter_torch_batches(batch_size=8,
                                               prefetch_depth=1))
    assert next(it)["x"].device == dev
    it.close()                       # abandon mid-stream
    deadline = time.time() + 5
    while data_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not data_threads()


@pytest.mark.cuda
def test_checkpoint_round_trip_of_card_params_and_adamw_is_exact(dev,
                                                                 tmp_path):
    """bf16 params on the card and their AdamW `state_dict` after a
    training step through the kernels: saved, loaded and moved back to
    the card, every tensor is bitwise equal, and an optimizer loaded
    from the state steps exactly as the original."""
    from ray_tpu_torch.train import Checkpoint
    cfg = dataclasses.replace(tiny(), d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=512, dtype="bfloat16",
                              param_dtype="bfloat16")
    model = Transformer(cfg)
    params = model.init(0, device=dev)
    opt = bench.make_optimizer(params)
    batch = bench.make_batch(cfg, 2, 128, dev)
    bench.train_step(model, params, opt, batch)
    ckpt = Checkpoint.from_state(str(tmp_path / "c"),
                                 {"params": params, "opt": opt.state_dict()})
    back = ckpt.load_state()
    got = [t.to(dev) for t in bench.leaves(back["params"])]
    for a, b in zip(got, bench.leaves(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(back["opt"]["state"][i][k].to(v.device), v)
    for p in got:
        p.requires_grad_(True)
    opt2 = torch.optim.AdamW(got, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
    opt2.load_state_dict(back["opt"])
    for p, q in zip(bench.leaves(params), got):
        p.grad = q.grad = torch.full_like(p, 0.25)
    opt.step()
    opt2.step()
    for p, q in zip(bench.leaves(params), got):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_a_gpu_task_on_an_agent_node_sees_the_card(dev):
    """A head with no GPU and a node agent that owns the card
    (`--num-gpus 1`): a `num_gpus=1` task runs on the agent's node and
    computes on the card there."""
    import time

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    del dev
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    agent = NodeAgentProcess(num_cpus=2, num_gpus=1)
    try:
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
        deadline = time.monotonic() + 60
        while (ray_tpu_torch.cluster_resources().get("GPU", 0) < 1
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert ray_tpu_torch.cluster_resources().get("GPU") == 1

        @ray_tpu_torch.remote(num_gpus=1)
        def on_card():
            import os as _os

            import torch as _torch
            x = _torch.arange(8.0, device="cuda")
            return (_os.environ.get("RAY_TPU_NODE_ID"),
                    _torch.cuda.get_device_name(0), float((x * x).sum()))

        node, name, total = ray_tpu_torch.get(on_card.remote(), timeout=120)
        assert node == agent.node_id
        assert name == torch.cuda.get_device_name(0)
        assert total == 140.0
    finally:
        ray_tpu_torch.shutdown()
        agent.terminate()
        agent.wait(10)


# ---------------------------------------------------------- no card needed
@pytest.mark.parametrize("b,h,kvh,s,d", [(1, 4, 2, 9, 16),
                                         (2, 2, 2, 1, 64)])
def test_flash_op_fake_matches_the_cpu_plain_path(b, h, kvh, s, d):
    """The op's fake gives O and lse the layout its CPU path returns
    (O in the kernel's (b, s, h, d) memory), and the op passes
    torch.library's registration checks (schema, autograd, fake)."""
    gen = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(b, n, s, d, generator=gen) for n in (h, kvh, kvh))
    real, fake = _flash_op_layouts(q, k, v)
    assert real == fake
    assert real[0][1] == (s * h * d, d, h * d, 1)
    for t in (q, k, v):
        t.requires_grad_(True)
    torch.library.opcheck(attention.flash_fwd, (q, k, v, True, d ** -0.5),
                          test_utils=("test_schema",
                                      "test_autograd_registration",
                                      "test_faketensor"))


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    a = _build.library_path("flash_fwd")
    assert a.parent == _build.BUILD_DIR
    assert a.name.startswith("libflash_fwd-") and a.suffix == ".so"
    assert _build.library_path("flash_fwd") == a
    assert _build.library_path("rms_norm") != a
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("flash_fwd") != a


def test_a_first_load_builds_every_missing_library_at_once(monkeypatch):
    """Loading one kernel builds all the missing ones, in parallel, so a
    checkout's first run pays the longest build, not their sum; the
    paged decode source alone compiles in split mode, under its own
    library name."""
    import types
    asked = []

    def build(names=None):
        asked.append(names)
        return {n: _build.library_path(n) for n in _build.SOURCES}
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(
                            path=path,
                            rtt_error_string=types.SimpleNamespace()))
    lib = _build.load("rms_norm")
    assert asked == [None] and lib.path == str(_build.library_path("rms_norm"))
    assert "-split-compile" in _build.flags("paged_decode")
    assert _build.flags("flash_fwd") == _build.NVCC_FLAGS


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
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_a0e9620c16flash_fwd_kernelILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_a0e9620c16flash_fwd_kernelILi64EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 4096 bytes smem
"""


@pytest.mark.parametrize("entry,key,registers", [
    ("_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEvNS_6ParamsE",
     ("dq", 128), 178),
    ("_ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_a0e9620c16flash_fwd_kernel"
     "ILi64EEEvNS_6ParamsE", ("fwd", 64), 168)])
def test_chip_smoke_reads_registers_and_spills_from_ptxas(entry, key,
                                                         registers):
    got = chip_smoke.ptxas_resources(PTXAS_LOG)
    assert got[entry] == {"registers": registers, "spill_store_bytes": 0,
                          "spill_load_bytes": 0, "smem_static_bytes": 0}
    assert chip_smoke.flash_entry(entry) == key
    assert got["_Z6kernelv"] == {"registers": 255, "spill_store_bytes": 12,
                                 "spill_load_bytes": 16,
                                 "smem_static_bytes": 4096}
    assert chip_smoke.flash_entry("_Z6kernelv") is None


def test_chip_smoke_forward_cases_cover_every_tile_edge():
    """FWD_CASES holds, at both head dims and under both masks, a square
    case at every edge of the forward's tiles (64-row warpgroup tiles,
    128-row q blocks and K/V tiles: one short, on, one past), GQA groups of
    1, 4 and 8, sq != sk under each mask, and the main paths' shapes."""
    cases = chip_smoke.FWD_CASES
    square = {(s, d, causal) for _, _, _, s, sk, d, causal in cases
              if s == sk}
    for edge in (64, 128, 256):
        for s in (edge - 1, edge, edge + 1):
            for d in (64, 128):
                for causal in (True, False):
                    assert (s, d, causal) in square, (s, d, causal)
    assert {(1, d, c) for d in (64, 128) for c in (True, False)} <= square
    assert {h // kvh for _, h, kvh, *_ in cases} >= {1, 4, 8}
    for causal in (True, False):
        assert any(sq < sk and c == causal for *_, sq, sk, _, c in cases)
        assert any(sq > sk and c == causal for *_, sq, sk, _, c in cases)
    assert (1, 32, 8, 2048, 2048, 128, True) in cases       # llama3-8b
    assert (2, 16, 16, 2048, 2048, 128, True) in cases      # training


def test_every_kernel_source_is_listed():
    on_disk = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert on_disk == sorted(_build.SOURCES)
    assert {"flash_fwd", "flash_bwd", "rms_norm",
            "paged_decode"} <= set(_build.SOURCES)


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


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["shm", "wire"])
def test_a_cuda_tensor_crosses_a_channel_onto_the_readers_card(dev,
                                                               transport):
    """A bf16 CUDA tensor written to a channel lands as a CUDA tensor on
    the reader's current card, bit for bit, on both transports; the
    slot's next message does not change it (the copy finished before the
    ack). An f32 CPU tensor stays on the CPU."""
    from ray_tpu_torch.experimental.channel import Channel
    from ray_tpu_torch.experimental.wire_channel import serve_channel
    ch = (Channel.create(capacity=1 << 22, n_readers=1, depth=1)
          if transport == "shm" else
          serve_channel(capacity=1 << 22, n_readers=1, depth=1))
    try:
        r = ch.reader(0)
        w = ch.writer()
        gen = torch.Generator(device=dev).manual_seed(0)
        sent = torch.randn(1, 256, 2048, generator=gen, device=dev).to(
            torch.bfloat16)
        w.write(sent, timeout=30.0)
        got = r.read(timeout=30.0)
        assert got.is_cuda and got.device.index == torch.cuda.current_device()
        assert got.dtype == torch.bfloat16 and torch.equal(got, sent)
        w.write(torch.zeros_like(sent), timeout=30.0)   # reuses the slot
        assert torch.equal(got, sent)
        assert not bool(r.read(timeout=30.0).any())
        host = torch.arange(10, dtype=torch.float32)
        w.write(host, timeout=30.0)
        back = r.read(timeout=30.0)
        assert back.device.type == "cpu" and torch.equal(back, host)
        w.close()
    finally:
        ch.destroy()
