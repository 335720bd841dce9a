"""Parity of the port's flash-attention backward with the JAX package's.

The JAX side runs its Pallas backward kernels (`_flash_bwd_pallas`) in
interpret mode, as its own CPU tests do; the port's side is its plain
backward (`flash_attention_bwd_reference`) and the autograd Function
around it, which is what `flash_attention` runs on a CPU tensor. Inputs
are f32, made from a numpy seed, so the bf16 roundings of the kernels
are no-ops on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention

# (h, kvh, s): MHA and GQA on a block multiple (s 64), and ragged s 80
# (no multiple of the 32 block: the Pallas kernels zero tail q/dO and K
# rows and mask tail columns; the port has no padding at all); then the
# edges of the CUDA kernels' 64-row tiles: one row short of a tile, one
# row past one and one row past two, with GQA groups 1, 2 and 4
CASES = [(4, 4, 64), (4, 2, 64), (4, 4, 80), (4, 2, 80),
         (4, 4, 63), (4, 2, 65), (4, 1, 129)]
D = 32


def _inputs(seed, b, h, kvh, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, D)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, D)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, D)).astype(np.float32)
    do = rng.standard_normal((b, h, s, D)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,s", CASES)
def test_bwd_reference_matches_jax_pallas_kernels(h, kvh, s, causal):
    """dq, dk, dv of the plain backward against the JAX Pallas kernels
    (interpret) on the same O and lse; f32, sum order only: 1e-5."""
    q, k, v, do = _inputs(s + h + kvh + causal, 2, h, kvh, s)
    scale = D ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jattn._flash_fwd(jq, jk, jv, causal, scale, 32, 32, True)
    want = jattn._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, causal, scale,
                                   32, 32, True)
    got = attention.flash_attention_bwd_reference(
        *_t(q, k, v, o, lse, do), causal=causal, sm_scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("h,kvh,s", CASES[1:3])
def test_autograd_function_matches_jax_grad(h, kvh, s):
    """torch autograd through `flash_attention` (the Function) against
    `jax.grad` of the JAX `flash_attention` with `return_lse=True`, whose
    VJP is the Pallas backward in interpret mode; f32: 1e-5."""
    q, k, v, do = _inputs(7 * s + kvh, 1, h, kvh, s)

    def jloss(q_, k_, v_):
        out, _ = jattn.flash_attention(q_, k_, v_, causal=True, block_q=32,
                                       block_k=32, return_lse=True)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ins = [t.requires_grad_() for t in _t(q, k, v)]
    out, lse = attention.flash_attention(*ins, causal=True, return_lse=True)
    assert not lse.requires_grad          # a statistic, not a loss term
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_return_lse_is_differentiable():
    """The case of `tests/test_ops.py::test_flash_return_lse_
    differentiable`: the grad of sum(out^2) through the return_lse path
    equals the grad through `mha_reference`; f32: 1e-5."""
    q, k, v, _ = _inputs(13, 1, 1, 1, 64)
    qt = torch.from_numpy(q).requires_grad_()
    kt, vt = _t(k, v)
    out, _ = attention.flash_attention(qt, kt, vt, return_lse=True)
    (g,) = torch.autograd.grad((out ** 2).sum(), qt)
    qr = torch.from_numpy(q).requires_grad_()
    (gr,) = torch.autograd.grad(
        (attention.mha_reference(qr, kt, vt) ** 2).sum(), qr)
    torch.testing.assert_close(g, gr, atol=1e-5, rtol=1e-5)
    gj = jax.grad(lambda q_: jnp.sum(jattn.flash_attention(
        q_, jnp.asarray(k), jnp.asarray(v), return_lse=True)[0] ** 2))(
            jnp.asarray(q))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-5,
                               rtol=1e-5)


def test_bwd_reference_rounds_p_and_ds_to_the_input_dtype():
    """In bf16 the plain backward rounds P (for dV) and dS (for dQ, dK)
    to bf16 before the products, as the kernels do: it then differs from
    the same arithmetic without those roundings, and equals it with
    them."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(3, 1, 2, 2, 48))
    o, lse = attention.flash_attention_reference(q, k, v, True)
    dq, dk, dv = attention.flash_attention_bwd_reference(q, k, v, o, lse, do)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    f = torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f), k.to(f)) * D ** -0.5
    p = torch.exp(s - lse[..., None]).tril()
    dv_exact = torch.einsum("bhqk,bhqd->bhkd", p, do.to(f))
    dv_rounded = torch.einsum("bhqk,bhqd->bhkd", p.to(torch.bfloat16).to(f),
                              do.to(f))
    assert torch.equal(dv, dv_rounded.to(torch.bfloat16))
    assert not torch.equal(dv, dv_exact.to(torch.bfloat16))
