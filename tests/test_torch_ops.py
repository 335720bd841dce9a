"""Parity of the port's ops (ray_tpu_torch.ops) with the JAX package's.

Inputs are made from a seed with numpy and fed to both packages. On the
CPU the port's kernel wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode where its CPU tests do, so the
plain versions are held to the TPU kernels' semantics.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.ops import attention, norms, rope
from ray_tpu_torch.ops.dispatch import on_cuda, resolve_device


def _bf16_pair(x: np.ndarray):
    """The same bf16 values in both packages (both round to nearest)."""
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _assert_within_bf16_ulp(got: np.ndarray, ref: np.ndarray):
    """|got - ref| <= one bf16 ulp of ref (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - ref) <= ulp), np.max(np.abs(got - ref) / ulp)


# ------------------------------------------------------------- rmsnorm
# 256 and 512 rows take the JAX Pallas kernel (interpret); 8 rows is one
# block of 8; 300 and 1000 are ragged, where the JAX wrapper falls back
# to its reference and the port's kernel handles the rows itself.
@pytest.mark.parametrize("rows", [8, 256, 300, 512, 1000])
def test_rms_norm_f32_matches_jax(rows):
    rng = np.random.default_rng(rows)
    x = (3 * rng.standard_normal((rows, 64))).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows", [8, 256, 300])
def test_rms_norm_bf16_matches_jax_within_one_ulp(rows):
    rng = np.random.default_rng(100 + rows)
    x = (3 * rng.standard_normal((2, rows, 128))).astype(np.float32)
    w = (0.1 * rng.standard_normal(128)).astype(np.float32)
    jx, tx = _bf16_pair(x)
    want = jnorms.rms_norm(jx, jnp.asarray(w), 1e-5)
    got = norms.rms_norm(tx, torch.from_numpy(w), 1e-5)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    _assert_within_bf16_ulp(got.float().numpy(),
                            np.asarray(want.astype(jnp.float32)))


def test_rms_norm_zero_weight_is_identity_scale():
    """(1 + w): a zero-init weight leaves the normalised row unscaled."""
    x = torch.tensor([[3.0, 4.0]])
    y = norms.rms_norm(x, torch.zeros(2), eps=0.0)
    rms = (12.5) ** 0.5
    torch.testing.assert_close(y, x / rms)


# ----------------------------------------------------------------- rope
def test_rope_frequencies_and_cos_sin_match_jax():
    for theta in (10000.0, 500000.0):
        np.testing.assert_allclose(
            rope.rope_frequencies(128, theta).numpy(),
            np.asarray(jrope.rope_frequencies(128, theta)), rtol=1e-6)
    pos = np.arange(96, dtype=np.int32).reshape(2, 48)
    c, s = rope.rope_cos_sin(torch.from_numpy(pos), 32, 500000.0)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 32, 500000.0)
    assert tuple(c.shape) == jc.shape == (2, 48, 1, 16)
    # angles reach ~95 rad: one f32 ulp of an inverse frequency moves
    # cos/sin by ~1e-5 there
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-5)


def test_rope_frequencies_rejects_odd_head_dim():
    with pytest.raises(ValueError):
        rope.rope_frequencies(7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 10)).astype(np.int32)
    if dtype == "float32":
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        jx, tx = _bf16_pair(x)
    want = jrope.apply_rope(jx, jnp.asarray(pos), 10000.0)
    got = rope.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    assert got.dtype == tx.dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    else:
        # f32 math rounds to bf16 on both sides; a ~1e-6 difference in
        # the f32 value can flip one rounding
        _assert_within_bf16_ulp(got.float().numpy(), want)


# ------------------------------------------------------------ attention
def _qkv(seed, b, h, kvh, s, d, sk=None):
    """q (b, h, s, d) and k/v (b, kvh, sk, d), sk defaulting to s."""
    sk = s if sk is None else sk
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    return q, k, v


# (h, kvh, sq, sk, head_dim): MHA on a block multiple, GQA, and seq 80 (no
# multiple of the 32 block: tail K columns masked, tail V rows zeroed on
# the JAX side); then sq != sk both ways (the causal mask's top-left
# alignment, q row i sees keys j <= i, and a ragged tail lse), and head_dim
# 64 with a GQA group of 8 at s 65.
ATTN_CASES = [pytest.param(4, 4, 64, 64, 32, id="4-4-64"),
              pytest.param(4, 2, 64, 64, 32, id="4-2-64"),
              pytest.param(4, 2, 80, 80, 32, id="4-2-80"),
              pytest.param(4, 1, 80, 80, 32, id="4-1-80"),
              pytest.param(4, 2, 40, 100, 32, id="4-2-sq40-sk100"),
              pytest.param(4, 2, 100, 40, 32, id="4-2-sq100-sk40"),
              pytest.param(8, 1, 65, 65, 64, id="8-1-65-d64")]
LSE_CASES = ATTN_CASES[1:3] + ATTN_CASES[4:]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,s,sk,d", ATTN_CASES)
def test_flash_attention_matches_jax_kernel(h, kvh, s, sk, d, causal):
    q, k, v = _qkv(s + h + kvh, 1, h, kvh, s, d, sk)
    want = jattn.flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=32, block_k=32)
    got = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ref = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,s,sk,d", LSE_CASES)
def test_flash_attention_lse_matches_jax(h, kvh, s, sk, d, causal):
    q, k, v = _qkv(3 * s + kvh, 2, h, kvh, s, d, sk)
    jo, jl = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=32, block_k=32, return_lse=True)
    o, lse = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, return_lse=True)
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(11, 2, 4, 2, 24, 16)
    bias = np.random.default_rng(12).standard_normal(
        (1, 1, 24, 24)).astype(np.float32)
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, sm_scale=0.3,
                               bias=jnp.asarray(bias))
    got = attention.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  sm_scale=0.3, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mask_value_matches_jax():
    assert attention.DEFAULT_MASK_VALUE == jattn.DEFAULT_MASK_VALUE


def test_flash_attention_cpu_path_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 2, 2, 8, 16))
    before = attention.flash_attention.launches
    attention.flash_attention(q, k, v)
    assert attention.flash_attention.launches == before


# ------------------------------------------------------------- dispatch
def test_resolve_device_cpu_on_request_only():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on the card raises; no wrapper
    runs its plain version there."""
    x = torch.empty(4, 64, device="meta")
    assert on_cuda(torch.empty(1)) is False
    with pytest.raises(ValueError):
        on_cuda(x)
    with pytest.raises(ValueError):
        norms.rms_norm(x, torch.empty(64, device="meta"))
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)
