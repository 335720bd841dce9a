"""Parity of the port's loss and norm ops (ray_tpu_torch.ops.losses,
ray_tpu_torch.ops.norms) with the JAX package's, values and gradients.

Inputs are f32, made from a numpy seed and fed to both packages. These
are the cases of `tests/test_ops.py` (`test_rms_norm_grad`,
`test_layer_norm_basic`, `test_softmax_cross_entropy*`) run on both
sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import losses as jlosses
from ray_tpu.ops import norms as jnorms
from ray_tpu_torch.ops import losses, norms


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("rows", [8, 256, 300])
def test_rms_norm_grads_match_jax(rows):
    """d/dx and d/dw of sum(rms_norm(x, w) * g): JAX's custom VJP (the
    reference recomputed) against the port's Function; f32: 1e-5."""
    rng = _rng(rows)
    x = (3 * rng.standard_normal((rows, 64))).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((rows, 64)).astype(np.float32)
    want = jax.grad(lambda x_, w_: jnp.sum(jnorms.rms_norm(x_, w_, 1e-5)
                                           * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = torch.autograd.grad(
        (norms.rms_norm(xt, wt, 1e-5) * torch.from_numpy(g)).sum(), (xt, wt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_rms_norm_grad_of_x_alone():
    """The backward returns no gradient for an input that needs none."""
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.zeros(16)
    (gx,) = torch.autograd.grad(norms.rms_norm(x, w).square().sum(), x)
    xr = x.detach().requires_grad_()
    (gr,) = torch.autograd.grad(
        norms.rms_norm_reference(xr, w).square().sum(), xr)
    torch.testing.assert_close(gx, gr, atol=1e-6, rtol=1e-6)


def test_rms_norm_takes_a_bf16_weight_on_the_cpu():
    """A bf16 weight is read in f32, as the JAX kernel casts it."""
    rng = _rng(4)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal(32)).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = norms.rms_norm(torch.from_numpy(x), wb, 1e-5)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16),
                           1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ----------------------------------------------------------- layernorm
def test_layer_norm_matches_jax():
    rng = _rng(5)
    x = (2 * rng.standard_normal((4, 32)) + 1).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = jnorms.layer_norm(*map(jnp.asarray, (x, w, b)))
    got = norms.layer_norm(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    unit = norms.layer_norm(torch.from_numpy(x), torch.ones(32),
                            torch.zeros(32)).numpy()
    np.testing.assert_allclose(unit.mean(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(unit.std(-1), 1.0, atol=1e-2)


# ------------------------------------------------------- cross-entropy
def _ce_inputs(seed, shape=(4, 8), vocab=32, scale=3.0):
    rng = _rng(seed)
    logits = (scale * rng.standard_normal((*shape, vocab))).astype(
        np.float32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_value_and_grad_match_jax(masked, z_loss):
    """Mean and per-token loss, and the gradient of the mean, with and
    without a mask and z_loss; f32: 1e-5 (values), 1e-6 abs (grads)."""
    logits, labels = _ce_inputs(11 + masked)
    mask = (_rng(3).random((4, 8)) < 0.6).astype(np.float32) if masked \
        else None

    def jfn(lg):
        return jlosses.softmax_cross_entropy(
            lg, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), z_loss)
    jmean, jper = jfn(jnp.asarray(logits))
    jgrad = jax.grad(lambda lg: jfn(lg)[0])(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    mean, per = losses.softmax_cross_entropy(
        lt, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), z_loss)
    (grad,) = torch.autograd.grad(mean, lt)
    assert mean.shape == () and per.shape == (4, 8)
    np.testing.assert_allclose(mean.item(), float(jmean), rtol=1e-5)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6,
                               rtol=1e-5)


def test_softmax_cross_entropy_is_log_softmax_and_masks():
    """Per-token loss is -log_softmax at the label; a mask averages over
    its ones only (the cases of test_softmax_cross_entropy and
    test_softmax_cross_entropy_mask)."""
    logits, labels = _ce_inputs(0, scale=1.0)
    lt, lb = torch.from_numpy(logits), torch.from_numpy(labels).long()
    _, per = losses.softmax_cross_entropy(lt, lb)
    want = -torch.log_softmax(lt, -1).gather(-1, lb[..., None])[..., 0]
    torch.testing.assert_close(per, want, atol=1e-5, rtol=1e-5)
    mask = torch.zeros(4, 8)
    mask[0, :2] = mask[1, :1] = 1
    loss, per = losses.softmax_cross_entropy(lt, lb, mask)
    torch.testing.assert_close(loss, (per * mask).sum() / 3.0)
    zero, _ = losses.softmax_cross_entropy(lt, lb, torch.zeros(4, 8))
    assert zero.item() == 0.0                      # denominator floor of 1


def test_softmax_cross_entropy_grad_has_no_argmax_spike():
    """No detach on the max: the gradient equals autograd through
    log_softmax (a half-stopped max would add one_hot(argmax))."""
    logits, labels = _ce_inputs(2)
    lt = torch.from_numpy(logits).requires_grad_()
    lb = torch.from_numpy(labels).long()
    (g1,) = torch.autograd.grad(losses.softmax_cross_entropy(lt, lb)[0], lt)
    (g2,) = torch.autograd.grad(
        -torch.log_softmax(lt, -1).gather(-1, lb[..., None]).mean(), lt)
    torch.testing.assert_close(g1, g2, atol=1e-6, rtol=1e-5)


# ----------------------------------------------------- chunked LM loss
@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (7, 32)])
def test_chunked_lm_loss_matches_dense_and_jax(s, chunk):
    """Ragged s (a padded last chunk, and one chunk longer than s): the
    chunked loss and its grads equal the dense loss's, and the JAX
    chunked loss; f32: 1e-5."""
    rng = _rng(s)
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    head = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.7).astype(np.float32)
    want = jlosses.chunked_lm_loss(*map(jnp.asarray, (x, head, labels,
                                                      mask)), chunk_size=chunk)
    xt, ht = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    lt, mt = torch.from_numpy(labels), torch.from_numpy(mask)
    got = losses.chunked_lm_loss(xt, ht, lt, mt, chunk_size=chunk)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    dense, _ = losses.softmax_cross_entropy(xt @ ht, lt, mt)
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=1e-5)
    g_chunk = torch.autograd.grad(got, (xt, ht))
    g_dense = torch.autograd.grad(dense, (xt, ht))
    for a, b in zip(g_chunk, g_dense):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
