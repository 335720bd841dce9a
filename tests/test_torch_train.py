"""Parity of the port's training path with the JAX package's: the LM loss
and its gradients, remat, AdamW steps, and the parameter dtypes.

JAX parameters are made from a seed at `tiny()` (f32), handed to the
port with `params_from_jax`, and both packages take the same tokens,
made with numpy. On the CPU the port's flash attention runs its plain
forward and backward; the JAX model runs its reference attention, as
its own CPU tests do. These are the cases of `tests/test_models.py`
(`test_forward_shapes_and_loss`, `test_grad_step_decreases_loss`,
`test_loss_mask`, `test_chunked_loss_matches_dense`,
`test_tied_embeddings`) run on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu_torch import bench
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import (cast_for_serving, init_for_serving,
                                          params_from_jax)
from ray_tpu_torch.models.transformer import Transformer


def _pair(seed=0, **overrides):
    jcfg = dataclasses.replace(jtiny(), **overrides)
    cfg = dataclasses.replace(tiny(), **overrides)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jmodel, jparams, Transformer(cfg), params


def _batch(seed, b=2, s=32, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32)}
    if mask:
        m = np.zeros((b, s), np.float32)
        m[:, 5:s - 3] = 1.0
        out["loss_mask"] = m
    return out


def _port_grads(model, params, batch):
    leaves = bench.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    return loss, dict(zip(_names(params), torch.autograd.grad(loss, leaves)))


def _names(params):
    names = ["embed"]
    for i, layer in enumerate(params["layers"]):
        names.extend(f"layers.{i}.{n}" for n in layer)
    names.append("final_norm")
    if "lm_head" in params:
        names.append("lm_head")
    return names


def _jax_by_name(tree, n_layers):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for i in range(n_layers):
        for n, arr in tree["layers"].items():
            out[f"layers.{i}.{n}"] = arr[i]
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    return out


# (name, config overrides, batch options)
LOSS_CASES = [
    ("untied", {}, {}),
    ("tied", {"tie_embeddings": True}, {}),
    ("loss_mask", {}, {"mask": True}),
    ("loss_chunk", {"loss_chunk": 16}, {"mask": True}),
    ("loss_chunk_ragged", {"loss_chunk": 24}, {}),
    ("remat", {"remat": True}, {}),
    ("remat_save_attn", {"remat": True, "remat_policy": "save_attn"}, {}),
]


@pytest.mark.parametrize("name,overrides,opts", LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_loss_and_grads_match_jax(name, overrides, opts):
    """`Transformer.loss` and the gradient of every leaf against
    `jax.value_and_grad(model.loss)`; f32 through 2 layers, sum order
    only: loss rtol 1e-5, grads atol 1e-5 (largest grads ~1e-1). Under
    `remat_save_attn` the port's checkpoint keeps the flash op's O and
    lse (the JAX model runs its off-TPU plain path)."""
    jmodel, jparams, model, params = _pair(seed=len(name), **overrides)
    batch = _batch(len(name), **opts)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(model, params, batch)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _jax_by_name(jgrads, model.config.n_layers)
    assert set(grads) == set(want)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]),
                                   atol=1e-5, rtol=1e-4, err_msg=key)


def test_random_init_loss_is_near_log_vocab_and_mask_matters():
    _, _, model, params = _pair()
    batch = {"tokens": torch.from_numpy(_batch(1)["tokens"])}
    full = model.loss(params, batch).item()
    assert abs(full - np.log(256)) < 1.0
    masked = dict(batch, loss_mask=torch.zeros(2, 32))
    masked["loss_mask"][:, :8] = 1.0
    assert not np.isclose(model.loss(params, masked).item(), full)


def test_chunked_loss_equals_dense_loss():
    """loss_chunk changes how the loss is computed, not its value."""
    _, _, dense, params = _pair(seed=3)
    chunked = Transformer(dataclasses.replace(tiny(), loss_chunk=16))
    for opts in ({}, {"mask": True}):
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(4, s=40, **opts).items()}
        torch.testing.assert_close(chunked.loss(params, batch),
                                   dense.loss(params, batch),
                                   atol=1e-6, rtol=1e-5)


def test_remat_reruns_each_layer_in_the_backward(monkeypatch):
    """remat=True runs every layer's forward again during the backward
    (and only once without a gradient); remat=False never reruns it."""
    _, _, _, params = _pair()
    batch = {"tokens": torch.from_numpy(_batch(2)["tokens"])}
    for remat, want in ((False, 2), (True, 4)):
        model = Transformer(dataclasses.replace(tiny(), remat=remat))
        calls = []
        orig = model._layer
        monkeypatch.setattr(model, "_layer",
                            lambda *a: calls.append(1) or orig(*a))
        for t in bench.leaves(params):
            t.requires_grad_(True)
        model.loss(params, batch).backward()
        assert len(calls) == want, remat
        calls.clear()
        with torch.no_grad():
            model.loss(params, batch)
        assert len(calls) == 2


@pytest.mark.parametrize("policy,want", [("full", 4), ("save_attn", 2)])
def test_save_attn_runs_the_attention_forward_once_per_layer(
        monkeypatch, policy, want):
    """In a loss-and-backward step of the 2-layer model, full remat runs
    each layer's flash forward twice (forward and recompute); save_attn
    keeps its O and lse across the checkpoint and runs it once. The
    loss and every grad are bitwise those of full remat, since the
    recompute reproduces the saved values exactly."""
    from ray_tpu_torch.ops import attention
    _, _, _, params = _pair(seed=4)
    batch = {"tokens": torch.from_numpy(_batch(4)["tokens"])}
    calls = []
    plain = attention.flash_attention_reference
    monkeypatch.setattr(attention, "flash_attention_reference",
                        lambda *a: calls.append(1) or plain(*a))
    out = {}
    for pol in ("full", policy):
        model = Transformer(dataclasses.replace(tiny(), remat=True,
                                                remat_policy=pol))
        leaves = bench.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        calls.clear()
        loss = model.loss(params, batch)
        out[pol] = (loss, torch.autograd.grad(loss, leaves))
    assert len(calls) == want
    (loss_full, g_full), (loss, grads) = out["full"], out[policy]
    assert torch.equal(loss, loss_full)
    assert all(torch.equal(a, b) for a, b in zip(grads, g_full))


def test_attn_remat_policy_replays_each_forward_in_order(monkeypatch):
    """A checkpointed region with two flash calls under
    `attn_remat_policy()`: the plain forward runs once per call, the
    recompute gets each call's own O and lse back, and a second backward
    through the kept graph (a second recompute) gets them again. Grads
    equal those of the region run without checkpoint, exactly."""
    from torch.utils.checkpoint import checkpoint

    from ray_tpu_torch.ops import attention
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 4, 12, 8, generator=gen) for _ in range(3))
    w = torch.randn(4, 4, generator=gen)

    def region(q, k, v):
        a = attention.flash_attention(q, k, v)
        b = attention.flash_attention(torch.einsum("gh,bhsd->bgsd", w, a),
                                      k, v, causal=False)
        return (a * b).sum()

    calls = []
    plain = attention.flash_attention_reference
    monkeypatch.setattr(attention, "flash_attention_reference",
                        lambda *a: calls.append(1) or plain(*a))
    for t in (q, k, v):
        t.requires_grad_(True)
    want = torch.autograd.grad(region(q, k, v), (q, k, v))
    calls.clear()
    loss = checkpoint(region, q, k, v, use_reentrant=False,
                      context_fn=attention.attn_remat_policy())
    for _ in range(2):
        got = torch.autograd.grad(loss, (q, k, v), retain_graph=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(calls) == 2


def test_three_adamw_steps_match_optax():
    """`bench.train_step` with `bench.make_optimizer` (torch AdamW) against
    `optax.adamw(1e-4)` on the same params and batch: losses rtol 1e-5;
    params atol 1e-6 after three steps (Adam divides by sqrt(v), so a
    grad that is ~0 carries its relative error into a step of up to the
    learning rate, 1e-4; 1e-6 is 1% of it)."""
    jmodel, jparams, model, params = _pair(seed=9)
    batch = _batch(9)
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    opt = optax.adamw(1e-4)

    @jax.jit
    def step(p, st):
        loss, g = jax.value_and_grad(jmodel.loss)(p, jbatch)
        updates, st = opt.update(g, st, p)
        return optax.apply_updates(p, updates), st, loss
    state = opt.init(jparams)
    jlosses = []
    for _ in range(3):
        jparams, state, loss = step(jparams, state)
        jlosses.append(float(loss))
    topt = bench.make_optimizer(params)
    tbatch = {"tokens": torch.from_numpy(batch["tokens"])}
    losses = [bench.train_step(model, params, topt, tbatch).item()
              for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    want = _jax_by_name(jparams, model.config.n_layers)
    for key, t in zip(_names(params), bench.leaves(params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[key]),
                                   atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_keep_the_parameter_dtype(param_dtype):
    """Every leaf, matmul weights included, is stored in param_dtype by
    `params_from_jax` and `init`, as the JAX tree keeps it; the forward
    casts at use. Only `cast_for_serving` moves the matmul weights to the
    activation dtype."""
    over = {"param_dtype": param_dtype, "dtype": "bfloat16"}
    _, jparams, model, params = _pair(**over)
    pd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    assert all(t.dtype == pd for t in bench.leaves(params))
    want = _jax_by_name(jparams, 2)
    for key, t in zip(_names(params), bench.leaves(params)):
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(want[key]).astype(np.float32),
            err_msg=key)
    assert all(t.dtype == pd
               for t in bench.leaves(model.init(0, device="cpu")))
    served = cast_for_serving(params, model.config)
    for key, t in zip(_names(served), bench.leaves(served)):
        assert t.dtype == (pd if key.endswith("norm") else torch.bfloat16)


def test_init_for_serving_equals_the_cast_of_init():
    cfg = dataclasses.replace(tiny(), dtype="bfloat16")
    model = Transformer(cfg)
    a = init_for_serving(model, 5, device="cpu")
    b = cast_for_serving(model.init(5, device="cpu"), cfg)
    for x, y in zip(bench.leaves(a), bench.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_bench_runs_tiny_on_the_cpu(capsys):
    out = bench.main(["--cpu"])
    assert out["backend"] == "cpu" and out["mfu"] is None
    assert out["params"] == tiny().num_params() and out["value"] > 0
    assert '"metric": "train_tokens_per_sec_per_chip"' in capsys.readouterr().out


def test_bench_config_is_the_root_bench_model():
    cfg = bench.bench_config()
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads,
            cfg.kv_heads, cfg.d_ff) == (32000, 2048, 16, 16, 16, 5632)
    assert (cfg.dtype, cfg.param_dtype, cfg.remat, cfg.loss_chunk) == \
        ("bfloat16", "bfloat16", False, 0)
    assert abs(cfg.num_params() - 0.953e9) < 1e6
