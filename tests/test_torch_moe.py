"""The port's Mixture-of-Experts FFN (`ray_tpu_torch.models.moe`) and the
MoE Transformer, held to the JAX package: `moe_ffn` on the same numpy
inputs (output, aux and which tokens each expert took), twins of the MoE
cases of `tests/test_models.py`, and the MoE model's loss and grads
against `jax.value_and_grad`. All f32, at tiny() size. Also the port's
own: the drop tally on the device and the layer's phase ranges."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.moe import moe_ffn as jmoe_ffn
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.moe import MOE_PARAM_AXES, expert_capacity, moe_ffn
from ray_tpu_torch.models.transformer import Transformer

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import RankPool  # noqa: E402

RANKS = 2


@pytest.fixture(scope="module", autouse=True)
def ranks():
    # autouse: the ranks start with the module's first test, and the
    # first case that runs on them waits for whatever is left of it
    pool = RankPool(RANKS)
    yield pool
    pool.close()


def _moe_inputs(seed, T=64, d=8, E=4, f=16, skew=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, T // 2, d), np.float32),
            rng.standard_normal((d, E), np.float32) * skew,
            rng.standard_normal((E, d, f), np.float32) * 0.1,
            rng.standard_normal((E, d, f), np.float32) * 0.1,
            rng.standard_normal((E, f, d), np.float32) * 0.1)


@pytest.mark.parametrize("capacity_factor,skew", [(1.25, 1.0), (0.5, 5.0)])
def test_moe_ffn_matches_jax_with_the_same_kept_tokens(capacity_factor,
                                                      skew):
    """Output and aux against the JAX `moe_ffn`, and the expert inputs
    `ein` (E, C, d), which the `constrain` hook sees on both sides: slot
    (e, c) holds the row of the token queued there, or zeros, so equal
    `ein` means each expert took the same tokens in the same slots (the
    k-major capacity order), dropped ones included. f32: 1e-5 absolute,
    1e-4 relative (einsum sum order)."""
    args = _moe_inputs(3, skew=skew)
    seen = {}

    def jrecord(a, axes):
        seen.setdefault("jax", []).append(np.asarray(a))
        return a

    def trecord(a, axes):
        seen.setdefault("torch", []).append(a.detach().numpy())
        return a

    jy, jaux = jmoe_ffn(*map(jnp.asarray, args), top_k=2,
                        capacity_factor=capacity_factor, constrain=jrecord)
    y, aux = moe_ffn(*map(torch.as_tensor, args), top_k=2,
                     capacity_factor=capacity_factor, constrain=trecord)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-4)
    for name in ("moe_load_balance_loss", "moe_dropped_fraction"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=1e-5, atol=1e-6)
    ein_j, ein_t = seen["jax"][0], seen["torch"][0]
    np.testing.assert_allclose(ein_t, ein_j, atol=1e-6, rtol=0)
    # the kept mask itself: which token rows sit in the slots, per expert
    xf = args[0].reshape(-1, args[0].shape[-1])
    for e in range(ein_j.shape[0]):
        rows_j = [int(np.argmin(np.abs(xf - r).sum(1))) for r in ein_j[e]
                  if np.abs(r).sum() > 0]
        rows_t = [int(np.argmin(np.abs(xf - r).sum(1))) for r in ein_t[e]
                  if np.abs(r).sum() > 0]
        assert rows_t == rows_j
    if capacity_factor < 1:
        assert float(aux["moe_dropped_fraction"]) > 0.1


def test_drop_tally_equals_the_dispatch_sum_fraction():
    """The dropped fraction is 1 - kept slots / (T k), and the device
    tally adds the same kept and assigned slots on every call: on a case
    that drops, both equal the fraction the one-hot dispatch's sum gives
    (each kept slot is one 1 of it), and a second call doubles the
    tally without changing its share."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.models.moe import route
    args = tuple(map(torch.as_tensor, _moe_inputs(0, skew=5.0)))
    x, router = args[0], args[1]
    T, k = x.shape[0] * x.shape[1], 2
    C = expert_capacity(T, router.shape[-1], k, 0.25)
    logits = x.reshape(T, -1) @ router
    disp = route(logits.to(torch.float32), k, C)[4]
    want = 1.0 - float(disp.sum(1).to(torch.float32).sum()) / (T * k)
    assert want > 0.1
    moe.reset_drop_tally()
    _, aux = moe_ffn(*args, top_k=k, capacity_factor=0.25)
    assert float(aux["moe_dropped_fraction"]) == pytest.approx(want,
                                                               abs=1e-7)
    tally = moe.drop_tally("cpu")
    assert tally["assigned"] == T * k
    assert tally["dropped"] == round(want * T * k)
    with torch.inference_mode():
        moe_ffn(*args, top_k=k, capacity_factor=0.25)
    assert moe.drop_tally("cpu") == {"dropped": 2 * tally["dropped"],
                                     "assigned": 2 * T * k}
    moe.reset_drop_tally()
    assert moe.drop_tally("cpu") == {"dropped": 0, "assigned": 0}


def test_moe_phases_are_ranges_only_under_grad():
    """`moe.route`, `moe.dispatch`, `moe.experts` and `moe.combine` are
    profiler ranges, in order, while grad mode is on; under
    `inference_mode` (a serving step) none opens."""
    sys.path.insert(0, os.path.dirname(__file__))
    from torch_profiler_ranges import user_ranges
    args = tuple(map(torch.as_tensor, _moe_inputs(1)))

    def call():
        moe_ffn(*args, top_k=2, capacity_factor=1.25)

    assert [n for n, _s, _e in user_ranges(call)] == [
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    with torch.inference_mode():
        assert user_ranges(call) == []


def test_moe_capacity_drops_tokens():
    """A tiny capacity factor must drop tokens (reported metric) while
    keeping outputs finite (dropped tokens ride the residual)."""
    x, router, gate, up, down = _moe_inputs(0, skew=5.0)
    out, aux = moe_ffn(*map(torch.as_tensor, (x, router, gate, up, down)),
                       top_k=2, capacity_factor=0.25)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert float(aux["moe_dropped_fraction"]) > 0.1
    assert expert_capacity(64, 4, 2, 0.25) == 8


def _moe_cfgs(E=4, cf=8.0):
    dense = tiny()
    return dense, dataclasses.replace(dense, moe_num_experts=E, moe_top_k=2,
                                      moe_capacity_factor=cf)


def test_moe_identical_experts_equals_dense():
    """With every expert holding the dense FFN's weights and renormalised
    top-k routing, the MoE block IS the dense block (sum_k w_k F(x) =
    F(x)); f32, 1e-5 absolute, as the JAX case."""
    dense_cfg, moe_cfg = _moe_cfgs()
    dp = Transformer(dense_cfg).init(0, "cpu")
    mp = Transformer(moe_cfg).init(0, "cpu")
    E = moe_cfg.moe_num_experts
    for dl, ml in zip(dp["layers"], mp["layers"]):
        for name, src in (("moe_gate", "gate"), ("moe_up", "up"),
                          ("moe_down", "down")):
            ml[name] = dl[src][None].expand((E,) + dl[src].shape)
        for k in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"):
            ml[k] = dl[k]
    for k in ("embed", "final_norm", "lm_head"):
        mp[k] = dp[k]
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, dense_cfg.vocab_size, (4, 32)))
    h_d = Transformer(dense_cfg).hidden(dp, tokens)
    h_m = Transformer(moe_cfg).hidden(mp, tokens)
    torch.testing.assert_close(h_m, h_d, atol=1e-5, rtol=0)


def _jax_moe_pair(cf=2.0, seed=3):
    jcfg = dataclasses.replace(jtiny(), moe_num_experts=4, moe_top_k=2,
                               moe_capacity_factor=cf)
    cfg = dataclasses.replace(tiny(), moe_num_experts=4, moe_top_k=2,
                              moe_capacity_factor=cf)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, jparams, tree, cfg


def test_moe_transformer_loss_and_grads_match_jax():
    """The MoE Transformer's loss (CE plus the load-balance term) and
    every gradient against `jax.value_and_grad` of the JAX model, with the
    JAX parameters carried over by `params_from_jax` (router and experts
    unstacked per layer). f32: loss to 1e-5 relative, grads to 1e-5
    absolute / 1e-4 relative."""
    jmodel, jparams, tree, cfg = _jax_moe_pair()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {"tokens": jnp.asarray(tokens)})
    params = params_from_jax(tree, cfg, device="cpu")
    leaves = [params["embed"], params["final_norm"], params["lm_head"]] + [
        t for layer in params["layers"] for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    loss = Transformer(cfg).loss(params, {"tokens": torch.as_tensor(tokens)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jg = jax.tree_util.tree_map(np.asarray, jgrads)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(params[name].grad.numpy(), jg[name],
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    for i, layer in enumerate(params["layers"]):
        for name, t in layer.items():
            np.testing.assert_allclose(t.grad.numpy(), jg["layers"][name][i],
                                       atol=1e-5, rtol=1e-4,
                                       err_msg=f"layer {i} {name}")
    assert float(np.abs(jg["layers"]["router"]).sum()) > 0


def test_moe_param_axes_and_init_follow_the_jax_tree():
    jmodel, jparams, tree, cfg = _jax_moe_pair()
    params = Transformer(cfg).init(0, "cpu")
    assert set(params["layers"][0]) == set(tree["layers"])
    for name, arr in tree["layers"].items():
        assert tuple(params["layers"][0][name].shape) == arr.shape[1:]
    axes = Transformer(cfg).param_logical_axes()["layers"][0]
    jaxes = jmodel.param_logical_axes()["layers"]
    assert {k: ("layers",) + v for k, v in axes.items()} == jaxes
    assert {k: axes[k] for k in MOE_PARAM_AXES} == MOE_PARAM_AXES


def _ep_hidden(cfg_dict, tree, tokens):
    from ray_tpu_torch.models.config import TransformerConfig
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.parallel import (MeshSpec, param_shardings,
                                        prepare_mesh, shard_pytree)
    from ray_tpu_torch.parallel.sharding import sync_grads
    cfg = TransformerConfig(**cfg_dict)
    mesh = prepare_mesh(MeshSpec(ep=2), device="cpu")
    model = Transformer(cfg, mesh=mesh)
    params = shard_pytree(params_from_jax(tree, cfg, device="cpu"),
                          param_shardings(mesh, model.param_logical_axes()))
    tokens = torch.as_tensor(tokens)
    h = model.hidden(params, tokens).full_tensor().numpy()
    for layer in params["layers"]:
        for t in layer.values():
            t.requires_grad_(True)
    loss = model.loss(params, {"tokens": tokens})
    loss.backward()
    sync_grads(params)
    router = [float(layer["router"].grad.full_tensor().norm())
              for layer in params["layers"]]
    finite = all(bool(torch.isfinite(t.grad.full_tensor()).all())
                 for layer in params["layers"] for t in layer.values())
    return h, float(loss), router, finite


def test_moe_ep_mesh_invariance_and_router_grads(ranks):
    """The same MoE model on an ep mesh matches the one-process hidden
    states (1e-5 absolute, as the JAX case); the router gets gradient
    through the load-balance loss and the combine weights. JAX: dp=2,
    ep=2, tp=2 over 8 devices; here ep=2 over 2 ranks, the experts split
    over ep (the dp and tp axes are the dense twins'; the 8-rank dry run
    runs MoE on dp=2, ep=2, tp=2)."""
    jmodel, jparams, tree, cfg = _jax_moe_pair(cf=2.0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
    h_one = Transformer(cfg).hidden(params_from_jax(tree, cfg, device="cpu"),
                                    torch.as_tensor(tokens)).numpy()
    h, loss, router, finite = ranks.run(
        RANKS, _ep_hidden, dataclasses.asdict(cfg), tree, tokens)[0]
    np.testing.assert_allclose(h, h_one, atol=1e-5)
    np.testing.assert_allclose(h, np.asarray(jax.jit(jmodel.hidden)(
        jparams, jnp.asarray(tokens))), atol=1e-5)
    assert np.isfinite(loss)
    assert all(r > 0 for r in router)
    assert finite
