"""The port's SPMD pipeline (`ray_tpu_torch.parallel.pipeline`) on gloo
CPU ranks: twins of the three pipeline cases of `tests/test_parallel.py`
(GPipe through the Transformer on a pp mesh; the
validation errors; 1F1B against direct autodiff), and `pipeline_apply` /
`pipeline_grads_1f1b` on pp=2 and pp=4 against the JAX functions,
including an uneven `layer_fn` stack (the JAX case of that is
`tests/test_pipeline_mpmd.py::test_spmd_pipeline_uneven_layer_fn_parity`).

The JAX cases run on the 8 virtual CPU devices `tests/conftest.py` gives
JAX; here each pp stage is a process of a module-scoped pool of 8 gloo
ranks (`torch_ranks.RankPool`). Inputs come from numpy seeds, in f32.
The JAX pp-meshed Transformer takes ~25 s to compile, so the Transformer
cases are held to the JAX model without a mesh (the JAX case holds the
two to 1e-5), and a `slow` sibling holds the JAX case's dp=2, pp=2,
tp=2 mesh to the JAX pp-meshed model.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.models import Transformer as JTransformer
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from ray_tpu.parallel.pipeline import \
    pipeline_grads_1f1b as jpipeline_grads_1f1b
from ray_tpu_torch.parallel import MeshSpec

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import RankPool  # noqa: E402

RANKS = 8


@pytest.fixture(scope="module", autouse=True)
def ranks():
    pool = RankPool(RANKS)
    yield pool
    pool.close()


# -------------------------------------------------- MLP stack fixtures
def _mlp(L, D, B, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(L, D, D)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(L, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    t = rng.normal(size=(B, D)).astype(np.float32)
    return {"w": w, "b": b}, x, t


def _jstage(p, h):
    def layer(h, wb):
        w, b = wb
        return jnp.tanh(h @ w + b), None
    h, _ = jax.lax.scan(layer, h, (p["w"], p["b"]))
    return h


def _jlayer(lp, h):
    return jnp.tanh(h @ lp["w"] + lp["b"])


def _jloss(y, t):
    return jnp.sum((y - t) ** 2)


def _tstage(p, h):
    for i in range(p["w"].shape[0]):
        h = torch.tanh(h @ p["w"][i] + p["b"][i])
    return h


def _tlayer(lp, h):
    return torch.tanh(h @ lp["w"] + lp["b"])


def _port_pipeline(S, M, params, x, t, uneven):
    """On each of S ranks: pipeline_apply's output and the grads of
    sum(out**2) (params and x), and pipeline_grads_1f1b's loss and
    grads."""
    from ray_tpu_torch.parallel import prepare_mesh
    from ray_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                 pipeline_grads_1f1b)
    mesh = prepare_mesh(MeshSpec(pp=S), device="cpu")
    kw = {"layer_fn": _tlayer} if uneven else {}
    stage = None if uneven else _tstage
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xx = torch.tensor(x, requires_grad=True)
    out = pipeline_apply(mesh, stage, p, xx, M, **kw)
    (out ** 2).sum().backward()
    loss, grads = pipeline_grads_1f1b(
        mesh, stage, lambda y, tt: ((y - tt) ** 2).sum(),
        {k: torch.tensor(v) for k, v in params.items()},
        torch.tensor(x), torch.tensor(t), M, **kw)
    return (out.detach().numpy(), {k: v.grad.numpy() for k, v in p.items()},
            xx.grad.numpy(), float(loss), {k: v.numpy()
                                           for k, v in grads.items()})


@pytest.mark.parametrize("S,M,L,uneven", [(2, 4, 8, False),
                                          (4, 8, 8, False),
                                          (4, 4, 7, True)],
                         ids=["pp2", "pp4", "pp4-uneven"])
def test_spmd_pipeline_matches_the_jax_functions(ranks, S, M, L, uneven):
    """pipeline_apply (output; grads of sum(out**2) in the params and x)
    and pipeline_grads_1f1b (loss, grads) on S gloo ranks against the
    JAX functions on S virtual devices: outputs 1e-5, loss 1e-5
    relative, grads 1e-4 relative / 1e-6 absolute (the JAX cases'). The
    uneven case runs 7 layers on 4 stages through `layer_fn` (the last
    stage takes 4)."""
    D, B = 8, 16
    params, x, t = _mlp(L, D, B, seed=S + L)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    mesh = Mesh(np.array(jax.devices()[:S]).reshape(S), ("pp",))
    kw = {"layer_fn": _jlayer} if uneven else {}
    stage = None if uneven else _jstage

    def jout(p, xx):
        return jpipeline_apply(mesh, stage, p, xx, M, **kw)
    j_out, j_vjp = jax.vjp(jout, jp, jnp.asarray(x))
    j_gp, j_gx = j_vjp(2.0 * j_out)
    j_loss, j_grads = jpipeline_grads_1f1b(
        mesh, stage, _jloss, jp, jnp.asarray(x), jnp.asarray(t), M, **kw)
    results = ranks.run(S, _port_pipeline, S, M, params, x, t, uneven)
    for out, gp, gx, loss, grads in results:      # the same on every rank
        np.testing.assert_allclose(out, np.asarray(j_out), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(gx, np.asarray(j_gx), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(gp[k], np.asarray(j_gp[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(grads[k], np.asarray(j_grads[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def _port_1f1b(S, M, params, x, t):
    from ray_tpu_torch.parallel import prepare_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_grads_1f1b
    mesh = prepare_mesh(MeshSpec(pp=S), device="cpu")
    loss, grads = pipeline_grads_1f1b(
        mesh, _tstage, lambda y, tt: ((y - tt) ** 2).sum(),
        {k: torch.tensor(v) for k, v in params.items()},
        torch.tensor(x), torch.tensor(t), M)
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def test_pipeline_1f1b_parity_with_direct_autodiff(ranks):
    """The twin of the JAX case: the 1F1B schedule's loss AND grads match
    plain autodiff of the unpipelined stack (here JAX's value_and_grad of
    the same stack, on the same numpy inputs), across stage counts and
    microbatch counts (incl. M close to S): loss 1e-5 relative, grads
    1e-4 relative / 1e-6 absolute."""
    L, D, B = 8, 12, 24
    params, x, t = _mlp(L, D, B)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for S, M in ((2, 8), (4, 8), (4, 4), (8, 4)):
        def full_loss(p, M=M):
            return jnp.sum((_jstage(p, jnp.asarray(x)) - t) ** 2) / M
        gt_loss, gt_grads = jax.value_and_grad(full_loss)(jp)
        for loss, grads in ranks.run(S, _port_1f1b, S, M, params, x, t):
            np.testing.assert_allclose(loss, float(gt_loss), rtol=1e-5)
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    grads[k], np.asarray(gt_grads[k]), rtol=1e-4,
                    atol=1e-6, err_msg=f"S={S} M={M} leaf={k}")


def _validation():
    from ray_tpu_torch.parallel import prepare_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, split_stages
    mesh = prepare_mesh(MeshSpec(pp=2), device="cpu")
    msgs = []
    for fn in (lambda: split_stages({"w": torch.zeros(3, 4)}, 2),
               lambda: pipeline_apply(mesh, lambda p, x: x,
                                      {"w": torch.zeros(2, 4)},
                                      torch.zeros(5, 4), 3)):
        try:
            fn()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def test_pipeline_validation_errors(ranks):
    """The twin of the JAX case: an uneven whole-stack split and a batch
    that does not divide into the microbatches raise ValueError (JAX:
    dp=4, pp=2 over 8 devices; here pp=2 over 2 ranks)."""
    for split_msg, mb_msg in ranks.run(2, _validation):
        assert split_msg is not None and "not divisible" in split_msg
        assert mb_msg is not None and "microbatches" in mb_msg


# ------------------------------------------------ the pp Transformer
def _jparams_and_tokens():
    cfg = dataclasses.replace(jtiny(), pipeline_microbatches=4)
    params = JTransformer(dataclasses.replace(
        cfg, pipeline_microbatches=0)).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 32))
    return cfg, jax.tree_util.tree_map(np.asarray, params), tokens


def _port_pp_transformer(jtree, tokens, spec):
    """Hidden states, loss and grads (layer-stacked, as the JAX tree is)
    of tiny() with pipeline_microbatches=4 on the mesh of `spec`."""
    from ray_tpu_torch.models.config import tiny
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.parallel import (param_shardings, prepare_mesh,
                                        shard_pytree)
    from ray_tpu_torch.parallel.sharding import sync_grads, tree_map
    cfg = dataclasses.replace(tiny(), pipeline_microbatches=4)
    mesh = prepare_mesh(MeshSpec(**spec), device="cpu")
    model = Transformer(cfg, mesh=mesh)
    params = shard_pytree(params_from_jax(jtree, cfg, "cpu"), param_shardings(
        mesh, model.param_logical_axes()))
    tokens = torch.as_tensor(tokens)
    with torch.no_grad():
        hidden = model.hidden(params, tokens).full_tensor().numpy()
    tree_map(lambda p: p.requires_grad_(True), params)
    loss = model.loss(params, {"tokens": tokens})
    loss.backward()
    sync_grads(params)
    g = tree_map(lambda p: p.grad.full_tensor().numpy(), params)
    layers = {k: np.stack([lay[k] for lay in g["layers"]])
              for k in g["layers"][0]}
    grads = {"embed": g["embed"], "final_norm": g["final_norm"],
             "layers": layers}
    if "lm_head" in g:
        grads["lm_head"] = g["lm_head"]
    return hidden, float(loss.detach()), grads


def _check_pp_transformer(results, j_hidden, j_loss, j_grads):
    flat_j = jax.tree_util.tree_leaves_with_path(j_grads)
    for hidden, loss, grads in results:
        np.testing.assert_allclose(hidden, np.asarray(j_hidden), atol=1e-5,
                                   rtol=1e-5)
        assert abs(loss - float(j_loss)) < 1e-5
        for path, ref in flat_j:
            got = grads
            for key in path:
                got = got[key.key]
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5,
                                       rtol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("spec", [dict(pp=2, tp=2), dict(dp=2, pp=2)],
                         ids=["pp2-tp2", "dp2-pp2"])
def test_gpipe_pipeline_matches_unpipelined_transformer(ranks, spec):
    """The twin of the JAX case: GPipe over pp=2 composed with another
    axis reproduces the plain transformer, hidden states 1e-5, loss 1e-5
    absolute, grads 1e-4 relative / 1e-5 absolute (the JAX case's). The
    port's pp-meshed model on gloo ranks, with the JAX weights through
    `params_from_jax`, against the JAX model without a mesh. The JAX
    case's dp=2, pp=2, tp=2 mesh is the `slow` sibling below: DTensor's
    sharding propagation over three nontrivial axes takes ~15 s on the
    ranks."""
    cfg, jtree, tokens = _jparams_and_tokens()
    ref = JTransformer(dataclasses.replace(cfg, pipeline_microbatches=0))
    jp = jax.tree_util.tree_map(jnp.asarray, jtree)
    tok = jnp.asarray(tokens, jnp.int32)
    j_hidden = jax.jit(ref.hidden)(jp, tok)
    j_loss, j_grads = jax.jit(jax.value_and_grad(ref.loss))(
        jp, {"tokens": tok})
    n = int(np.prod(list(spec.values())))
    _check_pp_transformer(
        ranks.run(n, _port_pp_transformer, jtree, tokens, spec),
        j_hidden, j_loss, j_grads)


@pytest.mark.slow        # the JAX pp-meshed model compiles for ~25 s
def test_gpipe_pipeline_matches_the_jax_pp_meshed_transformer(ranks):
    """As the fast cases, on the JAX case's dp=2, pp=2, tp=2 mesh (8
    ranks), against the JAX model on its own mesh of 8 virtual devices
    (GPipe through `shard_map`)."""
    cfg, jtree, tokens = _jparams_and_tokens()
    mesh = JMeshSpec(dp=2, pp=2, tp=2).build()
    pp_model = JTransformer(cfg, mesh=mesh)
    jp = jax.tree_util.tree_map(jnp.asarray, jtree)
    tok = jnp.asarray(tokens, jnp.int32)
    j_hidden = jax.jit(pp_model.hidden)(jp, tok)
    j_loss, j_grads = jax.value_and_grad(pp_model.loss)(jp,
                                                        {"tokens": tok})
    _check_pp_transformer(
        ranks.run(8, _port_pp_transformer, jtree, tokens,
                  dict(dp=2, pp=2, tp=2)),
        j_hidden, j_loss, j_grads)
