"""Sharded training of the port's Transformer on gloo CPU ranks: twins of
`tests/test_models.py::test_sharded_train_step_runs_and_matches_single`,
`tests/test_ops.py::test_sharded_cross_entropy_matches_dense` and the
dry-run cases of `tests/test_graft_entry.py`, with one fast 2-rank
`dryrun_multichip` sibling per parallel axis (fsdp, tp, sp, ep).

The JAX cases run on 8 virtual devices; here on a module-scoped pool of 4
gloo ranks (`torch_ranks.RankPool`). The 8-rank twin of
`test_dryrun_multichip_8` spawns its own ranks and is `slow`, as its JAX
twin is.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ray_tpu.ops.losses import softmax_cross_entropy as jsoftmax_ce
from ray_tpu.parallel import prepare_mesh as jprepare_mesh
from ray_tpu_torch import dryrun
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.ops.losses import softmax_cross_entropy
from ray_tpu_torch.parallel import MeshSpec

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import RankPool  # noqa: E402

RANKS = 4


@pytest.fixture(scope="module", autouse=True)
def ranks():
    # autouse: the ranks start with the module's first test, and the
    # first case that runs on them waits for whatever is left of it
    pool = RankPool(RANKS)
    yield pool
    pool.close()


def test_mesh_specs_cover_all_axes():
    axes_seen = set()
    for spec in dryrun._mesh_specs_for(8):
        shape = dict(zip(("pp", "dp", "fsdp", "sp", "ep", "tp"),
                         spec.resolve(8)))
        axes_seen |= {a for a, s in shape.items() if s > 1}
    assert {"dp", "fsdp", "tp", "sp", "pp", "ep"} <= axes_seen


def test_scaling_config_takes_a_mesh_spec():
    """`ScalingConfig.mesh` stores a MeshSpec, as the JAX package's does;
    the loop builds its DeviceMesh with `prepare_mesh`."""
    from ray_tpu_torch.train import ScalingConfig
    spec = MeshSpec(dp=2, tp=2)
    assert ScalingConfig(num_workers=4, mesh=spec).mesh == spec


def test_sharded_cross_entropy_matches_dense(ranks):
    """CE with the vocab split over tp against the dense CE of both
    packages: loss to 1e-5 relative, per-token to 1e-5 (the JAX case's),
    and the gradient of the mean loss, each rank's vocab slice, against
    the dense one (1e-6 absolute). JAX: tp=8 slices of 8 over vocab 64;
    here tp=4 slices of 16 over the same 64."""
    vocab, shard = 64, 16
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 16, vocab)).astype(np.float32)
    labels = rng.integers(0, vocab, (4, 16))
    t_logits = torch.tensor(logits, requires_grad=True)
    dense_loss, dense_per = softmax_cross_entropy(t_logits,
                                                  torch.as_tensor(labels))
    dense_loss.backward()
    jloss, jper = jsoftmax_ce(jnp.asarray(logits), jnp.asarray(labels))
    # and the JAX sharded version on its own mesh, the same numbers
    from ray_tpu.ops.losses import sharded_softmax_cross_entropy as jsharded
    mesh = jprepare_mesh(tp=4, devices=jax.devices()[:4])
    fn = jax.shard_map(
        lambda lg, lb: jsharded(lg, lb, "tp", shard), mesh=mesh,
        in_specs=(P(None, None, "tp"), P(None, None)),
        out_specs=(P(), P(None, None)), check_vma=False)
    jl, _ = fn(jnp.asarray(logits), jnp.asarray(labels))
    got = ranks.run(RANKS, _sharded_ce, logits, labels, shard)
    for loss, per_tok, _ in got:
        np.testing.assert_allclose(loss, float(dense_loss.detach()),
                                   rtol=1e-5)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        np.testing.assert_allclose(per_tok, dense_per.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(per_tok, np.asarray(jper), atol=1e-5,
                                   rtol=1e-5)
    grad = np.concatenate([g for _, _, g in got], axis=-1)
    np.testing.assert_allclose(grad, t_logits.grad.numpy(), atol=1e-6)
    np.testing.assert_allclose(got[0][0], float(jl), rtol=1e-5)


def _sharded_loss(tokens):
    from ray_tpu_torch.models.config import tiny
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.parallel import (param_shardings, prepare_mesh,
                                        shard_pytree)
    mesh = prepare_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    model = Transformer(tiny(), mesh=mesh)
    params = Transformer(tiny()).init(0, "cpu")
    sharded = shard_pytree(params, param_shardings(
        mesh, model.param_logical_axes()))
    tokens = torch.as_tensor(tokens)
    return (float(model.loss(sharded, {"tokens": tokens})),
            float(Transformer(tiny()).loss(params, {"tokens": tokens})))


def test_sharded_train_step_runs_and_matches_single(ranks):
    """The loss of tiny() with parameters placed by `param_shardings` on a
    mesh against the same parameters in one process, 1e-4 relative (the
    JAX case's). JAX: dp=2, fsdp=2, tp=2 over 8 devices; here fsdp=2,
    tp=2 over 4 ranks: embed over fsdp, heads/mlp/vocab over tp, the
    batch over fsdp (dp alone is the dryrun siblings')."""
    tokens = np.random.default_rng(1).integers(0, tiny().vocab_size, (4, 32))
    for sharded, local in ranks.run(RANKS, _sharded_loss, tokens):
        np.testing.assert_allclose(sharded, local, rtol=1e-4)


def _sharded_ce(logits, labels, shard):
    import torch.distributed as dist

    from ray_tpu_torch.ops.losses import sharded_softmax_cross_entropy
    from ray_tpu_torch.parallel import prepare_mesh
    mesh = prepare_mesh(MeshSpec(tp=RANKS), device="cpu")
    r = dist.get_rank()
    local = torch.tensor(logits[..., r * shard:(r + 1) * shard],
                         requires_grad=True)
    loss, per_tok = sharded_softmax_cross_entropy(
        local, torch.as_tensor(labels), "tp", shard, mesh=mesh)
    loss.backward()
    return float(loss.detach()), per_tok.detach().numpy(), local.grad.numpy()


@pytest.mark.parametrize("axes", [dict(fsdp=2), dict(tp=2), dict(sp=2),
                                  dict(ep=2), dict(pp=2)],
                         ids=["fsdp", "tp", "sp", "ep", "pp"])
def test_dryrun_two_rank_sibling(ranks, axes):
    """Three AdamW steps of the dry run's model on a 2-rank mesh with one
    parallel axis (ring attention on sp, the MoE model on ep, the GPipe
    schedule with 2 microbatches on pp) against one
    process, at the JAX function's tolerances: loss 2e-3, grad norm 5e-3,
    relative (`dryrun.check_spec` raises past them)."""
    res = ranks.run(2, dryrun.check_spec, MeshSpec(**axes))
    r = res[0]
    assert r["mesh"][next(iter(axes))] == 2
    for l, rl in zip(r["losses"], r["ref_losses"]):
        assert abs(l - rl) <= dryrun.LOSS_RTOL * max(1.0, abs(rl))
    assert r["losses"][-1] < r["losses"][0]
    if "ep" in axes:
        assert dataclasses.asdict(dryrun.config_for(r["mesh"]))[
            "moe_num_experts"] == 4


@pytest.mark.slow
def test_dryrun_multichip_8():
    results = dryrun.dryrun_multichip(8)
    assert len(results) == len(dryrun._mesh_specs_for(8))


def _pipeline_mesh_refused():
    import dataclasses

    from ray_tpu_torch.models.config import tiny
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.parallel import prepare_mesh
    mesh = prepare_mesh(MeshSpec(pp=2, dp=1), device="cpu")
    cfg = dataclasses.replace(tiny(), pipeline_microbatches=2,
                              moe_num_experts=2, moe_top_k=1)
    model = Transformer(cfg, mesh=mesh)      # a pp mesh is taken now
    tokens = torch.zeros((2, 8), dtype=torch.long)
    msgs = []
    for positions in (None, torch.arange(8).expand(2, 8)):
        try:
            model.hidden({"embed": torch.zeros(cfg.vocab_size, 64)},
                         tokens, positions)
        except NotImplementedError as e:
            msgs.append(str(e))
        model = Transformer(dataclasses.replace(cfg, moe_num_experts=0),
                            mesh=mesh)
    return msgs


def test_a_pipeline_mesh_is_refused_naming_its_item(ranks):
    """A Transformer takes a pp mesh since the pipeline was ported
    (ROADMAP queue 1, item 9); it refuses what the JAX model refuses
    there, each with the JAX message: an MoE model with pipeline
    microbatches, and custom positions
    (`ray_tpu/models/transformer.py:261-291`)."""
    for msgs in ranks.run(2, _pipeline_mesh_refused):
        assert len(msgs) == 2
        assert "MoE + pipeline" in msgs[0]
        assert "default positions" in msgs[1]


def _chunked_mesh_loss(jtree, tokens, spec):
    from ray_tpu_torch.models.config import tiny
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.parallel import (param_shardings, prepare_mesh,
                                        shard_pytree)
    from ray_tpu_torch.parallel.sharding import sync_grads, tree_map
    cfg = dataclasses.replace(tiny(), loss_chunk=16)
    mesh = prepare_mesh(MeshSpec(**spec), device="cpu")
    model = Transformer(cfg, mesh=mesh)
    params = shard_pytree(params_from_jax(jtree, cfg, "cpu"),
                          param_shardings(mesh, model.param_logical_axes()))
    tree_map(lambda p: p.requires_grad_(True), params)
    loss = model.loss(params, {"tokens": torch.as_tensor(tokens)})
    loss.backward()
    sync_grads(params)
    g = tree_map(lambda p: p.grad.full_tensor().numpy(), params)
    layers = {k: np.stack([lay[k] for lay in g["layers"]])
              for k in g["layers"][0]}
    return float(loss.detach()), dict(g, layers=layers)


@pytest.mark.parametrize("spec", [dict(dp=2), dict(tp=2)],
                         ids=["dp", "tp"])
def test_chunked_loss_on_a_mesh_matches_the_jax_loss(ranks, spec):
    """`Transformer.loss` with `loss_chunk=16` on a 2-rank mesh (ROADMAP
    queue 3, item 18: it raised): the chunked CE runs on each rank's rows
    inside `local_map`, over the vocab split on tp. Held to the JAX
    model's chunked loss at tiny() with the same weights
    (`params_from_jax`): loss 1e-5 relative, grads 1e-4 relative / 1e-5
    absolute."""
    from ray_tpu.models import Transformer as JTransformer
    from ray_tpu.models.config import tiny as jtiny
    jcfg = dataclasses.replace(jtiny(), loss_chunk=16)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, (4, 32))
    j_loss, j_grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    jtree = jax.tree_util.tree_map(np.asarray, jparams)
    for loss, grads in ranks.run(2, _chunked_mesh_loss, jtree, tokens, spec):
        np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
        for path, ref in jax.tree_util.tree_leaves_with_path(j_grads):
            got = grads
            for key in path:
                got = got[key.key]
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                       atol=1e-5, err_msg=str(path))
