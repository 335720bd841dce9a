"""Ring attention of the port (`ray_tpu_torch.ops.ring_attention`) on
gloo CPU ranks: twins of the ring cases of `tests/test_ops.py` and
`tests/test_models.py`, and the port's ring against the JAX ring on the
same numpy inputs, outputs and grads.

The JAX cases run on 8 virtual devices; here on a module-scoped pool of 4
gloo ranks (`torch_ranks.RankPool`). Where a JAX case used all 8, its
twin keeps the axes the case made nontrivial at size 2 or 4 (each says
which); the ring's arithmetic does not depend on the ring's length
beyond the number of chunks it merges.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ray_tpu.models.config import TransformerConfig as JConfig
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.ops.attention import mha_reference as jmha_reference
from ray_tpu.ops.ring_attention import ring_attention as jring_attention
from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops.attention import mha_reference

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


def test_ring_attention_is_plain_torch_without_a_card():
    """The chunk and merge run on CPU tensors with no kernel: one rank's
    chunk against its own keys equals causal attention."""
    from ray_tpu_torch.ops.ring_attention import _chunk_attention, _merge
    q, k, v = (torch.as_tensor(t) for t in _qkv(3, 1, 2, 1, 16, 8))
    o, lse = _chunk_attention(q, k, v, 0, 0, True, 8 ** -0.5)
    empty_o = torch.zeros_like(o)
    empty_lse = torch.full_like(lse, float("-inf"))
    merged, merged_lse = _merge(empty_o, empty_lse, o, lse)
    torch.testing.assert_close(merged, mha_reference(q, k, v), atol=1e-5,
                               rtol=1e-4)
    torch.testing.assert_close(merged_lse, lse)


def test_ring_attention_against_the_jax_ring_outputs_and_grads(ranks):
    """The same numpy q/k/v through the JAX ring (shard_map over sp=4 of
    the virtual devices) and the port's ring on 4 gloo ranks: outputs and
    the grads of sum(out ** 2), each f32, to 1e-5 absolute / 1e-4
    relative (the two sum the chunk einsums in different orders)."""
    q, k, v = _qkv(21, 2, 4, 2, 32, 8)
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    spec = P(None, None, "sp", None)
    fn = jax.shard_map(lambda q_, k_, v_: jring_attention(q_, k_, v_),
                       mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                       check_vma=False)
    jout = jax.jit(fn)(q, k, v)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                              argnums=(0, 1, 2)))(q, k, v)
    parts = ranks.run(RANKS, _ring_local, q, k, v, 4)
    np.testing.assert_allclose(_cat(parts, 0), np.asarray(jout), atol=1e-5,
                               rtol=1e-4)
    for i, jg in enumerate(jgrads, start=1):
        np.testing.assert_allclose(_cat(parts, i), np.asarray(jg),
                                   atol=1e-5, rtol=1e-4)


def _qkv(seed, b, h, kvh, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d), np.float32),
            rng.standard_normal((b, kvh, s, d), np.float32),
            rng.standard_normal((b, kvh, s, d), np.float32))


def _ring_sharded(q, k, v, axes, causal=True, bare_sp=False):
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel import MeshSpec, prepare_mesh
    if bare_sp:
        mesh = init_device_mesh("cpu", (axes["sp"],), mesh_dim_names=("sp",))
    else:
        mesh = prepare_mesh(MeshSpec(**axes), device="cpu")
    out = ring_attention_sharded(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), mesh, causal=causal)
    return out.full_tensor().numpy()


def _want(q, k, v, causal=True):
    return mha_reference(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v), causal=causal).numpy()


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_reference(ranks, causal):
    # JAX: sp=8 over s=64; here sp=4 (4 chunks of 16), and the port's
    # result is held to the JAX reference as well as the port's
    q, k, v = _qkv(5, 1, 2, 2, 64, 16)
    jwant = jmha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
    got = ranks.run(RANKS, _ring_sharded, q, k, v, {"sp": 4}, causal)[0]
    np.testing.assert_allclose(got, _want(q, k, v, causal), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jwant), atol=1e-5, rtol=1e-4)


def _ring_local(q, k, v, sp):
    """`ring_attention` on each rank's sequence shard (the shard_map body
    of the JAX case), with grads of sum(out ** 2)."""
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.parallel import MeshSpec, prepare_mesh
    import torch.distributed as dist
    mesh = prepare_mesh(MeshSpec(sp=sp), device="cpu")
    r, s = dist.get_rank(), q.shape[2] // sp
    ql, kl, vl = (torch.tensor(t[:, :, r * s:(r + 1) * s], requires_grad=True)
                  for t in (q, k, v))
    out = ring_attention(ql, kl, vl, mesh=mesh)
    out.square().sum().backward()
    return (out.detach().numpy(), ql.grad.numpy(), kl.grad.numpy(),
            vl.grad.numpy())


def _cat(parts, i):
    return np.concatenate([p[i] for p in parts], axis=2)


def test_ring_attention_gqa(ranks):
    b, h, kvh, s, d = 1, 4, 2, 32, 8
    q, k, v = _qkv(9, b, h, kvh, s, d)
    parts = ranks.run(RANKS, _ring_local, q, k, v, 4)
    np.testing.assert_allclose(_cat(parts, 0), _want(q, k, v), atol=1e-5,
                               rtol=1e-4)


def test_ring_sharded_gqa_with_tp(ranks):
    # JAX: tp=4, sp=2 over 8 devices; here tp=2, sp=2: heads and K/V
    # heads split over tp (2 | 2), the sequence over the ring
    q, k, v = _qkv(17, 1, 4, 2, 32, 8)
    got = ranks.run(RANKS, _ring_sharded, q, k, v, {"tp": 2, "sp": 2})[0]
    np.testing.assert_allclose(got, _want(q, k, v), atol=1e-5, rtol=1e-4)


def test_ring_sharded_custom_mesh_without_standard_axes(ranks):
    """Specs are built from the axes the mesh has: a bare 1-D ("sp",)
    mesh of 4 ranks."""
    q, k, v = _qkv(19, 1, 2, 2, 64, 16)
    got = ranks.run(RANKS, _ring_sharded, q, k, v, {"sp": 4}, True, True)[0]
    np.testing.assert_allclose(got, _want(q, k, v), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("h,kvh", [
    (8, 1),    # MQA: the single K/V head read whole by every rank
    (12, 3),   # kvh % tp != 0, kvh > 1: each rank picks its heads' K/V
])
def test_ring_sharded_gqa_nondivisible_tp(ranks, h, kvh):
    # JAX: tp=2, sp=2, dp=2 over 8 devices; here tp=2, sp=2 over 4 ranks
    # (batch 2 stays whole; the K/V heads do not split over tp, which is
    # what the case is about)
    q, k, v = _qkv(23, 2, h, kvh, 32, 8)
    got = ranks.run(RANKS, _ring_sharded, q, k, v, {"tp": 2, "sp": 2})[0]
    np.testing.assert_allclose(got, _want(q, k, v), atol=1e-5, rtol=1e-4)


def _model_logits(cfg_dict, tree, tokens, sp):
    from ray_tpu_torch.models.config import TransformerConfig
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.parallel import (MeshSpec, param_shardings,
                                        prepare_mesh, shard_pytree)
    cfg = TransformerConfig(**cfg_dict)
    mesh = prepare_mesh(MeshSpec(sp=sp), device="cpu")
    model = Transformer(cfg, mesh=mesh)
    params = shard_pytree(params_from_jax(tree, cfg, device="cpu"),
                          param_shardings(mesh, model.param_logical_axes()))
    return model.apply(params, torch.as_tensor(tokens)).full_tensor().numpy()


def test_ring_attention_model_matches_flash(ranks):
    """The model with `use_ring_attention` on an sp=4 mesh against the
    same model without a mesh (flash attention), on the JAX case's
    config and tolerance, and against the JAX model's logits."""
    kw = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
              n_kv_heads=2, d_ff=64, max_seq_len=64, remat=False,
              dtype="float32", param_dtype="float32",
              use_ring_attention=True)
    jmodel = JTransformer(JConfig(**{**kw, "use_ring_attention": False}))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(1).integers(0, 64, (2, 32))
    ring = ranks.run(RANKS, _model_logits, kw, tree, tokens, 4)[0]
    cfg = TransformerConfig(**{**kw, "use_ring_attention": False})
    from ray_tpu_torch.models.transformer import Transformer
    flash = Transformer(cfg).apply(params_from_jax(tree, cfg, device="cpu"),
                                   torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(ring, flash, atol=2e-4, rtol=1e-3)
    jlogits = jax.jit(jmodel.apply)(jparams, jnp.asarray(tokens))
    np.testing.assert_allclose(ring, np.asarray(jlogits), atol=2e-4,
                               rtol=1e-3)

