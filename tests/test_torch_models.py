"""Parity of the port's models (ray_tpu_torch.models) with the JAX package.

The JAX parameters are made from a seed, handed to the port through
`params_from_jax`, and both packages run the same tokens on `tiny()`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode as jdecode
from ray_tpu.models.config import PRESETS as JPRESETS
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu_torch.models import decode
from ray_tpu_torch.models.config import PRESETS, tiny
from ray_tpu_torch.models.convert import (cast_for_serving,
                                          params_from_jax)
from ray_tpu_torch.models.transformer import Transformer


def _pair(tied=False, seed=0):
    jcfg, cfg = jtiny(), tiny()
    if tied:
        jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
    jmodel = JTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jmodel, jparams, Transformer(cfg), params


def test_config_presets_match_jax():
    assert set(PRESETS) == set(JPRESETS)
    for name in PRESETS:
        a, b = dataclasses.asdict(PRESETS[name]()), \
            dataclasses.asdict(JPRESETS[name]())
        assert a == b, name
        assert PRESETS[name]().activation_dtype == {
            "bfloat16": torch.bfloat16, "float32": torch.float32}[a["dtype"]]
        assert PRESETS[name]().num_params() == JPRESETS[name]().num_params()


@pytest.mark.parametrize("tied", [False, True])
def test_apply_matches_jax(tied):
    jmodel, jparams, model, params = _pair(tied=tied)
    toks = np.random.default_rng(1).integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(toks)))
    got = model.apply(params, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_apply_with_positions_matches_jax():
    jmodel, jparams, model, params = _pair(seed=3)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 12)).astype(np.int32)
    pos = (np.arange(12)[None] + np.array([[5], [40]])).astype(np.int32)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(toks),
                                   jnp.asarray(pos)))
    got = model.apply(params, torch.from_numpy(toks).long(),
                      torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_params_from_jax_structure_and_dtypes():
    _, jparams, _, params = _pair()
    cfg = tiny()
    assert len(params["layers"]) == cfg.n_layers
    assert set(params["layers"][0]) == set(jparams["layers"])
    for name, arr in jparams["layers"].items():
        assert tuple(params["layers"][1][name].shape) == arr.shape[1:]
    np.testing.assert_array_equal(params["layers"][1]["wq"].numpy(),
                                  np.asarray(jparams["layers"]["wq"][1]))
    # every leaf keeps the parameter dtype, as the JAX tree does; the
    # serving cast alone moves the matmul weights to the activation dtype
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), bf,
                          device="cpu")
    assert p16["layers"][0]["wq"].dtype == torch.float32
    assert p16["embed"].dtype == p16["lm_head"].dtype == torch.float32
    served = cast_for_serving(p16, bf)
    assert served["layers"][0]["wq"].dtype == torch.bfloat16
    assert served["embed"].dtype == served["lm_head"].dtype == torch.bfloat16
    assert served["layers"][0]["attn_norm"].dtype == torch.float32
    assert served["final_norm"].dtype == torch.float32


def test_init_structure_matches_jax_and_is_seeded():
    cfg = dataclasses.replace(tiny(), dtype="bfloat16")
    model = Transformer(cfg)
    a, b, c = (model.init(s, device="cpu") for s in (0, 0, 1))
    jparams = JTransformer(jtiny()).init(jax.random.PRNGKey(0))
    assert set(a) == set(jparams)
    for name, arr in jparams["layers"].items():
        t = a["layers"][0][name]
        assert tuple(t.shape) == arr.shape[1:]
        assert t.dtype == torch.float32           # the parameter dtype
    assert torch.equal(a["layers"][1]["up"], b["layers"][1]["up"])
    assert not torch.equal(a["layers"][1]["up"], c["layers"][1]["up"])
    assert abs(a["embed"].float().std().item() - 0.02) < 2e-3
    assert torch.count_nonzero(a["final_norm"]) == 0


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError):
        Transformer(tiny()).init(0)


def test_cache_page_bytes_matches_jax():
    for cfg_name in ("tiny", "llama3-8b"):
        for tp in (1, 2):
            assert decode.cache_page_bytes(PRESETS[cfg_name](), 16, tp) == \
                jdecode.cache_page_bytes(JPRESETS[cfg_name](), 16, tp)
    assert decode.cache_page_bytes(tiny(), 16, dtype="bfloat16") == \
        jdecode.cache_page_bytes(jtiny(), 16, dtype=jnp.bfloat16)


def _prefill_both(prompt, num_pages=8, page_size=8, page_table=(5, 2, 7)):
    jmodel, jparams, model, params = _pair(seed=4)
    s_pad = 16
    toks = np.zeros((s_pad,), np.int32)
    toks[:len(prompt)] = prompt
    max_pages = tiny().max_seq_len // page_size
    pt = np.full((max_pages,), -1, np.int32)
    pt[:len(page_table)] = page_table
    jcache = jdecode.init_paged_cache(jtiny(), num_pages, page_size)
    jlogits, jcache = jdecode.prefill(
        jmodel, jparams, jnp.asarray(toks), jnp.int32(len(prompt)),
        jnp.asarray(pt), jcache, page_size)
    cache = decode.init_paged_cache(tiny(), num_pages, page_size,
                                    device="cpu")
    logits, cache2 = decode.prefill(
        model, params, torch.from_numpy(toks), len(prompt),
        torch.from_numpy(pt), cache, page_size)
    assert cache2 is cache                       # updated in place
    return (jmodel, jparams, jcache, np.asarray(jlogits),
            model, params, cache, logits, pt)


def test_prefill_matches_jax_logits_and_cache():
    prompt = [3, 17, 91, 254, 8, 44, 9, 1, 77, 12, 5]
    (_, _, jcache, jlogits, _, _, cache, logits, _) = _prefill_both(prompt)
    assert logits.shape == (256,) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)
    # the padded tail and unlisted pages stay untouched
    untouched = [p for p in range(8) if p not in (5, 2)]
    assert torch.count_nonzero(cache["k"][:, untouched]) == 0
    assert torch.count_nonzero(cache["k"][:, 2, len(prompt) - 8:]) == 0


def test_decode_step_matches_jax_logits_and_cache():
    prompt = [3, 17, 91, 254, 8, 44, 9, 1]       # fills page 5 exactly
    (jmodel, jparams, jcache, jlogits, model, params, cache, _,
     pt) = _prefill_both(prompt)
    nxt = int(np.argmax(jlogits))
    B = 3
    tokens = np.array([nxt, 7, 0], np.int32)
    positions = np.array([len(prompt), 0, 0], np.int32)
    pts = np.full((B, pt.shape[0]), -1, np.int32)
    pts[0] = pt                                   # row 0: the prefilled seq
    pts[1, 0] = 6                                 # row 1: fresh seq, page 6
    active = np.array([True, True, False])
    jl, jcache = jdecode.decode_step(
        jmodel, jparams, jcache, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(pts), jnp.asarray(active), 8)
    logits, _ = decode.decode_step(
        model, params, cache, torch.from_numpy(tokens),
        torch.from_numpy(positions), torch.from_numpy(pts),
        torch.from_numpy(active), 8)
    assert logits.shape == (B, 256)
    np.testing.assert_allclose(logits[:2].numpy(), np.asarray(jl)[:2],
                               atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)
    # the inactive row wrote nothing: only pages 5, 2 and 6 hold data
    untouched = [p for p in range(8) if p not in (5, 2, 6)]
    assert torch.count_nonzero(cache["v"][:, untouched]) == 0


def test_paged_decode_matches_full_forward():
    """Greedy prefill + decode steps give the full forward's logits."""
    _, _, model, params = _pair(seed=5)
    prompt = [4, 9, 200, 31, 77]
    page_size, num_pages = 4, 8
    cache = decode.init_paged_cache(tiny(), num_pages, page_size,
                                    device="cpu")
    pt = torch.full((tiny().max_seq_len // page_size,), -1,
                    dtype=torch.int32)
    pt[:4] = torch.tensor([3, 0, 6, 1])
    toks = torch.zeros(16, dtype=torch.int32)
    toks[:len(prompt)] = torch.tensor(prompt)
    logits, cache = decode.prefill(model, params, toks, len(prompt), pt,
                                   cache, page_size)
    seq = list(prompt)
    for _ in range(6):
        full = model.apply(params, torch.tensor([seq]))[0, -1]
        torch.testing.assert_close(logits, full, atol=1e-4, rtol=0)
        seq.append(int(logits.argmax()))
        logits, cache = decode.decode_step(
            model, params, cache, torch.tensor([seq[-1]]),
            torch.tensor([len(seq) - 1]), pt[None], torch.tensor([True]),
            page_size)
        logits = logits[0]


def test_moe_config_is_refused():
    cfg = dataclasses.replace(tiny(), moe_num_experts=4)
    with pytest.raises(NotImplementedError):
        Transformer(cfg)
    with pytest.raises(NotImplementedError):
        decode.init_paged_cache(cfg, 4, 8, device="cpu")
