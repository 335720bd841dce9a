"""The plain paged decode attention (the CPU path of
`ray_tpu_torch.ops.paged_decode`) against the formulation `decode_step`
ran inline before it moved behind the kernel wrapper: equal bit for bit,
outputs and caches. The kernel itself is held to the plain version on
the card (`tests/test_torch_kernels.py`, marked `cuda`)."""
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import decode
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops import paged_decode as pd
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope_cached, rope_cos_sin


def inline_decode_step(model, params, cache, tokens, positions, page_tables,
                       active, page_size, group=None):
    """`decode_step` as it was with its attention inline: the step's
    mask, gather indices and write rows built once, then each layer's
    `index_put_` write, gather, f32 einsums and softmax."""
    c = model.config
    ad = c.activation_dtype
    hd = c.head_dim
    ck, cv = cache["k"], cache["v"]
    num_pages = ck.shape[1]
    B = tokens.shape[0]
    max_pages = page_tables.shape[1]
    span = max_pages * page_size
    dev = tokens.device
    positions = positions.long()
    page_tables = page_tables.long()

    x = model._embed_lookup(params["embed"], tokens[:, None])
    cos, sin = rope_cos_sin(positions[:, None], hd, c.rope_theta)

    my_page = torch.gather(page_tables, 1,
                           (positions // page_size)[:, None])[:, 0]
    rows = torch.nonzero(active & (my_page >= 0)).squeeze(1)
    wr_page = my_page[rows]
    wr_slot = (positions % page_size)[rows]
    flat = torch.arange(span, device=dev)
    assigned = (page_tables >= 0).repeat_interleave(page_size, dim=1)
    mask = (flat[None, :] <= positions[:, None]) & assigned
    gather_pt = page_tables.clamp(0, num_pages - 1)
    heads, kv_heads = decode._heads(c, params["layers"][0])
    groups = heads // kv_heads
    scale = 1.0 / (hd ** 0.5)
    f32min = torch.finfo(torch.float32).min

    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k, v = decode._qkv(c, layer, h)
        q = apply_rope_cached(q, cos, sin)
        k = apply_rope_cached(k, cos, sin)
        ck[i].index_put_((wr_page, wr_slot), k[rows, 0].to(ck.dtype))
        cv[i].index_put_((wr_page, wr_slot), v[rows, 0].to(cv.dtype))
        keys = ck[i][gather_pt].reshape(B, span, kv_heads, hd)
        vals = cv[i][gather_pt].reshape(B, span, kv_heads, hd)
        qg = q[:, 0].reshape(B, kv_heads, groups, hd)
        scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                              keys.to(torch.float32)) * scale
        scores = scores.masked_fill(~mask[:, None, None, :], f32min)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", probs,
                           vals.to(torch.float32)).to(ad)
        out = out.reshape(B, 1, heads * hd)
        x = x + decode._row_parallel(out, decode._w(c, layer, "wo"), group)
        x = decode._mlp(c, layer, x, group)

    x = rms_norm(x, params["final_norm"], c.norm_eps)
    return decode._logits(model, params, x[:, 0], group), cache


def layer_inputs(rows, heads, kv_heads, hd, page_size, max_pages, seed,
                 dtype=torch.bfloat16):
    """One layer's arguments: ragged contexts over shuffled pages; row 0
    with an unassigned page inside its context, row 1 with its own page
    unassigned, row 2 at position 0, the last row inactive."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(1, max_pages * page_size + 1, rows)
    ctx[0] = max(ctx[0], 3 * page_size)
    ctx[1] = max(ctx[1], 2 * page_size)
    ctx[2] = 1
    need = -(-ctx // page_size)
    num_pages = int(need.sum()) + 3
    perm = rng.permutation(num_pages)
    pt = np.full((rows, max_pages), -1, np.int32)
    at = 0
    for r in range(rows):
        pt[r, :need[r]] = perm[at:at + need[r]]
        at += need[r]
    pt[0, 1] = -1
    pt[1, need[1] - 1] = -1
    active = np.ones(rows, bool)
    active[-1] = False

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dtype)
    shape = (num_pages, page_size, kv_heads, hd)
    return dict(q=randn(rows, heads, hd), k_cache=randn(*shape),
                v_cache=randn(*shape), k=randn(rows, kv_heads, hd),
                v=randn(rows, kv_heads, hd),
                page_tables=torch.from_numpy(pt),
                positions=torch.from_numpy((ctx - 1).astype(np.int32)),
                active=torch.from_numpy(active), page_size=page_size,
                scale=hd ** -0.5)


def inline_attention(q, k_cache, v_cache, k, v, page_tables, positions,
                     active, page_size, scale):
    """One layer of `inline_decode_step`'s attention on the same
    arguments as the wrapper."""
    B, heads, hd = q.shape
    num_pages, _, kv_heads, _ = k_cache.shape
    span = page_tables.shape[1] * page_size
    positions, page_tables = positions.long(), page_tables.long()
    my_page = torch.gather(page_tables, 1,
                           (positions // page_size)[:, None])[:, 0]
    rows = torch.nonzero(active & (my_page >= 0)).squeeze(1)
    flat = torch.arange(span)
    assigned = (page_tables >= 0).repeat_interleave(page_size, dim=1)
    mask = (flat[None, :] <= positions[:, None]) & assigned
    gather_pt = page_tables.clamp(0, num_pages - 1)
    k_cache.index_put_((my_page[rows], (positions % page_size)[rows]),
                       k[rows].to(k_cache.dtype))
    v_cache.index_put_((my_page[rows], (positions % page_size)[rows]),
                       v[rows].to(v_cache.dtype))
    keys = k_cache[gather_pt].reshape(B, span, kv_heads, hd)
    vals = v_cache[gather_pt].reshape(B, span, kv_heads, hd)
    qg = q.reshape(B, kv_heads, heads // kv_heads, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          keys.to(torch.float32)) * scale
    scores = scores.masked_fill(~mask[:, None, None, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, vals.to(torch.float32))
    return out.to(q.dtype).reshape(B, heads, hd)


def copied(args):
    return dict(args, k_cache=args["k_cache"].clone(),
                v_cache=args["v_cache"].clone())


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("heads,kv_heads,hd", [
    (4, 4, 64),        # GQA group 1
    (8, 4, 64),        # group 2
    (8, 2, 128),       # group 4
    (16, 4, 128),      # a tp=2 rank's share of 32 / 8 heads (group 4)
])
def test_plain_paged_decode_is_the_inline_formulation(heads, kv_heads, hd,
                                                      page_size):
    args = layer_inputs(6, heads, kv_heads, hd, page_size, 5,
                        seed=heads * 100 + kv_heads + page_size)
    got_args, want_args = copied(args), copied(args)
    before = pd.paged_decode_attention.launches
    got = pd.paged_decode_attention(**got_args)
    want = inline_attention(**want_args)
    assert pd.paged_decode_attention.launches == before   # no kernel here
    assert got.dtype == torch.bfloat16 and got.shape == (6, heads, hd)
    assert torch.equal(got, want)
    for key in ("k_cache", "v_cache"):
        assert torch.equal(got_args[key], want_args[key])
    # inactive row 5 and row 1 (its page unassigned) wrote nothing; the
    # others wrote their new k into their slot
    changed = (got_args["k_cache"] != args["k_cache"]).any(-1).any(-1)
    pt, pos = args["page_tables"], args["positions"].long()
    writers = [r for r in range(6) if args["active"][r]
               and pt[r, pos[r] // page_size] >= 0]
    assert writers == [0, 2, 3, 4]
    want_changed = torch.zeros_like(changed)
    for r in writers:
        want_changed[pt[r, pos[r] // page_size], pos[r] % page_size] = True
    assert torch.equal(changed, want_changed)
    # row 2 sees only its new token
    g = heads // kv_heads
    assert torch.equal(got[2], args["v"][2].repeat_interleave(g, dim=0))


@pytest.mark.parametrize("dtype,heads,kv_heads", [
    ("float32", 4, 4), ("bfloat16", 4, 2)])
def test_cpu_decode_step_is_the_inline_one_bit_for_bit(dtype, heads,
                                                       kv_heads):
    """Three steps of a padded batch through `decode_step` and through
    the inline copy above: logits and both caches equal bit for bit."""
    cfg = dataclasses.replace(tiny(), dtype=dtype, n_heads=heads,
                              n_kv_heads=kv_heads)
    model = Transformer(cfg)
    params = model.init(3, device="cpu")
    page_size, num_pages, B = 4, 24, 4
    max_pages = cfg.max_seq_len // page_size
    cache = decode.init_paged_cache(cfg, num_pages, page_size, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for key in cache:
        cache[key].copy_(torch.randn(cache[key].shape, generator=gen))
    mine = {k: t.clone() for k, t in cache.items()}
    pts = torch.full((B, max_pages), -1, dtype=torch.int32)
    pts[0, :3] = torch.tensor([5, 1, 9])
    pts[1, :2] = torch.tensor([2, 7])
    pts[2, :1] = torch.tensor([11])
    positions = torch.tensor([9, 4, 0, 0], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    tokens = torch.tensor([3, 17, 91, 0], dtype=torch.int32)
    with torch.inference_mode():
        for _ in range(3):
            got, _ = decode.decode_step(model, params, mine, tokens,
                                        positions, pts, active, page_size)
            want, _ = inline_decode_step(model, params, cache, tokens,
                                         positions, pts, active, page_size)
            assert torch.equal(got, want)
            for key in cache:
                assert torch.equal(mine[key], cache[key])
            tokens = got.argmax(-1).to(torch.int32)
            positions = positions + active.to(torch.int32)


def test_chunks_follow_the_shape():
    """256 rows x 8 kv heads (the chat cell): chunks of 512 positions,
    only to even out ragged contexts; 8 rows: shorter chunks, so a row's
    context spreads over the SMs; every table is covered, no chunk holds
    more than 512 positions (64 pages at page 8, the kernel's bound), and
    each warp gets a page."""
    assert pd.chunking(256, 8, 256, 16, 132) == (8, 32)
    assert pd.chunking(256, 8, 256, 8, 132) == (4, 64)
    for rows, kvh, max_pages, ps in ((8, 8, 512, 16), (8, 4, 512, 16),
                                     (4, 2, 16, 8), (1, 1, 3, 16),
                                     (256, 8, 2048, 16)):
        chunks, pages = pd.chunking(rows, kvh, max_pages, ps, 132)
        assert chunks * pages >= max_pages > (chunks - 1) * pages
        assert min(4, max_pages) <= pages
        assert pages * ps <= pd._CHUNK_POSITIONS
    chunks, pages = pd.chunking(8, 8, 512, 16, 132)
    assert pages < 32 and 8 * 8 * chunks >= 16 * 132
