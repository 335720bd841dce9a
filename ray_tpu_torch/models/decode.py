"""Incremental decoding for the port's Transformer: paged KV cache.

Port of `ray_tpu/models/decode.py`. A *prefill* runs a whole padded
prompt once and writes every layer's K/V into cache pages; a *decode
step* advances a batch of sequences by one token each against their
cached context. Both mirror `Transformer._layer` (the same RMSNorm,
RoPE, GQA and SwiGLU), so their logits agree with `Transformer.apply`.

The cache is paged (vLLM-style): per layer `(num_pages, page_size,
kv_heads, head_dim)`, stacked on a leading layers axis, and a sequence
owns the pages its page table lists.

Differences from the JAX functions:
  * the cache is updated IN PLACE and the same dict is returned; JAX's
    arrays are immutable and its functions return a new cache;
  * JAX routes writes of padded prompt positions and inactive decode
    rows to the `num_pages` drop sentinel of a `mode="drop"` scatter.
    PyTorch has no such scatter, so only the valid rows are written,
    with `index_put_`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.config import torch_dtype
from ray_tpu_torch.models.transformer import Params, Transformer
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope_cached, rope_cos_sin

KVCache = Dict[str, torch.Tensor]


def _dtype(config, dtype) -> torch.dtype:
    if dtype is None:
        return config.activation_dtype
    return torch_dtype(dtype) if isinstance(dtype, str) else dtype


def init_paged_cache(config, num_pages: int, page_size: int, dtype=None,
                     device=None) -> KVCache:
    """Zeroed paged cache: k/v each (layers, pages, page, kv, hd), on
    `device` (default: the card)."""
    if config.moe_num_experts:
        raise NotImplementedError(
            "paged decoding supports dense FFN layers only")
    dev = resolve_device(device)
    shape = (config.n_layers, num_pages, page_size,
             config.kv_heads, config.head_dim)
    dt = _dtype(config, dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def cache_page_bytes(config, page_size: int, tp_shards: int = 1,
                     dtype=None) -> int:
    """Bytes one page costs per shard (k+v, all layers); kv heads split
    across tp shards."""
    itemsize = _dtype(config, dtype).itemsize
    kv_local = max(1, config.kv_heads // max(1, tp_shards))
    return (2 * config.n_layers * page_size * kv_local
            * config.head_dim * itemsize)


def _w(config, layer: Params, name: str) -> torch.Tensor:
    """A matmul weight in the activation dtype: free for parameters cast
    once by `convert.cast_for_serving`, a cast at use otherwise."""
    return layer[name].to(config.activation_dtype)


def _qkv(config, layer: Params, h):
    b, s, _ = h.shape
    hd = config.head_dim
    q = (h @ _w(config, layer, "wq")).view(b, s, config.n_heads, hd)
    k = (h @ _w(config, layer, "wk")).view(b, s, config.kv_heads, hd)
    v = (h @ _w(config, layer, "wv")).view(b, s, config.kv_heads, hd)
    return q, k, v


def _mlp(config, layer: Params, x):
    h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    gate = F.silu(h @ _w(config, layer, "gate"))
    up = h @ _w(config, layer, "up")
    return x + (gate * up) @ _w(config, layer, "down")


def prefill(model: Transformer, params: Params, tokens: torch.Tensor,
            true_len: int, page_table: torch.Tensor, cache: KVCache,
            page_size: int) -> Tuple[torch.Tensor, KVCache]:
    """Process one padded prompt, writing K/V into the cache pages.

    tokens: (s_pad,) int, anything past true_len (the causal mask keeps
    the tail out of positions < true_len).
    true_len: actual prompt length.
    page_table: (max_pages,) int page ids covering the prompt.

    Returns (last-position logits (vocab,) f32, the cache, updated in
    place).
    """
    c = model.config
    ck, cv = cache["k"], cache["v"]
    dev = tokens.device
    s = tokens.shape[0]
    true_len = int(true_len)
    positions = torch.arange(s, device=dev)[None]
    x = model._embed_lookup(params["embed"], tokens[None])    # (1, s, e)
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)

    # Only the prompt's rows are written; JAX drops the padded tail.
    pos = torch.arange(true_len, device=dev)
    page_ids = page_table.long()[pos // page_size]
    slots = pos % page_size

    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, layer, h)
        q = apply_rope_cached(q, cos, sin)
        k = apply_rope_cached(k, cos, sin)
        attn = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True,
                               block_q=c.attn_block_q,
                               block_k=c.attn_block_k)
        attn = attn.transpose(1, 2).reshape(1, s, c.n_heads * c.head_dim)
        x = x + attn @ _w(c, layer, "wo")
        x = _mlp(c, layer, x)
        ck[i].index_put_((page_ids, slots), k[0, :true_len].to(ck.dtype))
        cv[i].index_put_((page_ids, slots), v[0, :true_len].to(cv.dtype))

    x = rms_norm(x, params["final_norm"], c.norm_eps)
    last = x[0, true_len - 1]
    logits = (last @ model._head(params)).to(torch.float32)
    return logits, cache


def decode_step(model: Transformer, params: Params, cache: KVCache,
                tokens: torch.Tensor, positions: torch.Tensor,
                page_tables: torch.Tensor, active: torch.Tensor,
                page_size: int) -> Tuple[torch.Tensor, KVCache]:
    """Advance a padded batch by one token each.

    tokens: (B,) int current input token per row.
    positions: (B,) int absolute position the token occupies.
    page_tables: (B, max_pages) int, -1 for unassigned slots.
    active: (B,) bool; inactive (padding) rows write no cache and their
    logits mean nothing.

    Returns (logits (B, vocab) f32, the cache, updated in place).
    """
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

    x = model._embed_lookup(params["embed"], tokens[:, None])  # (B, 1, e)
    cos, sin = rope_cos_sin(positions[:, None], hd, c.rope_theta)

    my_page = torch.gather(page_tables, 1,
                           (positions // page_size)[:, None])[:, 0]
    # rows that write their K/V this step: one host sync per step
    rows = torch.nonzero(active & (my_page >= 0)).squeeze(1)
    wr_page = my_page[rows]
    wr_slot = (positions % page_size)[rows]
    # context mask: cache slot j is visible iff j <= position and its
    # page is assigned (own-position k/v is written before the read)
    flat = torch.arange(span, device=dev)
    assigned = (page_tables >= 0).repeat_interleave(page_size, dim=1)
    mask = (flat[None, :] <= positions[:, None]) & assigned
    gather_pt = page_tables.clamp(0, num_pages - 1)
    groups = c.n_heads // c.kv_heads
    scale = 1.0 / (hd ** 0.5)
    f32min = torch.finfo(torch.float32).min

    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, layer, h)                  # (B, 1, heads, hd)
        q = apply_rope_cached(q, cos, sin)
        k = apply_rope_cached(k, cos, sin)
        ck[i].index_put_((wr_page, wr_slot), k[rows, 0].to(ck.dtype))
        cv[i].index_put_((wr_page, wr_slot), v[rows, 0].to(cv.dtype))
        keys = ck[i][gather_pt].reshape(B, span, c.kv_heads, hd)
        vals = cv[i][gather_pt].reshape(B, span, c.kv_heads, hd)
        qg = q[:, 0].reshape(B, c.kv_heads, groups, hd)
        scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                              keys.to(torch.float32)) * scale
        scores = scores.masked_fill(~mask[:, None, None, :], f32min)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", probs,
                           vals.to(torch.float32)).to(ad)
        out = out.reshape(B, 1, c.n_heads * hd)
        x = x + out @ _w(c, layer, "wo")
        x = _mlp(c, layer, x)

    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = x[:, 0] @ model._head(params)
    return logits.to(torch.float32), cache
