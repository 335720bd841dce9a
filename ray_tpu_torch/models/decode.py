"""Incremental decoding for the port's Transformer: paged KV cache.

Port of `ray_tpu/models/decode.py`. A *prefill* runs a whole padded
prompt once and writes every layer's K/V into cache pages; a *decode
step* advances a batch of sequences by one token each against their
cached context. Both mirror `Transformer._layer` (the same RMSNorm,
RoPE, GQA and SwiGLU), so their logits agree with `Transformer.apply`.

The cache is paged (vLLM-style): per layer `(num_pages, page_size,
kv_heads, head_dim)`, stacked on a leading layers axis, and a sequence
owns the pages its page table lists.

On one tensor-parallel rank (`group`, a replica's process group, see
`serve/llm/replica_group.py`), `params` is that rank's shard
(`convert.tp_shard_params`): the head counts come from the shard, the
cache holds the rank's kv heads, the row-parallel products (`wo`,
`down`) are summed over the group in f32 and rounded once, and the vocab
shards' logits are put back together by an all-reduce into a zeroed
buffer (gloo has only all-reduce and broadcast for CUDA tensors).
Without a group the functions are the single-process ones, launch for
launch and bit for bit.

Differences from the JAX functions:
  * the cache is updated IN PLACE and the same dict is returned; JAX's
    arrays are immutable and its functions return a new cache;
  * JAX routes writes of padded prompt positions and inactive decode
    rows to the `num_pages` drop sentinel of a `mode="drop"` scatter.
    PyTorch has no such scatter, so only the valid rows are written:
    with `index_put_` in `prefill` and on the CPU, by the paged decode
    kernel on the card (`ops/paged_decode.py`);
  * a decode step's attention is `paged_decode_attention`: on the card
    a kernel that reads each active row's own pages in place, on the
    CPU the gather over every row's whole page table that JAX runs.
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
from ray_tpu_torch.ops.paged_decode import paged_decode_attention
from ray_tpu_torch.ops.rope import apply_rope_cached, rope_cos_sin

KVCache = Dict[str, torch.Tensor]


def _dtype(config, dtype) -> torch.dtype:
    if dtype is None:
        return config.activation_dtype
    return torch_dtype(dtype) if isinstance(dtype, str) else dtype


def init_paged_cache(config, num_pages: int, page_size: int, dtype=None,
                     device=None, kv_heads: int = 0) -> KVCache:
    """Zeroed paged cache: k/v each (layers, pages, page, kv, hd), on
    `device` (default: the card). `kv_heads`: the kv heads this cache
    holds (a tp rank's share; 0: all of them)."""
    if config.moe_num_experts:
        raise NotImplementedError(
            "paged decoding supports dense FFN layers only")
    dev = resolve_device(device)
    shape = (config.n_layers, num_pages, page_size,
             kv_heads or config.kv_heads, config.head_dim)
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


def _heads(config, layer: Params) -> Tuple[int, int]:
    """(query heads, kv heads) of `layer`: all of them, or a tp shard's."""
    hd = config.head_dim
    return layer["wq"].shape[1] // hd, layer["wk"].shape[1] // hd


def _qkv(config, layer: Params, h):
    b, s, _ = h.shape
    hd = config.head_dim
    heads, kv_heads = _heads(config, layer)
    q = (h @ _w(config, layer, "wq")).view(b, s, heads, hd)
    k = (h @ _w(config, layer, "wk")).view(b, s, kv_heads, hd)
    v = (h @ _w(config, layer, "wv")).view(b, s, kv_heads, hd)
    return q, k, v


def _row_parallel(x, w, group):
    """x @ w, each rank's partial product summed over the tp group in f32
    (on the card the product itself leaves the tensor cores in f32), so
    the sum is rounded to x's dtype once, as one process rounds it. A
    group of one sums nothing: the one-process product, bit for bit."""
    if group is None or group.size == 1:
        return x @ w
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32
                     ).view(*x.shape[:-1], w.shape[-1])
    else:
        y = (x @ w).to(torch.float32)
    return group.all_reduce_sum(y).to(x.dtype)


def _mlp(config, layer: Params, x, group=None):
    h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    gate = F.silu(h @ _w(config, layer, "gate"))
    up = h @ _w(config, layer, "up")
    return x + _row_parallel(gate * up, _w(config, layer, "down"),
                             group)


def _logits(model: Transformer, params: Params, x, group):
    """f32 logits over the whole vocab from the final hidden rows `x`
    (..., e): a tp rank computes its vocab columns, and an all-reduce
    into a zeroed buffer puts every rank's columns in place."""
    if group is None:
        return (x @ model._head(params)).to(torch.float32)
    local = (x @ params["lm_head"].to(model.config.activation_dtype)
             ).to(torch.float32)
    n = local.shape[-1]
    full = local.new_zeros(local.shape[:-1] + (model.config.vocab_size,))
    full[..., group.rank * n:(group.rank + 1) * n] = local
    return group.all_reduce_sum(full)


def prefill(model: Transformer, params: Params, tokens: torch.Tensor,
            true_len: int, page_table: torch.Tensor, cache: KVCache,
            page_size: int, group=None) -> Tuple[torch.Tensor, KVCache]:
    """Process one padded prompt, writing K/V into the cache pages.

    tokens: (s_pad,) int, anything past true_len (the causal mask keeps
    the tail out of positions < true_len).
    true_len: actual prompt length.
    page_table: (max_pages,) int page ids covering the prompt.
    group: the replica's tp group, with `params` this rank's shard; None
    in one process.

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
        attn = attn.transpose(1, 2).reshape(1, s, q.shape[2] * c.head_dim)
        x = x + _row_parallel(attn, _w(c, layer, "wo"), group)
        x = _mlp(c, layer, x, group)
        ck[i].index_put_((page_ids, slots), k[0, :true_len].to(ck.dtype))
        cv[i].index_put_((page_ids, slots), v[0, :true_len].to(cv.dtype))

    x = rms_norm(x, params["final_norm"], c.norm_eps)
    return _logits(model, params, x[0, true_len - 1], group), cache


def decode_step(model: Transformer, params: Params, cache: KVCache,
                tokens: torch.Tensor, positions: torch.Tensor,
                page_tables: torch.Tensor, active: torch.Tensor,
                page_size: int, group=None) -> Tuple[torch.Tensor, KVCache]:
    """Advance a padded batch by one token each.

    tokens: (B,) int current input token per row.
    positions: (B,) int absolute position the token occupies.
    page_tables: (B, max_pages) int, -1 for unassigned slots.
    active: (B,) bool; inactive (padding) rows write no cache and their
    logits mean nothing.
    group: as for `prefill`.

    Returns (logits (B, vocab) f32, the cache, updated in place).
    """
    c = model.config
    hd = c.head_dim
    ck, cv = cache["k"], cache["v"]
    B = tokens.shape[0]

    x = model._embed_lookup(params["embed"], tokens[:, None])  # (B, 1, e)
    cos, sin = rope_cos_sin(positions[:, None], hd, c.rope_theta)
    scale = 1.0 / (hd ** 0.5)

    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, layer, h)                  # (B, 1, heads, hd)
        q = apply_rope_cached(q, cos, sin)
        k = apply_rope_cached(k, cos, sin)
        out = paged_decode_attention(q[:, 0], ck[i], cv[i], k[:, 0],
                                     v[:, 0], page_tables, positions,
                                     active, page_size, scale)
        out = out.reshape(B, 1, q.shape[2] * hd)
        x = x + _row_parallel(out, _w(c, layer, "wo"), group)
        x = _mlp(c, layer, x, group)

    x = rms_norm(x, params["final_norm"], c.norm_eps)
    return _logits(model, params, x[:, 0], group), cache
