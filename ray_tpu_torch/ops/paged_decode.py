"""Paged decode attention: one new token a row against the row's paged
K/V cache, with the token's own K/V written into its slot first. A CUDA
kernel for the card, the plain version for the CPU.

`decode_step` (`models/decode.py`) calls it once a layer. The JAX package
has no kernel for this step (its `decode_step` runs plain einsums), so
the plain version here is that formulation as the port had it inline:
gather every row's `max_pages * page_size` positions, mask, f32 einsums
and softmax. The kernel (`csrc/paged_decode.cu`) reads each active row's
own pages in place, in bf16, with the same f32 arithmetic, and folds the
K/V write in.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.dispatch import on_cuda

_HEAD_DIMS = (64, 128)         # template instances in paged_decode.cu
_PAGE_SIZES = (8, 16)
_MAX_GROUP = 8                 # q heads a kv head
_CHUNK_POSITIONS = 512         # context a block reads at most
_BLOCKS_PER_SM = 16            # blocks full rows should give each SM


def paged_decode_attention_reference(q, k_cache, v_cache, k, v,
                                     page_tables, positions, active,
                                     page_size: int, scale: float):
    """The plain version (see `paged_decode_attention`): writes the active
    rows' k / v with `index_put_`, gathers every row's whole page table,
    masks slots past its position or on unassigned pages, and runs the
    f32 einsums and softmax."""
    B, heads, hd = q.shape
    num_pages, _, kv_heads, _ = k_cache.shape
    span = page_tables.shape[1] * page_size
    dev = q.device
    positions = positions.long()
    page_tables = page_tables.long()
    my_page = torch.gather(page_tables, 1,
                           (positions // page_size)[:, None])[:, 0]
    # rows that write their K/V this step: one host sync
    rows = torch.nonzero(active & (my_page >= 0)).squeeze(1)
    wr_page = my_page[rows]
    wr_slot = (positions % page_size)[rows]
    # context mask: cache slot j is visible iff j <= position and its
    # page is assigned (own-position k/v is written before the read)
    flat = torch.arange(span, device=dev)
    assigned = (page_tables >= 0).repeat_interleave(page_size, dim=1)
    mask = (flat[None, :] <= positions[:, None]) & assigned
    gather_pt = page_tables.clamp(0, num_pages - 1)
    groups = heads // kv_heads
    f32min = torch.finfo(torch.float32).min

    k_cache.index_put_((wr_page, wr_slot), k[rows].to(k_cache.dtype))
    v_cache.index_put_((wr_page, wr_slot), v[rows].to(v_cache.dtype))
    keys = k_cache[gather_pt].reshape(B, span, kv_heads, hd)
    vals = v_cache[gather_pt].reshape(B, span, kv_heads, hd)
    qg = q.reshape(B, kv_heads, groups, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          keys.to(torch.float32)) * scale
    scores = scores.masked_fill(~mask[:, None, None, :], f32min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs,
                       vals.to(torch.float32)).to(q.dtype)
    return out.reshape(B, heads, hd)


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, page_tables: torch.Tensor,
                           positions: torch.Tensor, active: torch.Tensor,
                           page_size: int, scale: float) -> torch.Tensor:
    """Attention of each row's new token over its cached context.

    q: (B, heads, hd), after RoPE; k_cache / v_cache: one layer's pages
    (num_pages, page_size, kv_heads, hd), updated IN PLACE; k / v:
    (B, kv_heads, hd), the new token's, written into slot
    `positions % page_size` of page `page_tables[b, positions //
    page_size]` for each active row whose page is assigned;
    page_tables: (B, max_pages), -1 for unassigned pages; positions:
    (B,) the new token's position; active: (B,) bool. Slot j of a row is
    attended iff j <= its position and its page is assigned.

    Returns (B, heads, hd) in q's dtype. Inactive rows' outputs mean
    nothing (the kernel gives zeros). A CUDA tensor goes through the
    kernel, which raises on what it does not take; a CPU tensor through
    `paged_decode_attention_reference`.
    """
    if not on_cuda(q):
        return paged_decode_attention_reference(
            q, k_cache, v_cache, k, v, page_tables, positions, active,
            page_size, scale)
    return _paged_decode_cuda(q, k_cache, v_cache, k, v, page_tables,
                              positions, active, int(page_size),
                              float(scale))


paged_decode_attention.launches = 0


def chunking(rows: int, kv_heads: int, max_pages: int, page_size: int,
             sms: int) -> tuple:
    """(chunks, pages a chunk) of each row's page table. A block reads
    one chunk of one (row, kv head): at most `_CHUNK_POSITIONS` positions,
    so ragged contexts even out over the blocks; fewer where the batch's
    rows, were every one full, would give the card's SMs fewer than
    `_BLOCKS_PER_SM` blocks each (a small batch spreads a row's context
    over the SMs); at least one page a warp."""
    most = _CHUNK_POSITIONS // page_size
    fill = rows * kv_heads * max_pages // (_BLOCKS_PER_SM * sms)
    pages = max(1, min(most, max_pages, max(4, fill)))
    return -(-max_pages // pages), pages


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("paged_decode")
    fn = lib.rtt_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _paged_decode_cuda(q, k_cache, v_cache, k, v, page_tables, positions,
                       active, page_size: int, scale: float):
    bf = torch.bfloat16
    if any(t.dtype != bf for t in (q, k_cache, v_cache, k, v)):
        raise TypeError("paged decode kernel takes bf16 q, caches and new "
                        "k / v, got " + ", ".join(
                            str(t.dtype) for t in (q, k_cache, v_cache, k, v)))
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"paged decode kernel takes q (B, heads, hd) and "
                         f"caches (pages, page, kv_heads, hd), got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, heads, hd = q.shape
    num_pages, ps, kv_heads, _ = k_cache.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {hd}")
    if page_size not in _PAGE_SIZES or ps != page_size:
        raise ValueError(f"paged decode kernel takes page sizes "
                         f"{_PAGE_SIZES} matching the cache, got {page_size} "
                         f"and a cache of pages of {ps}")
    if heads % kv_heads or not 1 <= heads // kv_heads <= _MAX_GROUP:
        raise ValueError(f"paged decode kernel takes heads = group x "
                         f"kv_heads with group 1..{_MAX_GROUP}, got "
                         f"{heads} / {kv_heads}")
    if (v_cache.shape != k_cache.shape or k.shape != (B, kv_heads, hd)
            or v.shape != k.shape or page_tables.dim() != 2
            or page_tables.shape[0] != B or positions.shape != (B,)
            or active.shape != (B,)):
        raise ValueError(
            f"paged decode kernel: shapes disagree: q {tuple(q.shape)}, "
            f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)}, k / v "
            f"{tuple(k.shape)} / {tuple(v.shape)}, page tables "
            f"{tuple(page_tables.shape)}, positions "
            f"{tuple(positions.shape)}, active {tuple(active.shape)}")
    tensors = (q, k_cache, v_cache, k, v, page_tables, positions, active)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged decode kernel: tensors on different devices")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, k, v)):
        raise ValueError("paged decode kernel takes contiguous q, caches "
                         "and new k / v")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache, k, v)):
        raise ValueError("paged decode kernel needs 16-byte aligned tensors")
    if active.dtype != torch.bool:
        raise TypeError(f"active must be bool, got {active.dtype}")
    if (page_tables.dtype.is_floating_point
            or positions.dtype.is_floating_point):
        raise TypeError("page tables and positions must be integers")
    page_tables = page_tables.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    active = active.contiguous()
    max_pages = page_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0 or max_pages == 0:
        return out.zero_()
    chunks, pages = chunking(B, kv_heads, max_pages, page_size,
                             _sms(q.device.index))
    part_o = torch.empty((B, heads, chunks, hd), dtype=torch.float32,
                         device=q.device)
    part_lse = torch.empty((B, heads, chunks), dtype=torch.float32,
                           device=q.device)
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 k.data_ptr(), v.data_ptr(), page_tables.data_ptr(),
                 positions.data_ptr(), active.data_ptr(), part_o.data_ptr(),
                 part_lse.data_ptr(), out.data_ptr(), B, heads, kv_heads, hd,
                 page_size, num_pages, max_pages, pages, chunks,
                 scale * math.log2(math.e), stream)
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out
