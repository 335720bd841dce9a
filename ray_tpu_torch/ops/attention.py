"""Flash attention forward: a CUDA kernel for the card, the plain version
for the CPU.

Port of the forward half of `ray_tpu/ops/attention.py`. Layout
(batch, heads, seq, head_dim); K/V may have fewer heads (GQA, kv heads
divide q heads) and the kernel maps q head h to kv head h // group
without materialising a repeat. The backward kernels (dK/dV and dQ)
belong to the training slice: until then the CUDA path refuses autograd.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.dispatch import on_cuda

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_HEAD_DIMS = (64, 128)         # template instances in flash_fwd.cu


def _masked_scores(q, k, causal: bool, sm_scale: float,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 scores (b, h, sq, sk), causal entries set to the mask value."""
    h, kvh = q.shape[1], k.shape[1]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * sm_scale
    if bias is not None:
        logits = logits + bias
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(qi >= ki, logits, DEFAULT_MASK_VALUE)
    return logits


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention; ground truth and the CPU path.

    q: (b, h, s, d); k/v: (b, kvh, s, d) with kvh | h. Scores and the
    PV product accumulate in f32 from operands in the input dtype, the
    probabilities rounded to v's dtype first, as the JAX reference does.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    h, kvh = q.shape[1], k.shape[1]
    if kvh != h:
        v = v.repeat_interleave(h // kvh, dim=1)
    probs = torch.softmax(_masked_scores(q, k, causal, sm_scale, bias),
                          dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    return_lse: bool = False):
    """Attention forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.

    Shapes: q (b, h, s, d); k/v (b, kvh, s, d), kvh | h. With
    `return_lse` also returns the row log-sum-exp (b, h, sq) in f32.
    `block_q`/`block_k` are the TPU kernel's tile sizes, kept for the
    signature; the CUDA kernel tiles 64 x 64 whatever they say.
    """
    del block_q, block_k
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q):
        out, lse = _flash_fwd_cuda(q, k, v, causal, sm_scale)
    elif return_lse:
        out, lse = flash_attention_reference(q, k, v, causal, sm_scale)
    else:
        out = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None):
    """Plain version of the kernel: (out, lse), lse (b, h, sq) f32 being
    the log-sum-exp of the masked scores."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    lse = torch.logsumexp(_masked_scores(q, k, causal, sm_scale), dim=-1)
    return out, lse


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_fwd")
    fn = lib.rtt_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash kernel takes bf16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if (k.shape != (b, kvh, sk, d) or v.shape != k.shape or h % kvh):
        raise ValueError(f"flash kernel: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not "
                         f"match (kv heads must divide q heads)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet (training slice)")
    if b * h > 65535 or max(sq, sk) >= 2 ** 31:
        raise ValueError(f"flash kernel grid too large: b*h={b * h}, "
                         f"sq={sq}, sk={sk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte vector loads: unit stride along d, 8-element multiples
        # elsewhere, 16-byte aligned base.
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"flash kernel: {name} strides {t.stride()} "
                             f"are not 16-byte aligned with unit stride "
                             f"along head_dim")
    # O is written as (b, s, h, d) memory so the caller's transpose back
    # to (b, s, h*d) is a free view.
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return out, lse
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, kvh, sq, sk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], float(sm_scale), int(causal), stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out, lse
