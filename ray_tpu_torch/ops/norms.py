"""RMSNorm forward: a CUDA kernel for the card, the plain version for the CPU.

Port of `ray_tpu/ops/norms.py`. `y = x * rsqrt(mean(x^2) + eps) * (1 + w)`
in f32, output in x's dtype; the `(1 + w)` convention makes a zero-init
scale the identity. The kernel (`csrc/rms_norm.cu`) takes any row count:
the JAX wrapper's fall back to the reference for a ragged row count
(`rows % 256`) has no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.dispatch import on_cuda

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_MAX_VECS = 256 * 8        # 16-byte vectors a row may span (rms_norm.cu)


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(torch.float32))).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise the last axis of x (any leading shape).

    A CUDA tensor goes through the kernel, which raises on what it does
    not take; a CPU tensor through `rms_norm_reference`.
    """
    if not on_cuda(x):
        return rms_norm_reference(x, w, eps)
    return _rms_norm_cuda(x, w, eps)


rms_norm.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("rms_norm")
    fn = lib.rtt_rms_norm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _rms_norm_cuda(x: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rms_norm kernel takes bf16 or f32 x, got {x.dtype}")
    if w.dtype != torch.float32 or w.shape != (d,):
        raise TypeError(f"rms_norm kernel takes an f32 weight of shape "
                        f"({d},), got {w.dtype} {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "rms_norm has no backward kernel yet (training slice)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm kernel takes contiguous tensors")
    per_vec = 16 // x.element_size()
    if d % 8 or d // per_vec > _MAX_VECS:
        raise ValueError(f"rms_norm kernel takes d % 8 == 0 and at most "
                         f"{_MAX_VECS * per_vec} columns, got d={d}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned tensors")
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
                 float(eps), _DTYPE_CODES[x.dtype], stream)
    _build.check(lib, err, "rms_norm")
    rms_norm.launches += 1
    return y
