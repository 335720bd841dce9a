"""Flash attention, forward and backward: CUDA kernels for the card, the
plain versions for the CPU.

Port of `ray_tpu/ops/attention.py`. Layout (batch, heads, seq, head_dim);
K/V may have fewer heads (GQA, kv heads divide q heads) and the kernels
map q head h to kv head h // group without materialising a repeat.
`flash_attention` splits attention as the JAX package splits it under
`save_attn`, on every path: the `torch.library` custom op
`ray_tpu_torch::flash_fwd` -> (O, lse) runs the forward on
gradient-stopped inputs (the kernel on the card,
`flash_attention_reference` on the CPU), and `_AttnFromSaved` (the JAX
`_attn_from_saved`) is the only differentiable step: it saves q, k, v, O
and the row log-sum-exp, and its backward is the dK/dV and dQ kernels
(`csrc/flash_bwd.cu`) on the card, `flash_attention_bwd_reference` on
the CPU. The lse's cotangent is dropped, as `_flash_bwd_rule` drops it:
the lse is a statistic, not a loss term. The op also carries that
backward as its own autograd rule, for callers that differentiate it
directly; through the op's autograd wrapper a forward and backward cost
more host time than through the Function (`PERF.md`).

`attn_remat_policy()` is the checkpoint `context_fn` of
`remat_policy="save_attn"`, the counterpart of the JAX
`save_only_these_names("attn_out", "attn_lse")`: it keeps the op's O and
lse from a region's forward and hands them back while its backward
recomputes the region, so a rematerialised layer runs the forward kernel
once. It is a plain record-and-replay scope, not a `TorchDispatchMode`,
so the other ops of the region pay no host cost for it.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
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
    signature; the CUDA kernel tiles 128 q rows x 128 keys whatever they
    say.
    """
    del block_q, block_k
    on_cuda(q)              # raises for a device other than the card or CPU
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    causal, sm_scale = bool(causal), float(sm_scale)
    saves = getattr(_scope, "saves", None)
    out, lse = (_forward(q, k, v, causal, sm_scale) if saves is None
                else saves.forward(q, k, v, causal, sm_scale))
    out = _AttnFromSaved.apply(q, k, v, out, lse, causal, sm_scale)
    return (out, lse) if return_lse else out


def _forward(q, k, v, causal: bool, sm_scale: float):
    """(O, lse) from the op on gradient-stopped inputs."""
    with torch.no_grad():
        return flash_fwd(q.detach(), k.detach(), v.detach(), causal,
                         sm_scale)


# Launch counts of the three kernels: the forward, and the backward's
# dK/dV and dQ kernels.
flash_attention.launches = 0
flash_attention.dkdv_launches = 0
flash_attention.dq_launches = 0


@torch.library.custom_op(
    "ray_tpu_torch::flash_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float sm_scale) "
           "-> (Tensor, Tensor)")
def flash_fwd(q, k, v, causal, sm_scale):
    """(O, lse) of causal or full attention; O is (b, h, sq, d) in q's
    dtype laid out as (b, sq, h, d) memory, lse (b, h, sq) f32."""
    return _flash_fwd_cuda(q, k, v, causal, sm_scale)


def _out_like_kernel(q) -> torch.Tensor:
    """An empty O as the kernel writes it: (b, s, h, d) memory, so the
    caller's transpose back to (b, s, h*d) is a free view."""
    b, h, sq, d = q.shape
    return q.new_empty((b, sq, h, d)).transpose(1, 2)


@flash_fwd.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, causal, sm_scale):
    out, lse = flash_attention_reference(q, k, v, causal, sm_scale)
    return _out_like_kernel(q).copy_(out), lse


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, sm_scale):
    b, h, sq, _ = q.shape
    return _out_like_kernel(q), q.new_empty((b, h, sq), dtype=torch.float32)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, do, _dlse):
    return (*_flash_backward(ctx, do), None, None)


def _flash_backward(ctx, do):
    """(dq, dk, dv) from the saved q, k, v, O and lse."""
    q, k, v, out, lse = ctx.saved_tensors
    if on_cuda(q):
        if not _kernel_layout_ok(do):
            do = do.contiguous()     # e.g. the expanded grad of a sum
        return _flash_bwd_cuda(q, k, v, out, lse, do, ctx.causal,
                               ctx.sm_scale)
    return flash_attention_bwd_reference(q, k, v, out, lse, do, ctx.causal,
                                         ctx.sm_scale)


flash_fwd.register_autograd(_flash_fwd_backward,
                            setup_context=_flash_fwd_setup)


class _AttnFromSaved(torch.autograd.Function):
    """O of a forward already run, as a function of q, k and v: saves q,
    k, v, O and lse, and its backward is the flash backward (the JAX
    `_attn_from_saved`)."""

    @staticmethod
    def forward(ctx, q, k, v, out, lse, causal: bool, sm_scale: float):
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out.view_as(out)

    @staticmethod
    def backward(ctx, do):
        return (*_flash_backward(ctx, do), None, None, None, None)


_scope = threading.local()      # .saves: the _AttnSaves being run, if any


class _AttnSaves:
    """The (O, lse) of each flash forward of one checkpointed region, in
    order: recorded while the region's forward runs, handed back while its
    backward recomputes it. Checkpoint keeps the recompute scope, and so
    these, until the region's backward is done."""

    def __init__(self):
        self.saved: list = []
        self.next: Optional[int] = None      # None while recording

    def forward(self, q, k, v, causal: bool, sm_scale: float):
        if self.next is None:
            saved = _forward(q, k, v, causal, sm_scale)
            self.saved.append(saved)
            return saved
        if self.next >= len(self.saved):
            raise RuntimeError("save_attn recompute ran more flash forwards "
                               "than its forward did")
        saved = self.saved[self.next]
        self.next += 1
        return saved


class _AttnScope:
    """Makes `saves` the current thread's while it is entered; reusable,
    since checkpoint enters its recompute scope once per recompute."""

    def __init__(self, saves: _AttnSaves, replay: bool):
        self.saves, self.replay = saves, replay

    def __enter__(self):
        if self.replay:
            self.saves.next = 0
        self.prev = getattr(_scope, "saves", None)
        _scope.saves = self.saves

    def __exit__(self, *exc):
        _scope.saves = self.prev


def attn_remat_policy():
    """`context_fn` for `torch.utils.checkpoint.checkpoint`: the
    checkpointed region keeps the flash forward's O and lse and
    recomputes everything else, so its backward never reruns the forward
    kernel. Counterpart of the JAX `attn_remat_policy()`."""
    def context_fn():
        saves = _AttnSaves()
        return _AttnScope(saves, replay=False), _AttnScope(saves, replay=True)
    return context_fn


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None):
    """Plain version of the kernel: (out, lse), lse (b, h, sq) f32 being
    the log-sum-exp of the masked scores."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    lse = torch.logsumexp(_masked_scores(q, k, causal, sm_scale), dim=-1)
    return out, lse


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  sm_scale: Optional[float] = None):
    """Plain version of both backward kernels: (dq, dk, dv).

    Dense, in f32, from the saved O and lse: P = exp(S * scale - lse)
    with masked entries set to 0 after the exp, delta = rowsum(dO * O),
    dS = P (dP - delta) scale. P and dS are rounded to the inputs' dtype
    before their products, as the kernels (and the JAX kernels) round
    them; under GQA the q heads of a group sum into their kv head in f32.
    Each gradient comes back in its input's dtype.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    f32 = torch.float32
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    group = h // kvh
    kf, vf = k.to(f32), v.to(f32)
    if group != 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    qf, dof = q.to(f32), do.to(f32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        valid = (torch.arange(sq, device=q.device)[:, None]
                 >= torch.arange(sk, device=q.device)[None, :])
        p = torch.where(valid, p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).to(f32), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * o.to(f32)).sum(-1)
    ds = p * (dp - delta[..., None]) * sm_scale
    ds = ds.to(q.dtype).to(f32)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    if group != 1:
        dk = dk.reshape(b, kvh, group, sk, d).sum(2)
        dv = dv.reshape(b, kvh, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_layout_ok(t: torch.Tensor) -> bool:
    """16-byte vector loads: unit stride along d, 8-element multiples
    elsewhere, 16-byte aligned base."""
    return (t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_kernel_inputs(what: str, q, k, v, **more) -> None:
    """The checks every flash kernel wrapper makes; raises on what the
    kernels do not take."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    tensors = {"q": q, "k": k, "v": v, **more}
    if any(t.dtype != torch.bfloat16 for t in tensors.values()):
        raise TypeError(f"{what} takes bf16 " + "/".join(tensors) + ", got "
                        + "/".join(str(t.dtype) for t in tensors.values()))
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what} takes head_dim in {_HEAD_DIMS}, got {d}")
    if (k.shape != (b, kvh, sk, d) or v.shape != k.shape or h % kvh):
        raise ValueError(f"{what}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} do not match (kv heads must "
                         f"divide q heads)")
    if any(t.device != q.device for t in tensors.values()):
        raise ValueError(f"{what}: inputs on different devices")
    if b * h > 65535 or max(sq, sk) >= 2 ** 31:
        raise ValueError(f"{what} grid too large: b*h={b * h}, sq={sq}, "
                         f"sk={sk}")
    for name, t in tensors.items():
        if t.shape[-1] != d:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} has another "
                             f"head_dim")
        if not _kernel_layout_ok(t):
            raise ValueError(f"{what}: {name} strides {t.stride()} are not "
                             f"16-byte aligned with unit stride along "
                             f"head_dim")


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
    _check_kernel_inputs("flash kernel", q, k, v)
    out = _out_like_kernel(q)
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


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    lib = _build.load("flash_bwd")
    common = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.c_float, ctypes.c_int,
                                   ctypes.c_void_p]
    dkdv, dq = lib.rtt_flash_bwd_dkdv, lib.rtt_flash_bwd_dq
    dkdv.argtypes = [ctypes.c_void_p] * 8 + common
    dq.argtypes = [ctypes.c_void_p] * 7 + common
    dkdv.restype = dq.restype = ctypes.c_int
    return lib, dkdv, dq


def _flash_bwd_cuda(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """Launch the dK/dV kernel, then the dQ kernel: (dq, dk, dv) in bf16.

    q/k/v/o/dO may be strided views (unit stride along head_dim); lse is
    the forward's (b, h, sq) f32. delta = rowsum(dO * O) is computed
    here in plain torch, as the JAX launcher computes it outside its
    kernels. The gradients are written as (b, s, heads, d) memory, so the
    transposes back to the projections' layout are free views.
    """
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    _check_kernel_inputs("flash backward kernel", q, k, v, o=o, do=do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash backward kernel: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash backward kernel takes a contiguous f32 lse "
                         f"of shape {(b, h, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)

    def grad(heads, s):
        return torch.empty((b, s, heads, d), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    dq, dk, dv = grad(h, sq), grad(kvh, sk), grad(kvh, sk)
    if sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _flash_bwd_launch("dkdv", q, k, v, do, lse, delta, (dq, dk, dv), causal,
                      sm_scale)
    _flash_bwd_launch("dq", q, k, v, do, lse, delta, (dq, dk, dv), causal,
                      sm_scale)
    return dq, dk, dv


def _flash_bwd_launch(kind: str, q, k, v, do, lse, delta, grads,
                      causal: bool, sm_scale: float) -> None:
    """Launch one backward kernel ("dkdv" or "dq") into `grads` = (dq, dk,
    dv) on the current stream and count it. `_flash_bwd_cuda` has made
    the checks; the kernels' timing calls this directly, with delta
    computed once."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 21)(*[
        s for t in (q, k, v, do, *grads) for s in t.stride()[:3]])
    lib, dkdv_fn, dq_fn = _bwd_kernels()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    if kind == "dkdv":
        args += (grads[1].data_ptr(), grads[2].data_ptr())
    else:
        args += (grads[0].data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = dkdv_fn if kind == "dkdv" else dq_fn
        err = fn(*args, b, h, kvh, sq, sk, d, strides, float(sm_scale),
                 int(causal), stream)
    _build.check(lib, err, f"flash_attention {kind}")
    if kind == "dkdv":
        flash_attention.dkdv_launches += 1
    else:
        flash_attention.dq_launches += 1
