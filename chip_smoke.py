#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the serving and training paths
     from `ray_tpu_torch/ops/csrc/` (one nvcc per source, in parallel);
     reads each flash kernel's registers, shared memory and spills from
     ptxas, and its blocks per SM from the card;
  3. check: each kernel against its plain PyTorch version on the card,
     at the main paths' shapes and ragged ones (the forward over
     FWD_CASES, the backward over BWD_CASES: every edge of their tiles),
     with stated tolerances; two launches of the forward and of the
     backward kernels give the same bits;
     the flash autograd Function against autograd through
     `mha_reference`; a 2-layer model at the training width, its loss
     and grads in bf16 on the card against f32 on the CPU; a shape a
     kernel does not take must raise;
  4. time: each kernel, its plain version and one library call that
     computes the same function (a yardstick the port never calls),
     with CUDA events, beside the least time the card could take, at the
     serving and training shapes (the two backward kernels also as a
     pair against SDPA's backward);
  5. serve: llama3-8b at full width and depth (random weights from a
     seed) through the port's EngineCore, five requests, one submitted
     mid-flight; every serving kernel must have launched during this
     phase, and one prompt's prefill logits must agree with
     Transformer.apply; then torch.profiler splits an admission step
     and the decode steps after it by kernel, and gives the decode
     step's device idle share; then LLMEngine, the serving deployment
     class, on the same weights: the same requests streamed over its
     push token stream must give EngineCore's greedy tokens (consumer
     TTFT and TPOT beside EngineCore's decode p50), a wrong incarnation
     is fenced, a drain mid-generation hands back its descriptor, and an
     engine without a stream serves through next_tokens;
  6. runtime: the port's single-host runtime (`ray_tpu_torch.init`),
     which must count the card as its GPU resource: a CPU task, a 64 MiB
     put/get through shm, then a `num_gpus=1` actor that serves
     llama3-8b through EngineCore in its own process (the same requests
     as phase 5, whose tokens it must give exactly, with the flash
     forward and RMSNorm launched there); a second `num_gpus=1` actor
     waits until the first is killed; after `shutdown()` the card's
     memory is back;
  7. serve_llm: llama3-8b through `serve_llm`, the user's entry point:
     the weights `put` in the object store (each large tensor in its own
     shm segment), one `num_gpus=1` replica deployed by the Serve
     controller from that ObjectRef, the same five requests through
     `LLMHandle.generate` and their TokenStreams, which must give
     phase 5's EngineCore tokens exactly, with the flash forward and
     RMSNorm launched in the replica; after `serve.shutdown()` the
     card's memory is back;
  8. train: the model of the repo's `bench.py` (~0.95 B params, bf16,
     seq 2048, batch 2) at full width and depth through
     `ray_tpu_torch.bench.train_step` (loss, backward, AdamW): 2 warm-up
     and 20 timed steps on a fixed batch (step time, and the host's
     time to enqueue a step), finite and falling loss, the launch counts
     of every kernel per step, a torch.profiler split of one step with
     its device idle share; then loss and backward under remat, full
     against save_attn (launch counts, bitwise equal loss and grads,
     each step's time);
  9. trainer: the same model and batch through `TorchTrainer`, the
     user's entry point to training: one `num_gpus=1` worker in a
     one-rank nccl group, batches from a `ray_tpu_torch.data` Dataset
     through `iter_torch_batches`, a checkpoint of the params and the
     AdamW state at step 3 (~5.7 GB, with a checksum of every tensor),
     the worker killed at step 5 and the group restarted from that
     checkpoint to step 7: step 0's loss equal to phase 8's first,
     later losses within a stated tolerance of its same steps, every
     restored tensor equal to its checksum, 16 / 16 / 16 / 33 launches
     of the kernels a step in the worker; after `shutdown()` the card's
     memory is back.
The last three lines are the card (`nvidia-smi`), the kernels as JSON,
and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import itertools
import json
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import bench
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.metrics_plane import serving_metrics
from ray_tpu_torch.models import decode
from ray_tpu_torch.models.config import llama3_8b
from ray_tpu_torch.models.convert import init_for_serving
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attention_mod
from ray_tpu_torch.ops.attention import (_bwd_kernels, _flash_bwd_cuda,
                                         _flash_bwd_launch, _kernel,
                                         flash_attention,
                                         flash_attention_bwd_reference,
                                         flash_attention_reference,
                                         mha_reference)
from ray_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from ray_tpu_torch.serve.llm import LLMEngine, STREAM_STATS, stream_client
from ray_tpu_torch.serve.llm.engine import (FINISH_DRAINED, FINISH_LENGTH,
                                            FINISH_STOP, EngineCore)
from ray_tpu_torch.serve.llm.kv_cache import pages_needed

# Published peaks (NVIDIA data sheets, dense): bytes/s of device memory,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAKS = {
    "H100": (3.35e12, 989e12, 67e12),     # SXM part, 700 W
    "H200": (4.8e12, 989e12, 67e12),
}
EPS = 1e-5                                # llama3-8b norm_eps
D_MODEL, HEADS, KV_HEADS, HEAD_DIM = 4096, 32, 8, 128
S_MAIN = 2048                             # prefill bucket timed
DECODE_ROWS = 8                           # EngineCore max_batch
# bench.py's training shape: batch, seq, heads (MHA), d_model
TRAIN_B, TRAIN_S, TRAIN_HEADS, TRAIN_D = 2, 2048, 16, 2048
TRAIN_STEPS, TRAIN_WARMUP = 20, 2
# Tolerances, set from the arithmetic before any run:
#  * RMSNorm bf16: both sides round the same f32 value (up to sum order
#    and rsqrt rounding) to bf16, so they differ by at most one bf16 ulp,
#    which is at most 2^-7 of the value.
#  * RMSNorm f32: sum order and rsqrtf, a few f32 ulps.
#  * flash O (bf16): the kernel rounds unnormalised probabilities to
#    bf16 before P V, the plain version normalised ones; each term moves
#    by up to 2^-8 relative, and O itself is rounded to bf16.
#  * flash lse (f32): scores accumulate in another order; __expf.
#  * prefill logits vs Transformer.apply (bf16 through 32 layers): the
#    two run different matmul shapes (padded bucket vs exact length), so
#    every bf16 rounding in the residual stream may differ by an ulp.
#  * flash dQ/dK/dV (bf16) against the plain backward: both round P and
#    dS to bf16 from f32 values that differ only by sum order and
#    __expf, so a rounding flips on a few entries at most, and both round
#    the f32 sums to bf16: a difference of a bf16 ulp or two at the
#    largest values, 2^-7 of max|ref|; the limit is 1e-2 of max|ref|.
#    At s = 1 (one key: P = 1 and O = V, so dP = delta) dQ and dK are 0
#    in exact arithmetic and max|ref| is f32 rounding noise (~1e-7) on
#    both sides; there max|ref| is taken as at least 1e-3, three orders
#    below the gradients' scale in every other case, so a fault still
#    shows.
#  * the autograd Function (bf16 kernels) against autograd through
#    mha_reference in f32 on the same values: O, P, dS and the grads
#    are rounded to bf16 (2^-9 relative each) on the kernel side only;
#    2e-2 of max|ref| per gradient.
#  * 2-layer model, loss and grads on the card in bf16 against f32 on
#    the CPU, same parameter values: every activation of a layer's
#    forward and backward (about 20 tensors) is rounded to bf16 on the
#    card, and the grads themselves are stored in bf16; 5e-2 of each
#    grad's max|ref|, and 1e-2 absolute on a loss near log(32000).
#  * the trainer's losses against train()'s at the same step, after step
#    0 (which must be equal: the same weights, batch and forward
#    kernels): the embedding's backward may add a token's rows in
#    another order (atomics), so a bf16 weight may round one ulp (2^-8
#    of its value) the other way in a step, and each AdamW step after
#    it carries the difference on; 2e-2 of the loss allows a few such
#    roundings a step over the 7 steps compared.
TOL = {
    "rms_bf16": dict(rtol=2 ** -7, atol=1e-6),
    "rms_f32": dict(rtol=1e-5, atol=1e-5),
    "flash_o": dict(rtol=1e-2, atol=1e-2),
    "flash_lse": dict(rtol=1e-4, atol=1e-3),
    "logits_rel_to_max": 0.05,
    "flash_bwd_rel_to_max": 1e-2,
    "flash_bwd_floor_s1": 1e-3,
    "autograd_rel_to_max": 2e-2,
    "model_grad_rel_to_max": 5e-2,
    "model_loss_abs": 1e-2,
    "trainer_loss_rel": 2e-2,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> tuple:
    """(nvidia-smi line, peaks) or exit non-zero without a card."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    for part, peaks in PEAKS.items():
        if part in name and "PCIe" not in name:
            return smi, peaks
    raise RuntimeError(f"no published peaks for {name!r} in PEAKS")


def ptxas_resources(text: str) -> dict:
    """{kernel entry: {registers, spill_store_bytes, spill_load_bytes,
    smem_static_bytes}} from nvcc's `-Xptxas -v` messages."""
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {"smem_static_bytes": 0})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_store_bytes"] = int(m.group(1))
            entry["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            entry["smem_static_bytes"] = int(m.group(1))
    return out


def flash_entry(entry: str):
    """(kind, head_dim) of a flash kernel's mangled entry name, kind
    "fwd", "dkdv" or "dq"; None for another kernel."""
    m = re.search(r"flash_(fwd|bwd_dkdv|bwd_dq)_kernelILi(\d+)E", entry)
    return (m.group(1).removeprefix("bwd_"), int(m.group(2))) if m else None


def build() -> tuple:
    """(build seconds, {("fwd", head_dim) or ("dkdv" or "dq", head_dim):
    the flash kernel's ptxas resources, its dynamic shared memory and
    blocks per SM})."""
    t0 = time.perf_counter()
    libs = _build.build()
    dt = time.perf_counter() - t0
    flash = {}
    for name, path in libs.items():
        log(f"built {name}: {path.name}")
        text = path.with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"  ptxas {line.strip()}")
            if "instructions are serialized" in line:
                log(f"SERIALIZED: {name}: {line.strip()}")
        for entry, res in ptxas_resources(text).items():
            key = flash_entry(entry)
            if key:
                flash[key] = res
    ptr = ctypes.POINTER(ctypes.c_int)
    fwd_lib, bwd_lib = _kernel()[0], _bwd_kernels()[0]
    fwd_lib.rtt_flash_fwd_occupancy.argtypes = [ctypes.c_int, ptr, ptr]
    bwd_lib.rtt_flash_bwd_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ptr, ptr]
    for (kind, d), res in sorted(flash.items()):
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        out = (ctypes.byref(smem), ctypes.byref(blocks))
        if kind == "fwd":
            lib, err = fwd_lib, fwd_lib.rtt_flash_fwd_occupancy(d, *out)
        else:
            lib = bwd_lib
            err = bwd_lib.rtt_flash_bwd_occupancy(int(kind == "dq"), d, *out)
        _build.check(lib, err, "occupancy")
        res["smem_dynamic_bytes"] = smem.value
        res["blocks_per_sm"] = blocks.value
        log(f"  flash_{kind} head_dim {d}: {res}")
        if res.get("spill_store_bytes", 0) or res.get("spill_load_bytes", 0):
            log(f"SPILL: flash_{kind} head_dim {d}: "
                f"{res['spill_store_bytes']} bytes spill stores, "
                f"{res['spill_load_bytes']} bytes spill loads")
    want = {(kind, d) for kind in ("fwd", "dkdv", "dq") for d in (64, 128)}
    if set(flash) != want:
        raise RuntimeError(f"ptxas reported flash kernels {sorted(flash)}, "
                           f"expected {sorted(want)}")
    return dt, flash


def compare(out, ref, tol, what) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **tol,
                               msg=lambda m: f"{what}: {m}")
    return err


def check_rms(dev) -> float:
    """x in bf16 and f32, w in f32 (llama3-8b serving) and bf16 (the bench
    model trains with bf16 parameters)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, TOL["rms_bf16"]),
                       (torch.float32, TOL["rms_f32"])):
        for rows, d, wdt in ((DECODE_ROWS, D_MODEL, torch.float32),
                             (S_MAIN, D_MODEL, torch.float32),
                             (1000, D_MODEL, torch.float32),
                             (TRAIN_B * TRAIN_S, TRAIN_D, torch.bfloat16)):
            x = torch.randn(rows, d, generator=gen, device=dev)
            x = (3 * x).to(dtype)
            w = (0.1 * torch.randn(d, generator=gen, device=dev)).to(wdt)
            before = rms_norm.launches
            y = rms_norm(x, w, EPS)
            if rms_norm.launches != before + 1:
                raise AssertionError(f"rms_norm w {wdt} did not launch")
            err = compare(y, rms_norm_reference(x, w, EPS), tol,
                          f"rms_norm {dtype} w {wdt} rows={rows}")
            log(f"check rms_norm x {str(dtype):15s} w {str(wdt):15s} "
                f"({rows}, {d}): max_abs_err {err:.3e}")
            worst = max(worst, err)
    return worst


# (b, h, kvh, sq, sk, d, causal) for the forward: the llama3-8b prefill
# and training shapes (both masks), s 4096, ragged s 1000, sq != sk under
# each mask (top-left causal alignment); then the edges of the kernel's
# 64-row warpgroup tiles, 128-row blocks and 128-row K/V tiles, s 1 to 257
# with both masks and head dims, the GQA group cycling through 1, 4 and 8
FWD_EDGES = itertools.product(
    (1, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257), (64, 128),
    (True, False))
FWD_CASES = [(1, HEADS, KV_HEADS, S_MAIN, S_MAIN, HEAD_DIM, True),
             (1, HEADS, KV_HEADS, S_MAIN, S_MAIN, HEAD_DIM, False),
             (TRAIN_B, TRAIN_HEADS, TRAIN_HEADS, TRAIN_S, TRAIN_S, 128, True),
             (1, HEADS, KV_HEADS, 4096, 4096, HEAD_DIM, True),
             (1, 8, 2, 1000, 1000, 128, True),
             (1, 8, 2, 1000, 1000, 128, False),
             (2, 8, 2, 100, 300, 128, True), (2, 8, 2, 100, 300, 128, False),
             (2, 8, 2, 300, 100, 64, True), (2, 8, 2, 300, 100, 64, False)] + [
    (2, 8, 8 // (1, 4, 8)[i % 3], s, s, d, causal)
    for i, (s, d, causal) in enumerate(FWD_EDGES)]


def fwd_inputs(b, h, kvh, sq, sk, d, dev, gen):
    def r(heads, s):
        return torch.randn(b, heads, s, d, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
    return r(h, sq), r(kvh, sk), r(kvh, sk)


def check_flash(dev) -> tuple:
    """The forward kernel against the plain version over FWD_CASES: O and
    the natural-log lse."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst_o = worst_lse = 0.0
    for b, h, kvh, sq, sk, d, causal in FWD_CASES:
        q, k, v = fwd_inputs(b, h, kvh, sq, sk, d, dev, gen)
        before = flash_attention.launches
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        if flash_attention.launches != before + 1:
            raise AssertionError("flash forward kernel did not launch")
        ro, rlse = flash_attention_reference(q, k, v, causal)
        what = f"flash fwd b={b} h={h}/{kvh} sq={sq} sk={sk} d={d} " \
               f"causal={causal!s:5s}"
        eo = compare(o, ro, TOL["flash_o"], f"{what} O")
        el = compare(lse, rlse, TOL["flash_lse"], f"{what} lse")
        log(f"check {what}: O max_abs_err {eo:.3e}, lse max_abs_err "
            f"{el:.3e}")
        worst_o, worst_lse = max(worst_o, eo), max(worst_lse, el)
        del q, k, v, o, lse, ro, rlse
    return worst_o, worst_lse


def check_fwd_determinism(dev) -> None:
    """Two launches of the forward kernel on the same inputs give the
    same O and lse bits."""
    gen = torch.Generator(device=dev).manual_seed(12)
    for b, h, kvh, s in ((1, HEADS, KV_HEADS, S_MAIN),
                         (TRAIN_B, TRAIN_HEADS, TRAIN_HEADS, TRAIN_S)):
        q, k, v = fwd_inputs(b, h, kvh, s, s, HEAD_DIM, dev, gen)
        first = flash_attention(q, k, v, causal=True, return_lse=True)
        second = flash_attention(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        for name, x, y in zip(("O", "lse"), first, second):
            if not torch.equal(x, y):
                raise AssertionError(f"flash fwd {name} {(b, h, kvh, s)} "
                                     f"differs between two launches")
        log(f"check flash_fwd determinism b={b} h={h}/{kvh} s={s}: O, lse "
            f"bitwise equal over two launches")


def rel_err(got, ref, rel, what, floor: float = 0.0) -> tuple:
    """(max|got - ref|, that over max|ref|), raising above `rel`; max|ref|
    is taken as at least `floor`."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), floor)
    if not err <= rel * scale:
        raise AssertionError(f"{what}: max_abs_err {err:.4e} above "
                             f"{rel} x max|ref| {scale:.4e}")
    return err, err / scale


# (b, h, kvh, s, d, causal): the training shape, the llama3-8b GQA shape,
# ragged s 1000 (both masks), head_dim 64 (both masks); then the edges of
# the kernels' 64-row tiles, s 1 to 200 with both masks and head dims, the
# GQA group cycling through 1, 4 and 8
BWD_EDGES = itertools.product((1, 63, 64, 65, 127, 129, 200), (64, 128),
                              (True, False))
BWD_CASES = [(TRAIN_B, TRAIN_HEADS, TRAIN_HEADS, TRAIN_S, 128, True),
             (1, HEADS, KV_HEADS, S_MAIN, 128, True),
             (1, 8, 2, 1000, 128, True), (1, 8, 2, 1000, 128, False),
             (2, 8, 2, 300, 64, True), (2, 8, 2, 300, 64, False)] + [
    (2, 8, 8 // (1, 4, 8)[i % 3], s, d, causal)
    for i, (s, d, causal) in enumerate(BWD_EDGES)]


def bwd_inputs(b, h, kvh, s, d, causal, dev, gen):
    def r(heads):
        return torch.randn(b, heads, s, d, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
    q, k, v, do = r(h), r(kvh), r(kvh), r(h)
    o, lse = flash_attention_reference(q, k, v, causal)
    return q, k, v, o, lse, do


def check_flash_bwd(dev) -> dict:
    """Both backward kernels against the plain backward on the same
    inputs (the plain forward's O and lse), dO as a strided view."""
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {"dkdv": [0.0, 0.0], "dq": [0.0, 0.0]}
    for b, h, kvh, s, d, causal in BWD_CASES:
        q, k, v, o, lse, do = bwd_inputs(b, h, kvh, s, d, causal, dev, gen)
        do = do.transpose(1, 2).contiguous().transpose(1, 2)  # as the model
        before = (flash_attention.dkdv_launches, flash_attention.dq_launches)
        got = _flash_bwd_cuda(q, k, v, o, lse, do, causal, d ** -0.5)
        torch.cuda.synchronize()
        if (flash_attention.dkdv_launches, flash_attention.dq_launches) != \
                (before[0] + 1, before[1] + 1):
            raise AssertionError("backward kernels did not launch once each")
        want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
        floor = TOL["flash_bwd_floor_s1"] if s == 1 else 0.0
        errs = [rel_err(g, w, TOL["flash_bwd_rel_to_max"],
                        f"flash bwd {name} {(b, h, kvh, s, d)} {causal=}",
                        floor)
                for name, g, w in zip(("dq", "dk", "dv"), got, want)]
        log(f"check flash_bwd b={b} h={h}/{kvh} s={s} d={d} "
            f"causal={causal!s:5s}: max_abs_err (/max|ref|) " + ", ".join(
                f"{n} {a:.3e} ({r:.2e})"
                for n, (a, r) in zip(("dq", "dk", "dv"), errs)))
        for kind, pair in (("dq", errs[:1]), ("dkdv", errs[1:])):
            for a, r in pair:
                worst[kind] = [max(worst[kind][0], a), max(worst[kind][1], r)]
        del q, k, v, o, lse, do, got, want
    return worst


def check_bwd_determinism(dev) -> None:
    """Two launches of both backward kernels on the same inputs give the
    same bits: no atomics, a fixed order of sums."""
    gen = torch.Generator(device=dev).manual_seed(10)
    for b, h, kvh, s, d in ((TRAIN_B, TRAIN_HEADS, TRAIN_HEADS, TRAIN_S, 128),
                            (1, HEADS, KV_HEADS, 1000, 128),
                            (2, 8, 1, 129, 64)):
        ins = bwd_inputs(b, h, kvh, s, d, True, dev, gen)
        first = _flash_bwd_cuda(*ins, True, d ** -0.5)
        second = _flash_bwd_cuda(*ins, True, d ** -0.5)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), first, second):
            if not torch.equal(x, y):
                raise AssertionError(f"flash bwd {name} {(b, h, kvh, s, d)} "
                                     f"differs between two launches")
        log(f"check flash_bwd determinism b={b} h={h}/{kvh} s={s} d={d}: "
            f"dq, dk, dv bitwise equal over two launches")


def check_autograd(dev) -> float:
    """Gradients through flash_attention (the Function: forward kernel,
    then both backward kernels) against autograd through mha_reference
    in f32 on the same values."""
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    for b, h, kvh, s, d in ((TRAIN_B, TRAIN_HEADS, TRAIN_HEADS, 512, 128),
                            (1, 8, 2, 333, 64)):
        q, k, v, _, _, g = bwd_inputs(b, h, kvh, s, d, True, dev, gen)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        refs = [t.float().requires_grad_() for t in (q, k, v)]
        before = flash_attention.dq_launches
        out = flash_attention(*ins, causal=True)
        got = torch.autograd.grad(out, ins, g)
        if flash_attention.dq_launches != before + 1:
            raise AssertionError("the Function's backward did not launch")
        want = torch.autograd.grad(mha_reference(*refs, causal=True), refs,
                                   g.float())
        errs = [rel_err(a, w, TOL["autograd_rel_to_max"],
                        f"autograd d{n} {(b, h, kvh, s, d)}")
                for n, a, w in zip("qkv", got, want)]
        log(f"check flash autograd b={b} h={h}/{kvh} s={s} d={d}: "
            f"max_abs_err/max|ref| " + " ".join(
                f"d{n} {e[1]:.2e}" for n, e in zip("qkv", errs)))
        worst = max(worst, *(e[1] for e in errs))
    return worst


def check_model_grads(dev) -> dict:
    """A 2-layer model at the training width (the bench config, depth
    cut to 2): loss and every grad on the card in bf16 against the CPU
    in f32, with the same parameter values."""
    cfg = dataclasses.replace(bench.bench_config(), n_layers=2)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model, model32 = Transformer(cfg), Transformer(cfg32)
    params = model.init(7, device="cpu")               # bf16 leaves
    cpu = bench.make_batch(cfg, 2, 512, "cpu", seed=8)

    def each_leaf(fn):
        return {k: ([{n: fn(t) for n, t in layer.items()} for layer in v]
                    if k == "layers" else fn(v)) for k, v in params.items()}
    p32, pdev = each_leaf(torch.Tensor.float), each_leaf(lambda t: t.to(dev))
    grads = []
    for m, p, batch in ((model, pdev, {"tokens": cpu["tokens"].to(dev)}),
                        (model32, p32, cpu)):
        ps = bench.leaves(p)
        for t in ps:
            t.requires_grad_(True)
        loss = m.loss(p, batch)
        grads.append((loss.item(), torch.autograd.grad(loss, ps)))
    (loss, got), (loss32, want) = grads
    if not (abs(loss - loss32) <= TOL["model_loss_abs"]):
        raise AssertionError(f"2-layer loss {loss} on the card vs {loss32}")
    worst = max(rel_err(g.cpu(), w, TOL["model_grad_rel_to_max"],
                        f"2-layer grad #{i} {tuple(w.shape)}")[1]
                for i, (g, w) in enumerate(zip(got, want)))
    log(f"check 2-layer model (bench width, b=2, s=512): loss {loss:.5f} "
        f"vs f32 CPU {loss32:.5f}; worst grad max_abs_err/max|ref| "
        f"{worst:.3e} over {len(got)} leaves")
    return {"loss": loss, "loss_f32_cpu": loss32,
            "worst_grad_rel_err": worst}


def check_refusals(dev) -> None:
    """A CUDA tensor of a shape a kernel does not take raises; it never
    runs the plain version instead."""
    before = kernel_counts()
    bf = torch.bfloat16
    q = torch.ones(1, 2, 64, 64, device=dev, dtype=bf)
    lse = torch.zeros(1, 2, 64, device=dev)
    cases = [
        ("rms_norm d=4100", lambda: rms_norm(
            torch.ones(4, 4100, device=dev, dtype=torch.bfloat16),
            torch.zeros(4100, device=dev))),
        ("flash head_dim=96", lambda: flash_attention(
            *(torch.ones(1, 2, 8, 96, device=dev,
                         dtype=torch.bfloat16),) * 3)),
        ("flash f32", lambda: flash_attention(
            *(torch.ones(1, 2, 8, 64, device=dev),) * 3)),
        ("flash bwd f32 dO", lambda: _flash_bwd_cuda(
            q, q, q, q, lse, q.float(), True, 0.125)),
        ("flash bwd head_dim=96", lambda: _flash_bwd_cuda(
            *(torch.ones(1, 2, 8, 96, device=dev, dtype=bf),) * 4,
            torch.zeros(1, 2, 8, device=dev),
            torch.ones(1, 2, 8, 96, device=dev, dtype=bf), True, 0.1)),
        ("flash bwd lse (b, h, 8, sq)", lambda: _flash_bwd_cuda(
            q, q, q, q, lse[:, :, None].expand(1, 2, 8, 64), q, True,
            0.125)),
        ("flash bwd dO unit-stride-free", lambda: _flash_bwd_cuda(
            q, q, q, q, lse,
            torch.ones(1, 2, 64, 128, device=dev, dtype=bf)[..., ::2],
            True, 0.125)),
    ]
    for what, fn in cases:
        try:
            fn()
        except (TypeError, ValueError) as e:
            log(f"check refusal {what}: raised {type(e).__name__}")
            continue
        raise AssertionError(f"{what}: the wrapper did not raise")
    if kernel_counts() != before:
        raise AssertionError("a refused call counted a launch")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple:
    """(device ms, call ms) of one call, each the mean over `iters`.

    Device ms: CUDA events around `iters` back-to-back launches, queued
    behind a sleep kernel so the host has enqueued them all before the
    card reaches the first; a wrapper's host cost then cannot starve the
    card between launches. Call ms: host clock over `iters` calls and a
    synchronize, which is what a caller that waits on each call sees.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / iters
    mark, slept, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    n = iters
    while True:
        mark.record()
        torch.cuda._sleep(1 << 26)      # ~34 ms at 1.98 GHz
        slept.record()
        h0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - h0) * 1e3
        end.record()
        end.synchronize()
        if mark.elapsed_time(slept) > 1.2 * host_ms:
            return slept.elapsed_time(end) / n, call_ms
        # the host caught up with the card: too slow an enqueue, or the
        # launch queue filled up and blocked it (a plain version is many
        # small launches); queue fewer
        if n == 1:
            raise RuntimeError("could not queue a launch ahead of the card")
        n = max(1, n // 4)


def bound(nbytes: float, ops: float, op_peak: float, peaks) -> tuple:
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, ops / op_peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def time_three(kernel, plain, library, iters: int, plain_iters: int) -> dict:
    """Device and call times of a kernel, its plain version and the
    library call (see `time_ms`)."""
    out = {}
    for key, fn, n in (("", kernel, iters), ("plain_", plain, plain_iters),
                       ("library_", library, iters)):
        out[key + "ms"], out[key + "call_ms"] = time_ms(fn, n)
    return out


def time_rms(dev, peaks, rows: int, d: int = D_MODEL,
             wdt: torch.dtype = torch.float32) -> dict:
    """The kernel on bf16 x (rows, d) with a w of dtype `wdt`, against the
    plain version and F.rms_norm on the same x."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(rows, d, generator=gen, device=dev).bfloat16()
    w = (0.1 * torch.randn(d, generator=gen, device=dev)).to(wdt)
    w1 = (1 + w.float()).bfloat16()   # F.rms_norm's fused path: x's dtype
    iters = 200 if rows <= 64 else 50
    out = time_three(lambda: rms_norm(x, w, EPS),
                     lambda: rms_norm_reference(x, w, EPS),
                     lambda: F.rms_norm(x, (d,), w1, EPS),
                     iters, iters)
    nbytes = 2 * rows * d * 2 + d * w.element_size()
    out["bound_ms"], out["bound_by"] = bound(nbytes, 4 * rows * d, peaks[2],
                                             peaks)
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["shape"] = f"x ({rows}, {d}) bf16, w {str(wdt).split('.')[-1]}"
    return out


def time_flash(dev, peaks, b: int, h: int, kvh: int, s: int) -> dict:
    """The forward kernel, causal, head_dim 128, against the plain version
    and SDPA on the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = fwd_inputs(b, h, kvh, s, s, HEAD_DIM, dev, gen)
    out = time_three(lambda: flash_attention(q, k, v, causal=True),
                     lambda: flash_attention_reference(q, k, v, True),
                     lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=kvh != h),
                     20, 5)
    # causal: the lower triangle's s(s+1)/2 pairs, QK^T and PV, 2 FLOP
    # per multiply-add, for every q head
    ops = 2 * 2 * HEAD_DIM * b * h * s * (s + 1) / 2
    nbytes = b * (2 * h + 2 * kvh) * s * HEAD_DIM * 2 + b * h * s * 4
    out["bound_ms"], out["bound_by"] = bound(nbytes, ops, peaks[1], peaks)
    out["tflops"] = ops / out["ms"] / 1e9
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["shape"] = (f"q ({b}, {h}, {s}, {HEAD_DIM}), k/v ({b}, {kvh}, {s}, "
                    f"{HEAD_DIM}) bf16, causal")
    return out


def time_flash_bwd(dev, peaks) -> dict:
    """Each backward kernel at the training shape (b 2, 16 heads, s 2048,
    head_dim 128, causal), with delta computed once. The plain version
    computes dQ, dK and dV together, and so does the library yardstick,
    the backward of F.scaled_dot_product_attention: both are timed once
    and stand beside each kernel."""
    gen = torch.Generator(device=dev).manual_seed(9)
    b, h, s, d = TRAIN_B, TRAIN_HEADS, TRAIN_S, 128
    q, k, v, o, lse, do = bwd_inputs(b, h, h, s, d, True, dev, gen)
    delta = (do.float() * o.float()).sum(-1)
    grads = tuple(torch.empty_like(q) for _ in range(3))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    shared = {}
    for key, fn, n in (
            ("plain_", lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, do, True), 5),
            ("library_", lambda: torch.autograd.grad(
                sdpa, (qs, ks, vs), do, retain_graph=True), 10)):
        shared[key + "ms"], shared[key + "call_ms"] = time_ms(fn, n)
    pairs = b * h * s * (s + 1) / 2          # causal lower triangle
    out = {}
    for kind, products, writes in (("dkdv", 4, 2), ("dq", 3, 1)):
        t = dict(zip(("ms", "call_ms"), time_ms(
            lambda: _flash_bwd_launch(kind, q, k, v, do, lse, delta, grads,
                                      True, d ** -0.5), 10)))
        # reads q, k, v, dO (bf16) and lse, delta (f32); writes dK and dV,
        # or dQ (bf16)
        nbytes = (4 + writes) * b * h * s * d * 2 + 2 * b * h * s * 4
        flops = products * 2 * d * pairs
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops, peaks[1], peaks)
        t["tflops"] = flops / t["ms"] / 1e9
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t.update(shared)
        t["shape"] = (f"q/k/v/dO ({b}, {h}, {s}, {d}) bf16, causal; plain "
                      f"and library compute dQ, dK, dV together")
        out[kind] = t
    # both kernels together against SDPA's backward, which computes the
    # same three gradients in one call
    pair = {key: out["dkdv"][key] + out["dq"][key]
            for key in ("ms", "call_ms", "bound_ms")}
    pair["tflops"] = 7 * 2 * d * pairs / pair["ms"] / 1e9
    pair["bound_share"] = pair["bound_ms"] / pair["ms"]
    pair["library_ms"] = shared["library_ms"]
    pair["vs_library"] = pair["ms"] / shared["library_ms"]
    out["pair"] = pair
    return out


def kernel_counts() -> dict:
    return {"flash_fwd": flash_attention.launches,
            "flash_dkdv": flash_attention.dkdv_launches,
            "flash_dq": flash_attention.dq_launches,
            "rms_norm": rms_norm.launches}


def reset_counts() -> None:
    rms_norm.launches = flash_attention.launches = 0
    flash_attention.dkdv_launches = flash_attention.dq_launches = 0


class TimedCore(EngineCore):
    """EngineCore that records host wall time of each prefill and decode
    step; both end in a device-to-host copy, so the time covers the
    device work."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prefill_ms, self.decode_ms = [], []

    def _prefill(self, seq, toks):
        t0 = time.perf_counter()
        token = super()._prefill(seq, toks)
        self.prefill_ms.append((len(toks), (time.perf_counter() - t0) * 1e3))
        return token

    def _decode(self, *args):
        t0 = time.perf_counter()
        out = super()._decode(*args)
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        return out


# kernel classes of a training step, by name: first match wins
KERNEL_CLASSES = (("flash", ("flash_",)),
                  ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                  ("adamw", ("multi_tensor_apply",)),
                  ("copy_cast", ("copy",)),
                  ("other", ("",)))


def kernel_table(prof, top: int = 10) -> tuple:
    """(device ms summed over kernels, the top kernels by device time,
    device ms by KERNEL_CLASSES)."""
    from torch.autograd import DeviceType
    # a user annotation (e.g. "Optimizer.step#AdamW.step") also shows on
    # the device as a range over its kernels: counting it would count
    # those kernels twice. (A kernel's own name may hold "#" too, as in
    # "{lambda(int)#1}", so only the annotation's plain form is dropped.)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not re.fullmatch(r"[\w.]+#[\w.]+", e.key)]
    total = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    classes = dict.fromkeys((c for c, _ in KERNEL_CLASSES), 0.0)
    for name, ms, _ in rows:
        cls = next(c for c, keys in KERNEL_CLASSES
                   if any(k in name for k in keys))
        classes[cls] += ms
    return total, [{"kernel": name[:70], "ms": ms, "calls": n,
                    "share": ms / total if total else None}
                   for name, ms, n in rows[:top]], classes


def profile_steps(core, prompts, decode_p50: float) -> dict:
    """Where the device time goes: one admission step (two prefills, of
    2,900 and 300 tokens, then a decode) and the five pure decode steps
    after it, under torch.profiler. The profiler slows the host, so the
    idle share of a decode step is taken against the unprofiled p50."""
    from torch.profiler import ProfilerActivity, profile
    core.submit(prompts["r3"], max_tokens=6, rid="prof-long")
    core.submit(prompts["r1"], max_tokens=6, rid="prof-short")
    out = {}
    for phase in ("admit", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps = 0
            while core.has_work and (phase == "decode" or steps == 0):
                core.step()
                steps += 1
            torch.cuda.synchronize()
        busy, top, _ = kernel_table(prof)
        out[phase] = {"steps": steps, "device_ms": busy, "top": top}
    if out["decode"]["device_ms"] == 0:
        out["decode"]["idle_share"] = "not measured (no device events)"
    else:
        per_step = out["decode"]["device_ms"] / out["decode"]["steps"]
        out["decode"]["idle_share"] = max(0.0, 1 - per_step / decode_p50)
    return out


def serve_requests(cfg) -> tuple:
    """The serving schedule's requests: prompt lengths, new tokens and
    prompts (random tokens from seed 0) by request id."""
    rng = np.random.default_rng(0)
    lens = {"r0": 10, "r1": 300, "r2": 1100, "r3": 2900}
    new_tokens = {"r0": 32, "r1": 24, "r2": 16, "r3": 16, "mid": 24}
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).tolist()
               for rid, n in {**lens, "mid": 700}.items()}
    return lens, new_tokens, prompts


def run_schedule(core, prompts, lens, new_tokens) -> tuple:
    """A warm-up request, then the counted run: the four requests of
    `lens` at once and `mid` at step 3, stepped until the core is idle.
    Returns (tokens by rid, finish reason by rid, steps, wall s, kernel
    launches of the counted run)."""
    # warm-up request outside the counted window (cuBLAS heuristics,
    # the kernels' first loads)
    core.submit(prompts["r0"], max_tokens=2, rid="warm")
    while core.has_work:
        core.step()
    core.prefill_ms.clear()
    core.decode_ms.clear()

    done, tokens = {}, {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for rid in lens:
        core.submit(prompts[rid], max_tokens=new_tokens[rid], rid=rid)
    steps = 0
    while core.has_work:
        if steps == 3:
            core.submit(prompts["mid"], max_tokens=new_tokens["mid"],
                        rid="mid")
        for ev in core.step():
            if ev["token"] is not None:
                tokens.setdefault(ev["rid"], []).append(ev["token"])
            if ev["done"]:
                done[ev["rid"]] = ev["reason"]
        steps += 1
        if steps > 200:
            raise RuntimeError("engine did not go idle in 200 steps")
    torch.cuda.synchronize()
    return tokens, done, steps, time.perf_counter() - t0, kernel_counts()


def check_schedule(cfg, core, prompts, new_tokens, tokens, done,
                   launches) -> None:
    """Every request finished with its tokens in the vocab, no page is
    left allocated, and each serving kernel launched once a layer a
    prefill (flash forward) or twice a layer and once more a step
    (RMSNorm)."""
    if set(done) != set(prompts):
        raise AssertionError(f"finished {sorted(done)}, "
                             f"submitted {sorted(prompts)}")
    for rid, reason in done.items():
        if reason not in (FINISH_LENGTH, FINISH_STOP):
            raise AssertionError(f"{rid} finished with {reason!r}")
        toks = tokens[rid]
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{rid}: token outside the vocab")
        if reason == FINISH_LENGTH and len(toks) != new_tokens[rid]:
            raise AssertionError(f"{rid}: {len(toks)} tokens")
    st = core.stats()
    if st["free_pages"] != st["num_pages"]:
        raise AssertionError(f"pages leaked: {st}")
    n_prefill, n_decode = len(core.prefill_ms), len(core.decode_ms)
    want = {"flash_fwd": cfg.n_layers * n_prefill,
            "flash_dkdv": 0, "flash_dq": 0,
            "rms_norm": (2 * cfg.n_layers + 1) * (n_prefill + n_decode)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")


def serve(dev) -> dict:
    cfg = llama3_8b()
    model = Transformer(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_for_serving(model, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve: llama3-8b init on the card {time.perf_counter() - t0:.1f} s"
        f", {cfg.num_params() / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
    core = TimedCore(cfg, params, device=dev, num_pages=1024, page_size=16,
                     max_batch=DECODE_ROWS)
    lens, new_tokens, prompts = serve_requests(cfg)
    tokens, done, steps, wall, launches = run_schedule(core, prompts, lens,
                                                       new_tokens)
    check_schedule(cfg, core, prompts, new_tokens, tokens, done, launches)
    prefill_ms, decode_ms = list(core.prefill_ms), list(core.decode_ms)
    n_decode = len(decode_ms)

    # one prompt's paged prefill logits against the full forward
    rid = "r1"
    n = lens[rid]
    s_pad = 1 << (n - 1).bit_length()
    cache = decode.init_paged_cache(cfg, pages_needed(s_pad, 16), 16,
                                    device=dev)
    padded = torch.zeros(s_pad, dtype=torch.int64, device=dev)
    padded[:n] = torch.as_tensor(prompts[rid], device=dev)
    table = torch.arange(pages_needed(s_pad, 16), device=dev)
    with torch.inference_mode():
        got, _ = decode.prefill(model, params, padded, n, table, cache, 16)
        ref = model.apply(params, padded[None, :n])[0, n - 1]
    if not (torch.isfinite(got).all() and got.shape == (cfg.vocab_size,)):
        raise AssertionError("prefill logits not finite or misshapen")
    err = (got - ref).abs().max().item()
    lim = TOL["logits_rel_to_max"] * ref.abs().max().item()
    log(f"serve: prefill logits vs Transformer.apply ({n} tokens): "
        f"max_abs_err {err:.4f} (limit {lim:.4f}), max|ref| "
        f"{ref.abs().max().item():.3f}, argmax {int(got.argmax())} vs "
        f"{int(ref.argmax())}")
    if err > lim:
        raise AssertionError("prefill logits disagree with Transformer.apply")

    generated = sum(len(t) for t in tokens.values())
    decode_p50 = statistics.median(decode_ms)
    log("serve profile: " + json.dumps(profile_steps(core, prompts,
                                                     decode_p50)))
    out = {
        "requests": len(prompts), "steps": steps, "wall_s": wall,
        "generated_tokens": generated, "tokens_per_s": generated / wall,
        "prefill_ms": [(n_, round(ms, 3)) for n_, ms in prefill_ms],
        "decode_step_ms_p50": decode_p50,
        "decode_steps": n_decode, "launches": launches,
        "logits_max_abs_err": err, "tokens": tokens,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    del core, cache                  # the engine below makes its own cache
    gc.collect()
    torch.cuda.empty_cache()
    out["llm_engine"] = serve_engine(dev, cfg, params, prompts, new_tokens,
                                     tokens, done, decode_p50)
    return out


def get_frame(sink, eng, deadline: float, what: str) -> dict:
    """Next frame from a stream sink before `deadline`. Fails the phase
    on a timeout (naming whether the engine's step thread is alive), a
    lost connection, an unknown request or an error frame."""
    try:
        msg = sink.get(timeout=max(0.0, deadline - time.monotonic()))
    except queue.Empty:
        raise RuntimeError(f"{what}: no frame before the deadline; step "
                           f"thread alive: {eng._thread.is_alive()}") \
            from None
    if msg.get("type") != "llm_tok" or msg.get("unknown") or msg.get("err"):
        raise RuntimeError(f"{what}: stream frame {msg}")
    return msg


def accept_frame(msg: dict, got: list, what: str) -> int:
    """Append a frame's new tokens to `got`, trimmed by its `base`;
    returns how many were new. A frame that starts past the tokens
    already read fails the phase."""
    if msg["base"] > len(got):
        raise RuntimeError(f"{what}: frame at base {msg['base']} after "
                           f"{len(got)} tokens")
    fresh = msg["toks"][len(got) - msg["base"]:]
    got.extend(fresh)
    return len(fresh)


def serve_engine(dev, cfg, params, prompts, new_tokens, want, reasons,
                 decode_p50: float) -> dict:
    """LLMEngine, the serving deployment class, on the EngineCore phase's
    llama3-8b weights at full width and depth. Every wait has a deadline.
      * the same five requests through `generate`, each consumed over the
        push stream; the greedy tokens must equal the core phase's, and
        the flash forward must have launched once a layer a prefill;
        consumer-side TTFT (generate to the first token frame) and TPOT
        (the gap between token frames, per token);
      * a subscriber with a wrong incarnation: frames fenced, none
        delivered;
      * `drain` of a long request mid-generation: a terminal `drained`
        frame, and a descriptor carrying the tokens emitted so far;
      * with RAY_TPU_LLM_STREAM=0, an engine without a stream serving one
        request through `next_tokens`."""
    deadline_s = 120.0
    eng = LLMEngine(model=cfg, weights=params, device=dev, num_pages=1024,
                    page_size=16, max_batch=DECODE_ROWS)
    client = stream_client()
    try:
        # warm-up outside the counted window: the step thread's first
        # cuBLAS calls
        eng.generate(prompts["r0"], max_tokens=2, rid="warm")
        poll_tokens(eng, "warm", time.monotonic() + deadline_s)
        hist0 = serving_counts()
        stats0 = dict(STREAM_STATS)
        admitted0 = eng.core.counters["admitted"]
        sink = queue.Queue()      # one sink for every request: frames
        t_submit, got, last_t = {}, {}, {}     # carry their rid
        ttft, tpot, finished = [], [], {}
        torch.cuda.synchronize()
        reset_counts()
        for rid in want:
            t_submit[rid] = time.perf_counter()
            acc = eng.generate(prompts[rid], max_tokens=new_tokens[rid],
                               rid=rid)
            if not client.subscribe(acc["stream"], rid, acc["incarnation"],
                                    0, 0, sink):
                raise RuntimeError(f"subscribe {rid} refused")
            got[rid] = []
        deadline = time.monotonic() + deadline_s
        while len(finished) < len(want):
            msg = get_frame(sink, eng, deadline, "llm_engine stream")
            now, rid = time.perf_counter(), msg["req"]
            fresh = accept_frame(msg, got[rid], f"llm_engine stream {rid}")
            if fresh:
                if len(got[rid]) == fresh:
                    ttft.append((now - t_submit[rid]) * 1e3)
                else:
                    gap = (now - last_t[rid]) * 1e3 / fresh
                    tpot.extend([gap] * fresh)
                last_t[rid] = now
            if msg["done"]:
                finished[rid] = msg["reason"]
        launches = kernel_counts()
        admitted = eng.core.counters["admitted"] - admitted0
        hist = {k: v - hist0[k] for k, v in serving_counts().items()}
        stats = {k: v - stats0[k] for k, v in STREAM_STATS.items()}
        if got != {rid: want[rid] for rid in got} or finished != {
                rid: reasons[rid] for rid in finished}:
            raise AssertionError(
                "llm_engine streamed tokens differ from EngineCore's: " +
                json.dumps({rid: [got[rid], want[rid]] for rid in got
                            if got[rid] != want[rid]}))
        per_pass = 2 * cfg.n_layers + 1
        if (admitted != len(want)
                or launches["flash_fwd"] != cfg.n_layers * admitted
                or launches["flash_dkdv"] or launches["flash_dq"]
                or launches["rms_norm"] % per_pass
                or launches["rms_norm"] // per_pass <= admitted):
            raise AssertionError(f"llm_engine launches {launches} for "
                                 f"{admitted} admissions")
        generated = sum(len(t) for t in got.values())
        if hist["tokens"] != generated or hist["ttft"] != len(want) \
                or hist["tpot"] != generated - len(want):
            raise AssertionError(f"serving histograms counted {hist} for "
                                 f"{generated} tokens of {len(want)} "
                                 f"requests")

        # zombie fence: a subscriber expecting another incarnation
        z0 = STREAM_STATS["zombie_dropped"]
        acc = eng.generate(prompts["r0"], max_tokens=4, rid="zombie")
        zombie = queue.Queue()
        if not client.subscribe(acc["stream"], "zombie", "deadbeef", 0, 0,
                                zombie):
            raise RuntimeError("subscribe zombie refused")
        poll_tokens(eng, "zombie", time.monotonic() + deadline_s)
        deadline = time.monotonic() + deadline_s
        while STREAM_STATS["zombie_dropped"] == z0:
            if time.monotonic() > deadline:
                raise RuntimeError("no zombie frame was fenced")
            time.sleep(0.01)
        if not zombie.empty():
            raise AssertionError("a fenced frame reached the consumer")
        fenced = STREAM_STATS["zombie_dropped"] - z0

        # drain a long request mid-generation
        acc = eng.generate(prompts["r2"], max_tokens=200, rid="drain")
        dsink, dtoks = queue.Queue(), []
        if not client.subscribe(acc["stream"], "drain", acc["incarnation"],
                                0, 0, dsink):
            raise RuntimeError("subscribe drain refused")
        deadline = time.monotonic() + deadline_s
        while len(dtoks) < 3:
            msg = get_frame(dsink, eng, deadline, "drain")
            accept_frame(msg, dtoks, "drain")
        descs = eng.drain()
        while not msg["done"]:
            msg = get_frame(dsink, eng, deadline, "drain")
            accept_frame(msg, dtoks, "drain")
        emitted = descs[0]["emitted"] if descs else []
        n = min(len(emitted), len(want["r2"]))
        if ([d["rid"] for d in descs] != ["drain"]
                or msg["reason"] != FINISH_DRAINED
                or dtoks != emitted or not 3 <= len(emitted) < 200
                or emitted[:n] != want["r2"][:n]
                or eng.core.has_work
                or eng.core.alloc.free_pages != eng.core.num_pages):
            raise AssertionError(f"drain: descriptors {descs}, last frame "
                                 f"{msg}, {len(dtoks)} tokens streamed")
    finally:
        eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the polled path, on an engine without a stream
    os.environ["RAY_TPU_LLM_STREAM"] = "0"
    CONFIG.reload()
    try:
        eng = LLMEngine(model=cfg, weights=params, device=dev, num_pages=64,
                        page_size=16, max_batch=DECODE_ROWS)
        try:
            acc = eng.generate(prompts["r1"], max_tokens=new_tokens["r1"],
                               rid="polled")
            polled = poll_tokens(eng, "polled",
                                 time.monotonic() + deadline_s)
            if acc["stream"] is not None or polled != want["r1"]:
                raise AssertionError(f"polled engine: stream "
                                     f"{acc['stream']}, tokens {polled} vs "
                                     f"{want['r1']}")
        finally:
            eng.close()
    finally:
        del os.environ["RAY_TPU_LLM_STREAM"]
        CONFIG.reload()
    return {
        "requests": len(want), "generated_tokens": generated,
        "tokens_equal_engine_core": True, "launches": launches,
        "consumer_ttft_ms_p50": statistics.median(ttft),
        "consumer_tpot_ms_p50": statistics.median(tpot),
        "engine_core_decode_step_ms_p50": decode_p50,
        "consumer_ttft_ms": [round(t, 3) for t in ttft],
        "frames_out": stats["frames_out"], "tokens_in": stats["tokens_in"],
        "frames_in": stats["frames_in"], "histogram_counts": hist,
        "zombie_dropped": fenced, "drained_after_tokens": len(emitted),
        "polled_tokens_equal": True,
    }


def poll_tokens(eng, rid: str, deadline: float) -> list:
    """rid's tokens through `next_tokens`, before `deadline`."""
    out, cursor = [], 0
    while time.monotonic() < deadline:
        r = eng.next_tokens(rid, cursor=cursor, wait_s=1.0)
        if r["err"]:
            raise RuntimeError(f"{rid}: {r['err']}")
        out.extend(r["toks"])
        cursor = r["cursor"]
        if r["done"]:
            return out
    raise RuntimeError(f"{rid}: not done before the deadline; step thread "
                       f"alive: {eng._thread.is_alive()}")


def serving_counts() -> dict:
    """Observations in the serving histograms, and the token counter."""
    m = serving_metrics()
    return {"ttft": sum(v[1] for v in m["ttft"].snapshot()["series"]
                        .values()),
            "tpot": sum(v[1] for v in m["tpot"].snapshot()["series"]
                        .values()),
            "tokens": sum(m["tokens"].snapshot()["series"].values())}


def step_profile(model, params, opt, batch, step_p50: float) -> dict:
    """One training step under torch.profiler: kernel time by name, and
    the device idle share against the unprofiled step p50."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bench.train_step(model, params, opt, batch)
        torch.cuda.synchronize()
    busy, top, classes = kernel_table(prof, top=12)
    idle = ("not measured (no device events)" if busy == 0
            else max(0.0, 1 - busy / step_p50))
    return {"device_ms": busy, "idle_share": idle, "by_class_ms": classes,
            "top": top}


def loss_and_grads(model, params, batch) -> tuple:
    leaves = bench.leaves(params)
    loss = model.loss(params, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def remat_steps(cfg, params, batch, repeats: int = 5) -> dict:
    """Loss and backward (no update) of the bench model under remat:
    `remat_policy="full"` reruns every layer's forward, flash kernel
    included, in the backward; `"save_attn"` keeps the kernel's O and
    lse across the checkpoint, so it launches once a layer. Launch
    counts of each, loss and grads of the two bitwise equal (both
    kernels are deterministic: the recomputed O and lse are the saved
    ones), and each step's time, host clock ending in a synchronize,
    taken in turns (full, save_attn, save_attn, full) `repeats` times,
    with the host's time to enqueue it (a step whose enqueue takes as
    long as the step is held back by the host)."""
    models = {p: Transformer(dataclasses.replace(cfg, remat=True,
                                                 remat_policy=p))
              for p in ("full", "save_attn")}
    runs, measured, want = {}, {}, {
        "full": {"flash_fwd": 2 * cfg.n_layers, "flash_dkdv": cfg.n_layers,
                 "flash_dq": cfg.n_layers, "rms_norm": 4 * cfg.n_layers + 1},
        "save_attn": {"flash_fwd": cfg.n_layers, "flash_dkdv": cfg.n_layers,
                      "flash_dq": cfg.n_layers,
                      "rms_norm": 4 * cfg.n_layers + 1}}
    for policy, model in models.items():
        torch.cuda.synchronize()
        reset_counts()
        runs[policy] = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        measured[policy] = kernel_counts()
        if measured[policy] != want[policy]:
            raise AssertionError(f"remat {policy} step: launches "
                                 f"{measured[policy]}, expected "
                                 f"{want[policy]}")
    (loss, grads), (saved_loss, saved_grads) = runs["full"], \
        runs["save_attn"]
    if not (torch.isfinite(loss) and torch.equal(loss, saved_loss)):
        raise AssertionError(f"remat losses: full {loss.item()}, save_attn "
                             f"{saved_loss.item()}")
    differ = [i for i, (a, b) in enumerate(zip(grads, saved_grads))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"save_attn grads differ from full remat's in "
                             f"{len(differ)} of {len(grads)} leaves")
    del runs, grads, saved_grads
    step_ms = {"full": [], "save_attn": []}
    host_ms = {"full": [], "save_attn": []}
    for _ in range(repeats):
        for policy in ("full", "save_attn", "save_attn", "full"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_and_grads(models[policy], params, batch)
            host_ms[policy].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            step_ms[policy].append((time.perf_counter() - t0) * 1e3)
    p50 = {k: statistics.median(v) for k, v in step_ms.items()}
    host_p50 = {k: statistics.median(v) for k, v in host_ms.items()}
    log(f"remat steps (loss and backward, no update): full p50 "
        f"{p50['full']:.3f} ms, save_attn p50 {p50['save_attn']:.3f} ms "
        f"({p50['full'] - p50['save_attn']:.3f} ms less); host enqueue "
        f"p50 {host_p50}; launches {measured}; loss {loss.item():.6f} both, "
        f"grads bitwise equal over {len(bench.leaves(params))} leaves")
    return {"loss": loss.item(), "launches": measured,
            "grads_bitwise_equal": True,
            "step_ms_p50": p50, "saved_ms": p50["full"] - p50["save_attn"],
            "host_ms_p50": host_p50,
            "step_ms": {k: [round(t, 3) for t in v]
                        for k, v in step_ms.items()}}


def remat_host_split(cfg, params, batch, repeats: int = 5) -> dict:
    """Not run by `main`. Host enqueue and step time of a loss-and-backward
    step of the bench model under remat, in turns: `"full"`,
    `"save_attn"` (the record-and-replay scope of `attn_remat_policy`),
    and `"save_attn"` by selective checkpointing (`"dispatch_mode"`: a
    `TorchDispatchMode` that sees every op of the region and saves the
    flash op's outputs, the route the scope replaced). Each variant's
    launches are counted, and one step of each runs under torch.profiler
    (CPU): ops dispatched and their summed self time."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    import ray_tpu_torch.models.transformer as tmod

    def must_save_flash(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE
                if op is torch.ops.ray_tpu_torch.flash_fwd.default
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def dispatch_mode_policy():
        return lambda: create_selective_checkpoint_contexts(must_save_flash)

    models = {p: Transformer(dataclasses.replace(cfg, remat=True,
                                                 remat_policy=p))
              for p in ("full", "save_attn")}
    models["dispatch_mode"] = models["save_attn"]

    def step(name):
        if name == "dispatch_mode":
            tmod.attn_remat_policy = dispatch_mode_policy
        try:
            return loss_and_grads(models[name], params, batch)
        finally:
            tmod.attn_remat_policy = attention_mod.attn_remat_policy

    launches, prof = {}, {}
    for name in models:
        torch.cuda.synchronize()
        reset_counts()
        step(name)
        torch.cuda.synchronize()
        launches[name] = kernel_counts()
        with profile(activities=[ProfilerActivity.CPU]) as p:
            step(name)
            torch.cuda.synchronize()
        events = p.key_averages()
        prof[name] = {
            "ops": sum(e.count for e in events),
            "op_self_cpu_ms": sum(e.self_cpu_time_total for e in events)
            / 1e3}
    step_ms = {n: [] for n in models}
    host_ms = {n: [] for n in models}
    for _ in range(repeats):
        for name in ("full", "save_attn", "dispatch_mode", "dispatch_mode",
                     "save_attn", "full"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(name)
            host_ms[name].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3)
    out = {"launches": launches, "profile": prof,
           "step_ms_p50": {n: statistics.median(v)
                           for n, v in step_ms.items()},
           "host_ms_p50": {n: statistics.median(v)
                           for n, v in host_ms.items()}}
    log("remat host split: " + json.dumps(out))
    return out


def flash_call_host(dev, n: int = 200) -> dict:
    """Not run by `main`. Host time to enqueue one forward and backward of
    flash attention at the training shape, in turns: `flash_attention`
    (the op on detached inputs, then `_AttnFromSaved`), the op through its
    own autograd rule, and `_AttnFromSaved` on a direct launch (the route
    of an autograd Function around the ctypes launch, as the port had
    before the op). Each call starts after a synchronize; p50 in
    microseconds."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn(TRAIN_B, TRAIN_HEADS, TRAIN_S, 128,
                               generator=gen, device=dev).bfloat16()
                   for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    scale = 128 ** -0.5
    routes = {
        "flash_attention": lambda: flash_attention(q, k, v),
        "op_autograd": lambda: attention_mod.flash_fwd(
            q, k, v, True, scale)[0],
        "function": lambda: attention_mod._AttnFromSaved.apply(
            q, k, v, *attention_mod._flash_fwd_cuda(q, k, v, True, scale),
            True, scale)}
    us = {name: [] for name in routes}
    order = list(routes) + list(routes)[::-1]
    for _ in range(n):
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.autograd.grad(routes[name](), (q, k, v), do)
            us[name].append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    out = {name: statistics.median(v) for name, v in us.items()}
    log("flash call host us p50: " + json.dumps(out))
    return out


# The plain training step of the training phase, for `train_ab`: it uses
# only the bench API every slice of the port has, so it runs in any tree.
_TRAIN_AB = """
import json, statistics, time, torch
from ray_tpu_torch import bench
from ray_tpu_torch.models.transformer import Transformer
dev = torch.device("cuda", 0)
cfg = bench.bench_config()
model = Transformer(cfg)
params = model.init(0, device=dev)
opt = bench.make_optimizer(params)
batch = bench.make_batch(cfg, %d, %d, dev)
for _ in range(%d):
    bench.train_step(model, params, opt, batch).item()
step, host = [], []
for _ in range(%d):
    t0 = time.perf_counter()
    loss = bench.train_step(model, params, opt, batch)
    host.append((time.perf_counter() - t0) * 1e3)
    loss.item()
    step.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"step_ms_p50": statistics.median(step),
                  "host_ms_p50": statistics.median(host)}))
"""


def train_ab(trees) -> list:
    """Not run by `main`. The training phase's plain step (2 warm-up, 20
    timed) in each checkout of `trees`, in the order given (for example
    parent, change, change, parent), each in a process of its own that
    imports the port from that checkout: step p50 and host enqueue p50."""
    code = _TRAIN_AB % (TRAIN_B, TRAIN_S, TRAIN_WARMUP, TRAIN_STEPS)
    out = []
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", code], cwd=tree,
                           capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise RuntimeError(f"train_ab {tree}: {r.stderr[-2000:]}")
        out.append({"tree": str(tree),
                    **json.loads(r.stdout.strip().splitlines()[-1])})
        log("train_ab: " + json.dumps(out[-1]))
    return out


def train(dev, peaks) -> dict:
    """The bench.py model at full width and depth: 2 warm-up and 20 timed
    steps of loss, backward and AdamW on one fixed batch."""
    cfg = bench.bench_config()
    model = Transformer(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device=dev)
    opt = bench.make_optimizer(params)
    batch = bench.make_batch(cfg, TRAIN_B, TRAIN_S, dev)
    losses = [bench.train_step(model, params, opt, batch).item()
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    reset_counts()
    step_ms, host_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = bench.train_step(model, params, opt, batch)
        host_ms.append((time.perf_counter() - t0) * 1e3)   # enqueued
        losses.append(loss.item())                          # finished
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_counts()
    per_step = {"flash_fwd": cfg.n_layers, "flash_dkdv": cfg.n_layers,
                "flash_dq": cfg.n_layers, "rms_norm": 2 * cfg.n_layers + 1}
    if launches != {k: n * TRAIN_STEPS for k, n in per_step.items()}:
        raise AssertionError(f"train launches {launches} over "
                             f"{TRAIN_STEPS} steps, expected {per_step} "
                             f"per step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    p50 = statistics.median(step_ms)
    tokens = TRAIN_B * TRAIN_S
    tok_per_s = tokens * TRAIN_STEPS / (sum(step_ms) / 1e3)
    mfu = tok_per_s * cfg.flops_per_token() / bench.detect_peak(dev)
    profile = step_profile(model, params, opt, batch, p50)

    remat = remat_steps(cfg, params, batch)
    return {
        "params": cfg.num_params(), "batch": TRAIN_B, "seq": TRAIN_S,
        "steps": TRAIN_STEPS, "losses": losses,
        "step_ms_p50": p50, "step_ms": [round(t, 3) for t in step_ms],
        # host time to enqueue a step (train_step returns before the card
        # is done): near the step time, the host holds the step back
        "host_ms_p50": statistics.median(host_ms),
        "host_ms": [round(t, 3) for t in host_ms],
        "tokens_per_s": tok_per_s, "mfu": mfu,
        "flops_per_token": cfg.flops_per_token(),
        "launches": launches, "launches_per_step": per_step,
        "peak_mem_gib": peak_gib, "profile": profile,
        "remat_steps": remat,
    }


# The trainer phase: steps of the run, the step whose checkpoint is
# reported, and the step at which the first attempt's worker dies
TRAINER_STEPS, TRAINER_CKPT_STEP, TRAINER_DIE_STEP = 8, 3, 5


def checksum(t: torch.Tensor) -> int:
    """A position-weighted sum of a tensor's bits, on its own device
    (integer arithmetic: it does not depend on the order of the sum)."""
    flat = t.detach().reshape(-1)
    ints = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    total, chunk = 0, 1 << 24
    for i in range(0, ints.numel(), chunk):
        part = ints[i:i + chunk].to(torch.int64)
        w = torch.arange(i, i + part.numel(), device=part.device) % 65521 + 1
        total += int((part * w).sum())
    return total


def train_state_checksums(params, opt) -> list:
    """`checksum` of every parameter, then of every AdamW state tensor
    (by parameter, then by name)."""
    sums = [checksum(t) for t in bench.leaves(params)]
    state = opt.state_dict()["state"]
    for i in sorted(state):
        sums.extend(checksum(state[i][k]) for k in sorted(state[i]))
    return sums


def trainer_loop(config):
    """The trainer phase's `train_loop_per_worker` (pickled by value from
    the driver's `__main__`): the worker imports `chip_smoke` from the
    repo root on its PYTHONPATH and runs `trainer_worker` there."""
    import chip_smoke
    chip_smoke.trainer_worker(config)


def trainer_worker(config: dict) -> None:
    """In the train worker: the bench model from seed 0 (or restored from
    `get_checkpoint()`, every tensor held to the checksum saved with
    it), then a step a batch from `iter_torch_batches`: `train_step`, an
    all_reduce of the loss over the group, the launches of each kernel
    in this process during the step; a checkpoint of the params and the
    AdamW state at `ckpt_at`; the first attempt dies at `die_at`."""
    import torch.distributed as dist

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models.config import TransformerConfig
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train import checkpoint as ckpt_mod
    loop_start = time.time()
    dev = torch.device(config["device"])
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = TransformerConfig(**config["cfg"])
    model = Transformer(cfg)
    t0 = time.perf_counter()
    torch.zeros(1, device=dev).add_(1)   # this thread's first device op
    sync()
    cuda_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt = bench.make_optimizer(params)   # the first imports torch._dynamo
    first = {"loop_start": loop_start, "pid": os.getpid(),
             "first_op_s": cuda_s, "init_s": init_s,
             "optimizer_s": time.perf_counter() - t0}
    restored = rt_train.get_checkpoint()
    start = 0
    if restored is not None:
        t0 = time.perf_counter()
        state = restored.load_state()
        first["load_s"] = time.perf_counter() - t0
        with torch.no_grad():
            for p, t in zip(bench.leaves(params),
                            bench.leaves(state["params"])):
                p.copy_(t)
        opt.load_state_dict(state["opt"])
        sync()
        first["restore_s"] = time.perf_counter() - t0
        if train_state_checksums(params, opt) != state["checksums"]:
            raise AssertionError("a restored tensor differs from the "
                                 "checksum saved with it")
        first["checksums_equal"] = len(state["checksums"])
        start = state["step"] + 1
        del state
        shutil.rmtree(restored.path, ignore_errors=True)    # a 5.7 GB copy
    packs = []

    def timed_pack(path, _pack=ckpt_mod.pack_dir):
        t0 = time.perf_counter()
        data = _pack(path)
        packs.append({"pack_s": time.perf_counter() - t0,
                      "bytes": len(data), "packed_at": time.time()})
        return data
    ckpt_mod.pack_dir = timed_pack       # next_result packs through it
    stats = {}
    batches = iter(rt_train.get_dataset_shard("train").iter_torch_batches(
        batch_size=config["batch"], device=dev, stats=stats))
    for _ in range(start):               # the steps the checkpoint holds
        next(batches)
    world = dist.get_world_size()
    reset_counts()
    before = kernel_counts()
    for step in range(start, config["steps"]):
        batch = next(batches)
        t0 = time.perf_counter()
        loss = bench.train_step(model, params, opt, batch).clone()
        dist.all_reduce(loss)
        value = loss.item() / world
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = kernel_counts()
        metrics = {"step": step, "loss": value, "step_ms": step_ms,
                   "t": time.time(),
                   "launches": {k: counts[k] - before[k] for k in counts},
                   **first}
        before, first = counts, {}
        if step == config["die_at"] and restored is None:
            with open(config["death_file"], "w") as f:
                f.write(repr(time.time()))
            os._exit(1)
        ckpt = None
        if step == config["ckpt_at"]:
            t0 = time.perf_counter()
            sums = train_state_checksums(params, opt)
            metrics["checksum_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ckpt = Checkpoint.from_state(
                rt_train.make_temp_checkpoint_dir(),
                {"params": params, "opt": opt.state_dict(), "step": step,
                 "checksums": sums})
            metrics["save_s"] = time.perf_counter() - t0
            metrics["checksums"] = len(sums)
        elif step == config["ckpt_at"] + 1 and restored is None:
            deadline = time.monotonic() + 300
            while not packs and time.monotonic() < deadline:
                time.sleep(0.05)         # the step before's checkpoint
            metrics["pack"] = packs[0] if packs else None
        if step == config["steps"] - 1:
            batches.close()              # fills `stats`
            metrics.update(
                input_wait_s=stats["input_wait_s"],
                peak_mem_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                              if on_card else 0.0))
        rt_train.report(metrics, ckpt)


def trainer_phase(trained: dict, dev, cfg=None, batch: int = TRAIN_B,
                  seq: int = TRAIN_S) -> dict:
    """The bench model trained through `TorchTrainer`, the user's entry
    point, from one `num_gpus=1` worker in a one-rank nccl group, with
    `train()`'s batch fed from a Dataset by `iter_torch_batches`; a
    checkpoint at step 3 (params and AdamW state, ~5.7 GB), the worker
    killed at step 5, and a restart from that checkpoint to step 7.
    Step 0's loss must equal `train()`'s first, later steps within
    TOL["trainer_loss_rel"] of its same steps; every step launches each
    kernel as a `train()` step does; after `shutdown()` the card's
    memory is back within 1 GiB. `dev` is the card; the CPU only
    rehearses (a gloo group, `platform="cpu"`)."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import data as rt_data
    from ray_tpu_torch.train import (CheckpointConfig, CheckpointManager,
                                     FailureConfig, RunConfig, ScalingConfig,
                                     TorchConfig, TorchTrainer)
    on_card = dev.type == "cuda"
    cfg = cfg or bench.bench_config()
    tokens = bench.make_batch(cfg, batch, seq, "cpu")["tokens"].numpy()
    ds = rt_data.from_numpy({"tokens": np.tile(tokens, (TRAINER_STEPS, 1))})
    storage = tempfile.mkdtemp(prefix="rtt_trainer_phase_")
    death_file = os.path.join(storage, "died")
    config = {"cfg": dataclasses.asdict(cfg), "batch": batch,
              "steps": TRAINER_STEPS, "ckpt_at": TRAINER_CKPT_STEP,
              "die_at": TRAINER_DIE_STEP, "death_file": death_file,
              "device": "cuda" if on_card else "cpu"}
    registers = []
    register_bytes = CheckpointManager.register_bytes

    def timed_register(self, data, metrics=None):
        t0, at = time.perf_counter(), time.time()
        out = register_bytes(self, data, metrics)
        registers.append({"register_s": time.perf_counter() - t0,
                          "bytes": len(data), "arrived_at": at})
        return out
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    CheckpointManager.register_bytes = timed_register
    try:
        fit_at = time.time()
        result = TorchTrainer(
            trainer_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
            run_config=RunConfig(
                name="trainer_phase", storage_path=storage,
                checkpoint_config=CheckpointConfig(num_to_keep=1),
                failure_config=FailureConfig(max_failures=1)),
            backend_config=TorchConfig(
                distributed=True, platform=None if on_card else "cpu"),
            datasets={"train": ds}).fit()
        fit_s = time.time() - fit_at
    finally:
        CheckpointManager.register_bytes = register_bytes
        ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 60
    while (torch.cuda.mem_get_info()[0] < free0 - 2 ** 30
           and time.monotonic() < deadline):
        time.sleep(0.5)
    not_back = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 30
    try:
        if result.error is not None:
            raise AssertionError(f"TorchTrainer failed: {result.error!r}")
        hist = result.metrics_history
        steps = [m["step"] for m in hist]
        want = (list(range(TRAINER_DIE_STEP))
                + list(range(TRAINER_CKPT_STEP + 1, TRAINER_STEPS)))
        if steps != want:
            raise AssertionError(f"trainer steps {steps}, expected {want}")
        restart = TRAINER_DIE_STEP
        if hist[restart].get("checksums_equal") != hist[
                TRAINER_CKPT_STEP]["checksums"]:
            raise AssertionError("the restart did not check every tensor "
                                 "against its checksum")
        if hist[0]["loss"] != trained["losses"][0]:
            raise AssertionError(f"step 0 loss {hist[0]['loss']!r} differs "
                                 f"from train()'s {trained['losses'][0]!r}")
        rel = [abs(m["loss"] - trained["losses"][m["step"]])
               / abs(trained["losses"][m["step"]]) for m in hist]
        if max(rel) > TOL["trainer_loss_rel"]:
            raise AssertionError(f"trainer losses {[m['loss'] for m in hist]}"
                                 f" against train()'s "
                                 f"{trained['losses'][:TRAINER_STEPS]}")
        per_step = {"flash_fwd": cfg.n_layers, "flash_dkdv": cfg.n_layers,
                    "flash_dq": cfg.n_layers, "rms_norm": 2 * cfg.n_layers + 1}
        for m in hist:
            if m["launches"] != per_step:
                raise AssertionError(f"trainer step {m['step']} launched "
                                     f"{m['launches']}, expected {per_step}")
        if not_back > 1.0:
            raise AssertionError(f"{not_back:.2f} GiB of the card not back "
                                 f"after shutdown")
        with open(death_file) as f:
            died = float(f.read())
        pack = hist[TRAINER_CKPT_STEP + 1]["pack"]
        if len(registers) != 1 or pack is None:
            raise AssertionError(f"checkpoints registered {registers}, "
                                 f"packed {pack}")
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    first, again = hist[0], hist[restart]
    worker_ms = [m["step_ms"] for m in hist if m is not first
                 and m is not again]
    out = {
        "fit_s": fit_s,
        # fit() to the worker's loop: placement group, the worker's
        # spawn and imports, the nccl group's rendezvous, the session
        "group_start_s": first["loop_start"] - fit_at,
        "first_op_s": first["first_op_s"], "init_s": first["init_s"],
        "optimizer_s": first["optimizer_s"],
        "losses": [m["loss"] for m in hist], "steps": steps,
        "loss_rel_err_max": max(rel),
        "step_ms_p50": statistics.median(worker_ms),
        "train_step_ms_p50": trained["step_ms_p50"],
        "first_step_ms": first["step_ms"],
        "input_wait_s": hist[-1]["input_wait_s"],
        "checkpoint": {
            "bytes": registers[0]["bytes"],
            "checksum_s": hist[TRAINER_CKPT_STEP]["checksum_s"],
            "save_s": hist[TRAINER_CKPT_STEP]["save_s"],
            "pack_s": pack["pack_s"],
            "to_driver_s": registers[0]["arrived_at"] - pack["packed_at"],
            "register_s": registers[0]["register_s"]},
        "restart": {
            "to_loop_s": again["loop_start"] - died,
            "to_first_step_s": again["t"] - died,
            "first_op_s": again["first_op_s"], "init_s": again["init_s"],
            "optimizer_s": again["optimizer_s"], "load_s": again["load_s"],
            "restore_s": again["restore_s"],
            "checksums_equal": again["checksums_equal"]},
        "worker_peak_mem_gib": hist[-1]["peak_mem_gib"],
        "not_returned_gib": not_back,
        "launches_per_step": per_step,
        "launches": {k: sum(m["launches"][k] for m in hist)
                     for k in per_step},
    }
    log(f"trainer: group start {out['group_start_s']:.2f} s; worker step "
        f"p50 {out['step_ms_p50']:.2f} ms against train()'s "
        f"{out['train_step_ms_p50']:.2f} ms; input wait "
        f"{out['input_wait_s']:.4f} s")
    log("trainer: checkpoint " + json.dumps(out["checkpoint"]))
    log("trainer: restart " + json.dumps(out["restart"]) + f"; worker peak "
        f"{out['worker_peak_mem_gib']:.2f} GiB")
    return out


def _double(x):
    return 2 * x


class GpuServer:
    """The runtime phase's actor, made remote with `num_gpus=1`: in its
    own worker process it must see the card, then `serve` runs the
    serving schedule of `serve()` through EngineCore there."""

    def __init__(self):
        self.constructed = time.time()      # wall clock: the driver's too
        if not torch.cuda.is_available():
            raise RuntimeError("the GPU actor sees no card")
        self.pid = os.getpid()

    def ready(self) -> dict:
        name = torch.cuda.get_device_name(0)
        return {"pid": self.pid, "device": name,
                "constructed": self.constructed, "ready": time.time()}

    def serve(self) -> dict:
        import chip_smoke
        return chip_smoke.actor_serve(torch.device("cuda", 0))


def actor_serve(dev) -> dict:
    """Inside the GPU actor: llama3-8b from seed 0 on `dev`, then
    `serve()`'s schedule (a warm-up, five requests, `mid` at step 3)
    through EngineCore, with the launch counts of this process."""
    cfg = llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_for_serving(Transformer(cfg), seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    core = TimedCore(cfg, params, device=dev, num_pages=1024, page_size=16,
                     max_batch=DECODE_ROWS)
    lens, new_tokens, prompts = serve_requests(cfg)
    tokens, done, steps, wall, launches = run_schedule(core, prompts, lens,
                                                       new_tokens)
    check_schedule(cfg, core, prompts, new_tokens, tokens, done, launches)
    return {"pid": os.getpid(), "weights_init_s": init_s, "tokens": tokens,
            "steps": steps, "wall_s": wall, "launches": launches,
            "decode_step_ms_p50": statistics.median(core.decode_ms),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def runtime(served: dict) -> dict:
    """The port's single-host runtime with the card as a GPU resource:
    `init(num_cpus=4)` must report the card count as GPU; a CPU task
    round trip and a 64 MiB put/get through shm; a `num_gpus=1` actor in
    its own process serves llama3-8b and must give `serve()`'s exact
    EngineCore tokens, with the flash forward and RMSNorm launched in
    that process; a second `num_gpus=1` actor waits while the first
    holds the card and starts once it is killed; after `shutdown()` the
    card's free memory is back within 1 GiB."""
    import ray_tpu_torch
    from ray_tpu_torch._private.specs import SESSION_TAG
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    out = {"init_s": time.perf_counter() - t0}
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU")
        if gpus != torch.cuda.device_count():
            raise AssertionError(f"GPU resource {gpus}, cards "
                                 f"{torch.cuda.device_count()}")
        t0 = time.perf_counter()
        if ray_tpu_torch.get(ray_tpu_torch.remote(_double).remote(21),
                             timeout=120) != 42:
            raise AssertionError("CPU task round trip")
        out["cpu_task_s"] = time.perf_counter() - t0
        big = np.random.default_rng(0).integers(0, 256, 64 << 20,
                                                dtype=np.uint8)
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(big)
        back = ray_tpu_torch.get(ref)
        out["put_get_64mib_s"] = time.perf_counter() - t0
        segs = [n for n in os.listdir("/dev/shm")
                if n.startswith(f"rtt_{SESSION_TAG}_{ref.object_id}")]
        if not segs or not np.array_equal(back, big):
            raise AssertionError(f"64 MiB put/get: segments {segs}")
        del ref, back, big

        server = ray_tpu_torch.remote(num_gpus=1)(GpuServer)
        t0, wall0 = time.perf_counter(), time.time()
        first = server.remote()
        info = ray_tpu_torch.get(first.ready.remote(), timeout=300)
        out["actor_start_s"] = time.perf_counter() - t0
        # where the start goes: to the constructor (a worker's start, its
        # imports, torch's with the class), then to the first CUDA call
        out["actor_to_constructor_s"] = info["constructed"] - wall0
        out["actor_constructor_to_ready_s"] = info["ready"] - info["constructed"]
        if info["pid"] == os.getpid():
            raise AssertionError("the GPU actor runs in the driver")
        got = ray_tpu_torch.get(first.serve.remote(), timeout=900)
        out["held_gib"] = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 30
        log(f"runtime: actor start {out['actor_start_s']:.2f} s, weights "
            f"init {got['weights_init_s']:.2f} s (in the actor)")
        log(f"runtime: decode p50 {got['decode_step_ms_p50']:.3f} ms in the "
            f"actor, {served['decode_step_ms_p50']:.3f} ms in serve()")
        if got["tokens"] != served["tokens"]:
            raise AssertionError(f"actor tokens {got['tokens']} differ from "
                                 f"EngineCore's {served['tokens']}")
        for name in ("flash_fwd", "rms_norm"):
            if got["launches"][name] <= 0:
                raise AssertionError(f"{name} never launched in the actor")
        second = server.remote()
        second_ready = second.ready.remote()
        waiting, _ = ray_tpu_torch.wait([second_ready], timeout=2)
        if waiting:
            raise AssertionError("a second num_gpus=1 actor started while "
                                 "the first held the card")
        t0 = time.perf_counter()
        ray_tpu_torch.kill(first)
        started, _ = ray_tpu_torch.wait([second_ready], timeout=300)
        if not started:
            raise AssertionError("the second GPU actor did not start once "
                                 "the first was killed")
        out["second_actor_start_s"] = time.perf_counter() - t0
        if ray_tpu_torch.get(second_ready)["pid"] == info["pid"]:
            raise AssertionError("the second GPU actor reused the first's "
                                 "process")
        ray_tpu_torch.kill(second)
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 60
    while (torch.cuda.mem_get_info()[0] < free0 - 2 ** 30
           and time.monotonic() < deadline):
        time.sleep(0.5)
    out["not_returned_gib"] = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 30
    if out["not_returned_gib"] > 1.0:
        raise AssertionError(f"{out['not_returned_gib']:.2f} GiB of the card "
                             f"not back after shutdown")
    got.pop("tokens")
    return {**out, "actor": got}


def consume_streams(streams: dict, deadline_s: float) -> tuple:
    """Each TokenStream drained on its own thread, with the host time of
    every token. Returns (tokens, token times) by request id; raises what
    a consumer raised, or on a consumer still running at the deadline."""
    tokens, stamps, errors = {}, {}, {}

    def run(rid, stream):
        times = []
        try:
            for _ in stream:
                times.append(time.perf_counter())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[rid] = e
        tokens[rid], stamps[rid] = list(stream.emitted), times

    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in streams.items()]
    for t in threads:
        t.start()
    end = time.monotonic() + deadline_s
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"token streams still open after {deadline_s} s")
    for rid, e in errors.items():
        raise AssertionError(f"stream {rid} failed: {e!r}") from e
    return tokens, stamps


def serve_llm_phase(served: dict, dev) -> dict:
    """llama3-8b through `serve_llm`, the user's entry point to LLM
    serving: the weights from seed 0, made on the card and `put` in the
    object store (one shm segment a large tensor, timed), one replica
    (`num_gpus=1`) deployed through the Serve controller from that
    ObjectRef, then `serve()`'s five requests through `LLMHandle.generate`,
    each TokenStream consumed on its own thread. The tokens must equal
    `serve()`'s EngineCore tokens exactly, the flash forward must have
    launched once a layer a prefill in the replica and RMSNorm there too,
    and after `serve.shutdown()` and `shutdown()` the card's free memory
    is back within 1 GiB. `dev` is the card; the CPU only rehearses."""
    import ray_tpu_torch
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch._private import context
    from ray_tpu_torch._private.specs import SESSION_TAG
    from ray_tpu_torch.serve.llm import serve_llm
    on_card = dev.type == "cuda"
    cfg = llama3_8b()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    out = {}
    try:
        params = init_for_serving(Transformer(cfg), seed=0, device=dev)
        leaves = bench.leaves(params)
        sizes = [t.numel() * t.element_size() for t in leaves]
        large = sum(n >= CONFIG.inline_threshold_bytes for n in sizes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(params)
        out["put_s"] = time.perf_counter() - t0
        segs = [n for n in os.listdir("/dev/shm")
                if n.startswith(f"rtt_{SESSION_TAG}_{ref.object_id}_")]
        out.update(weights_bytes=sum(sizes), tensors=len(leaves),
                   large_tensors=large, shm_segments=len(segs))
        if len(segs) != large:
            raise AssertionError(f"put made {len(segs)} shm segments for "
                                 f"{large} tensors over the inline limit")
        del params, leaves
        gc.collect()
        torch.cuda.empty_cache()

        lens, new_tokens, prompts = serve_requests(cfg)
        t0 = time.perf_counter()
        handle = serve_llm(
            name="llama3-8b", model=cfg, weights=ref, num_replicas=1,
            num_pages=1024, page_size=16, max_batch=DECODE_ROWS,
            ray_actor_options={"num_gpus": 1} if on_card else {},
            device=None if on_card else "cpu")
        out["serve_llm_s"] = time.perf_counter() - t0
        deadline = time.monotonic() + 300
        while not (stats := handle.stats()):
            if time.monotonic() > deadline:
                actors = [(a["state"], a["num_restarts"], a["death_cause"])
                          for a in context.get_ctx().state_op("list_actors")]
                raise AssertionError(f"the replica did not answer in 300 s: "
                                     f"{rt_serve.status()}, actors {actors}")
            time.sleep(0.2)
        out["replica_first_answer_s"] = time.perf_counter() - t0
        if len(stats) != 1:
            raise AssertionError(f"{len(stats)} replicas answered, not 1")
        out["replica_weights_s"] = stats[0]["weights_s"]
        # warm-up outside the counted run: the replica's first cuBLAS
        # calls and the stream's first connection
        warm = handle.generate(prompts["r0"], max_tokens=2, timeout_s=120)
        if len(warm.tokens()) != 2:
            raise AssertionError("warm-up request")
        before = handle.stats()[0]["kernel_launches"]
        submitted = {}
        streams = {}
        for rid in prompts:
            submitted[rid] = time.perf_counter()
            streams[rid] = handle.generate(prompts[rid],
                                           max_tokens=new_tokens[rid],
                                           timeout_s=120)
        tokens, stamps = consume_streams(streams, 300.0)
        after = handle.stats()[0]
        launches = {k: after["kernel_launches"][k] - before[k]
                    for k in before}
        out["launches"] = {"flash_fwd": launches["flash_fwd"],
                           "flash_dkdv": 0, "flash_dq": 0,
                           "rms_norm": launches["rms_norm"]}
        if tokens != served["tokens"]:
            raise AssertionError(f"serve_llm tokens {tokens} differ from "
                                 f"EngineCore's {served['tokens']}")
        if launches["flash_fwd"] != cfg.n_layers * len(prompts):
            raise AssertionError(f"flash_fwd launched "
                                 f"{launches['flash_fwd']} times in the "
                                 f"replica, expected a layer a prefill")
        if launches["rms_norm"] <= 0:
            raise AssertionError("rms_norm never launched in the replica")
        ttft = [stamps[rid][0] - submitted[rid] for rid in prompts]
        tpot = [b - a for rid in prompts
                for a, b in zip(stamps[rid], stamps[rid][1:])]
        out.update(ttft_ms_p50=statistics.median(ttft) * 1e3,
                   tpot_ms_p50=statistics.median(tpot) * 1e3,
                   generated_tokens=sum(map(len, tokens.values())),
                   replica_peak_gib=after.get("device_peak_bytes", 0)
                   / 2 ** 30)
        del ref
    finally:
        try:
            rt_serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 60
    while (torch.cuda.mem_get_info()[0] < free0 - 2 ** 30
           and time.monotonic() < deadline):
        time.sleep(0.5)
    out["not_returned_gib"] = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 30
    if out["not_returned_gib"] > 1.0:
        raise AssertionError(f"{out['not_returned_gib']:.2f} GiB of the card "
                             f"not back after shutdown")
    log(f"serve_llm: put {out['put_s']:.2f} s ({out['shm_segments']} shm "
        f"segments), replica answers {out['replica_first_answer_s']:.2f} s "
        f"after serve_llm (weights {out['replica_weights_s']:.2f} s there), "
        f"TTFT p50 {out['ttft_ms_p50']:.1f} ms, TPOT p50 "
        f"{out['tpot_ms_p50']:.2f} ms")
    return out


def resources(res: dict, kind: str) -> dict:
    """A flash kernel's resources at head_dim 128 (the main paths'), then
    ptxas's and the card's numbers at both head dims."""
    r = res[kind, 128]
    return {"registers": r["registers"],
            "smem_bytes": r["smem_static_bytes"] + r["smem_dynamic_bytes"],
            "spill_bytes": r["spill_store_bytes"] + r["spill_load_bytes"],
            "blocks_per_sm": r["blocks_per_sm"],
            "ptxas": {d: res[kind, d] for d in (64, 128)}}


def main() -> None:
    smi, peaks = card()
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    build_s, res = build()
    log(f"build: {build_s:.1f} s")

    rms_err = check_rms(dev)
    flash_err, lse_err = check_flash(dev)
    check_fwd_determinism(dev)
    bwd_err = check_flash_bwd(dev)
    check_bwd_determinism(dev)
    autograd_err = check_autograd(dev)
    model_check = check_model_grads(dev)
    check_refusals(dev)

    rms_pre = time_rms(dev, peaks, S_MAIN)
    rms_dec = time_rms(dev, peaks, DECODE_ROWS)
    rms_train = time_rms(dev, peaks, TRAIN_B * TRAIN_S, TRAIN_D,
                         torch.bfloat16)
    flash = time_flash(dev, peaks, 1, HEADS, KV_HEADS, S_MAIN)
    flash_4k = time_flash(dev, peaks, 1, HEADS, KV_HEADS, 4096)
    flash_train = time_flash(dev, peaks, TRAIN_B, TRAIN_HEADS, TRAIN_HEADS,
                             TRAIN_S)
    bwd = time_flash_bwd(dev, peaks)
    for what, t in (("rms_norm prefill", rms_pre),
                    ("rms_norm decode", rms_dec),
                    ("rms_norm train", rms_train),
                    ("flash_fwd s=2048", flash),
                    ("flash_fwd s=4096", flash_4k),
                    ("flash_fwd train", flash_train),
                    ("flash_dkdv train", bwd["dkdv"]),
                    ("flash_dq train", bwd["dq"]),
                    ("flash_bwd pair train", bwd["pair"])):
        log(f"time {what}: " + json.dumps(t))
    gc.collect()
    torch.cuda.empty_cache()

    served = serve(dev)
    log("serve: " + json.dumps(served))
    gc.collect()
    torch.cuda.empty_cache()
    # every engine is closed: none of its threads may still hold the
    # weights or a KV cache
    left = torch.cuda.memory_allocated() / 2 ** 30
    if left > 1.0:
        raise AssertionError(f"serving left {left:.2f} GiB allocated")
    ran = runtime(served)
    log("runtime: " + json.dumps(ran))
    llm_served = serve_llm_phase(served, dev)
    log("serve_llm: " + json.dumps(llm_served))
    trained = train(dev, peaks)
    log("train: " + json.dumps(trained))
    gc.collect()
    torch.cuda.empty_cache()
    fitted = trainer_phase(trained, dev)
    log("trainer: " + json.dumps(fitted))
    # launches on each main path, each read just after that path ran
    paths = {"engine_core": served["launches"],
             "llm_engine": served["llm_engine"]["launches"],
             "actor_engine_core": ran["actor"]["launches"],
             "serve_llm_replica": llm_served["launches"],
             "train_20_steps": trained["launches"],
             "train_remat_full_step":
                 trained["remat_steps"]["launches"]["full"],
             "train_remat_save_attn_step":
                 trained["remat_steps"]["launches"]["save_attn"],
             "trainer": fitted["launches"]}
    for name in ("flash_fwd", "flash_dkdv", "flash_dq", "rms_norm"):
        if sum(p[name] for p in paths.values()) == 0:
            raise AssertionError(f"{name} never launched on a main path")

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/attention.py:69",
         "launches": served["launches"]["flash_fwd"],
         "launches_train": trained["launches"]["flash_fwd"],
         "launches_by_path": by_path("flash_fwd"),
         "max_abs_err": flash_err, "lse_max_abs_err": lse_err,
         "tolerance": {"o": TOL["flash_o"], "lse": TOL["flash_lse"]},
         **flash, "kernel_ms": flash["ms"], "s4096": flash_4k,
         "train": flash_train, **resources(res, "fwd")},
        *({"name": f"flash_{kind}", "route": "cuda",
           "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
           "replaces": f"ray_tpu/ops/attention.py:{line}",
           "launches": trained["launches"][f"flash_{kind}"],
           "launches_by_path": by_path(f"flash_{kind}"),
           "max_abs_err": bwd_err[kind][0],
           "max_err_rel_to_max": bwd_err[kind][1],
           "tolerance": {"rel_to_max": TOL["flash_bwd_rel_to_max"]},
           "autograd_rel_err": autograd_err,
           **bwd[kind], "kernel_ms": bwd[kind]["ms"],
           **resources(res, kind), "pair": bwd["pair"]}
          for kind, line in (("dkdv", 177), ("dq", 244))),
        {"name": "rms_norm", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/rms_norm.cu",
         "replaces": "ray_tpu/ops/norms.py:34",
         "launches": served["launches"]["rms_norm"],
         "launches_train": trained["launches"]["rms_norm"],
         "launches_by_path": by_path("rms_norm"),
         "max_abs_err": rms_err,
         "tolerance": {"bf16": TOL["rms_bf16"], "f32": TOL["rms_f32"]},
         **rms_pre, "kernel_ms": rms_pre["ms"], "decode": rms_dec,
         "train": rms_train},
    ]
    log("check model: " + json.dumps(model_check))
    print(smi)                  # name, power limit as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
