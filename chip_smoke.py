#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the serving path from
     `ray_tpu_torch/ops/csrc/` (one nvcc per source, in parallel);
  3. check: each kernel against its plain PyTorch version on the card,
     at the serving path's shapes and ragged ones, with stated
     tolerances; a shape a kernel does not take must raise;
  4. time: each kernel, its plain version and one library call that
     computes the same function (a yardstick the port never calls),
     with CUDA events, beside the least time the card could take;
  5. serve: llama3-8b at full width and depth (random weights from a
     seed) through the port's EngineCore, five requests, one submitted
     mid-flight; every kernel must have launched during this phase, and
     one prompt's prefill logits must agree with Transformer.apply; then
     torch.profiler splits an admission step and the decode steps after
     it by kernel, and gives the decode step's device idle share.
The last three lines are the card (`nvidia-smi`), the kernels as JSON,
and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import decode
from ray_tpu_torch.models.config import llama3_8b
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (flash_attention,
                                         flash_attention_reference)
from ray_tpu_torch.ops.norms import rms_norm, rms_norm_reference
from ray_tpu_torch.serve.llm.engine import FINISH_LENGTH, FINISH_STOP, \
    EngineCore
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
TOL = {
    "rms_bf16": dict(rtol=2 ** -7, atol=1e-6),
    "rms_f32": dict(rtol=1e-5, atol=1e-5),
    "flash_o": dict(rtol=1e-2, atol=1e-2),
    "flash_lse": dict(rtol=1e-4, atol=1e-3),
    "logits_rel_to_max": 0.05,
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


def build() -> float:
    t0 = time.perf_counter()
    libs = _build.build()
    dt = time.perf_counter() - t0
    for name, path in libs.items():
        log(f"built {name}: {path.name}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {line.strip()}")
    return dt


def compare(out, ref, tol, what) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **tol,
                               msg=lambda m: f"{what}: {m}")
    return err


def check_rms(dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, TOL["rms_bf16"]),
                       (torch.float32, TOL["rms_f32"])):
        for rows in (DECODE_ROWS, S_MAIN, 1000):
            x = torch.randn(rows, D_MODEL, generator=gen, device=dev)
            x = (3 * x).to(dtype)
            w = 0.1 * torch.randn(D_MODEL, generator=gen, device=dev)
            err = compare(rms_norm(x, w, EPS), rms_norm_reference(x, w, EPS),
                          tol, f"rms_norm {dtype} rows={rows}")
            log(f"check rms_norm {str(dtype):15s} ({rows}, {D_MODEL}): "
                f"max_abs_err {err:.3e}")
            worst = max(worst, err)
    return worst


def qkv(s, dev, gen, b=1):
    def r(h):
        return torch.randn(b, h, s, HEAD_DIM, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
    return r(HEADS), r(KV_HEADS), r(KV_HEADS)


def check_flash(dev) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(2)
    worst_o = worst_lse = 0.0
    for s in (16, 1000, S_MAIN):
        q, k, v = qkv(s, dev, gen)
        for causal in (True, False):
            o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            ro, rlse = flash_attention_reference(q, k, v, causal)
            eo = compare(o, ro, TOL["flash_o"], f"flash O s={s} {causal=}")
            el = compare(lse, rlse, TOL["flash_lse"],
                         f"flash lse s={s} {causal=}")
            log(f"check flash_fwd s={s:5d} causal={causal!s:5s}: "
                f"O max_abs_err {eo:.3e}, lse max_abs_err {el:.3e}")
            worst_o, worst_lse = max(worst_o, eo), max(worst_lse, el)
    return worst_o, worst_lse


def check_refusals(dev) -> None:
    """A CUDA tensor of a shape a kernel does not take raises; it never
    runs the plain version instead."""
    before = (rms_norm.launches, flash_attention.launches)
    cases = [
        ("rms_norm d=4100", lambda: rms_norm(
            torch.ones(4, 4100, device=dev, dtype=torch.bfloat16),
            torch.zeros(4100, device=dev))),
        ("flash head_dim=96", lambda: flash_attention(
            *(torch.ones(1, 2, 8, 96, device=dev,
                         dtype=torch.bfloat16),) * 3)),
        ("flash f32", lambda: flash_attention(
            *(torch.ones(1, 2, 8, 64, device=dev),) * 3)),
    ]
    for what, fn in cases:
        try:
            fn()
        except (TypeError, ValueError) as e:
            log(f"check refusal {what}: raised {type(e).__name__}")
            continue
        raise AssertionError(f"{what}: the wrapper did not raise")
    if (rms_norm.launches, flash_attention.launches) != before:
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


def time_rms(dev, peaks, rows: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(rows, D_MODEL, generator=gen, device=dev).bfloat16()
    w = 0.1 * torch.randn(D_MODEL, generator=gen, device=dev)
    w1 = (1 + w).bfloat16()   # F.rms_norm's fused path wants x's dtype
    iters = 200 if rows <= 64 else 50
    out = time_three(lambda: rms_norm(x, w, EPS),
                     lambda: rms_norm_reference(x, w, EPS),
                     lambda: F.rms_norm(x, (D_MODEL,), w1, EPS),
                     iters, iters)
    nbytes = 2 * rows * D_MODEL * 2 + D_MODEL * 4
    out["bound_ms"], out["bound_by"] = bound(nbytes, 4 * rows * D_MODEL,
                                             peaks[2], peaks)
    out["shape"] = f"x ({rows}, {D_MODEL}) bf16, w f32"
    return out


def time_flash(dev, peaks, s: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = qkv(s, dev, gen)
    out = time_three(lambda: flash_attention(q, k, v, causal=True),
                     lambda: flash_attention_reference(q, k, v, True),
                     lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=True),
                     10, 5)
    # causal: the lower triangle's s(s+1)/2 pairs, QK^T and PV, 2 FLOP
    # per multiply-add, for every q head
    ops = 2 * 2 * HEAD_DIM * HEADS * s * (s + 1) / 2
    nbytes = (2 * HEADS + 2 * KV_HEADS) * s * HEAD_DIM * 2 + HEADS * s * 4
    out["bound_ms"], out["bound_by"] = bound(nbytes, ops, peaks[1], peaks)
    out["shape"] = (f"q (1, {HEADS}, {s}, {HEAD_DIM}), k/v (1, {KV_HEADS}, "
                    f"{s}, {HEAD_DIM}) bf16, causal")
    return out


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


def kernel_table(prof, top: int = 10) -> tuple:
    """(device ms summed over kernels, the top kernels by device time)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return total, [{"kernel": name[:70], "ms": ms, "calls": n,
                    "share": ms / total if total else None}
                   for name, ms, n in rows[:top]]


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
        busy, top = kernel_table(prof)
        out[phase] = {"steps": steps, "device_ms": busy, "top": top}
    if out["decode"]["device_ms"] == 0:
        out["decode"]["idle_share"] = "not measured (no device events)"
    else:
        per_step = out["decode"]["device_ms"] / out["decode"]["steps"]
        out["decode"]["idle_share"] = max(0.0, 1 - per_step / decode_p50)
    return out


def serve(dev) -> dict:
    cfg = llama3_8b()
    model = Transformer(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve: llama3-8b init on the card {time.perf_counter() - t0:.1f} s"
        f", {cfg.num_params() / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
    core = TimedCore(cfg, params, device=dev, num_pages=1024, page_size=16,
                     max_batch=DECODE_ROWS)
    rng = np.random.default_rng(0)
    lens = {"r0": 10, "r1": 300, "r2": 1100, "r3": 2900}
    new_tokens = {"r0": 32, "r1": 24, "r2": 16, "r3": 16, "mid": 24}
    prompts = {rid: rng.integers(0, cfg.vocab_size, n).tolist()
               for rid, n in {**lens, "mid": 700}.items()}

    # warm-up request outside the counted window (cuBLAS heuristics,
    # the kernels' first loads)
    core.submit(prompts["r0"], max_tokens=2, rid="warm")
    while core.has_work:
        core.step()
    core.prefill_ms.clear()
    core.decode_ms.clear()

    done, tokens = {}, {}
    torch.cuda.synchronize()
    rms_norm.launches = flash_attention.launches = 0
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
    wall = time.perf_counter() - t0
    launches = {"rms_norm": rms_norm.launches,
                "flash_fwd": flash_attention.launches}

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
    prefill_ms, decode_ms = list(core.prefill_ms), list(core.decode_ms)
    n_prefill, n_decode = len(prefill_ms), len(decode_ms)
    want = {"flash_fwd": cfg.n_layers * n_prefill,
            "rms_norm": (2 * cfg.n_layers + 1) * (n_prefill + n_decode)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

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
    return {
        "requests": len(prompts), "steps": steps, "wall_s": wall,
        "generated_tokens": generated, "tokens_per_s": generated / wall,
        "prefill_ms": [(n_, round(ms, 3)) for n_, ms in prefill_ms],
        "decode_step_ms_p50": decode_p50,
        "decode_steps": n_decode, "launches": launches,
        "logits_max_abs_err": err,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }


def main() -> None:
    smi, peaks = card()
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"build: {build():.1f} s")

    rms_err = check_rms(dev)
    flash_err, lse_err = check_flash(dev)
    check_refusals(dev)

    rms_pre = time_rms(dev, peaks, S_MAIN)
    rms_dec = time_rms(dev, peaks, DECODE_ROWS)
    flash = time_flash(dev, peaks, S_MAIN)
    flash_4k = time_flash(dev, peaks, 4096)
    for what, t in (("rms_norm prefill", rms_pre),
                    ("rms_norm decode", rms_dec),
                    ("flash_fwd s=2048", flash),
                    ("flash_fwd s=4096", flash_4k)):
        log(f"time {what}: " + json.dumps(t))
    torch.cuda.empty_cache()

    served = serve(dev)
    log("serve: " + json.dumps(served))

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/attention.py:69",
         "launches": served["launches"]["flash_fwd"],
         "max_abs_err": flash_err, "lse_max_abs_err": lse_err,
         "tolerance": {"o": TOL["flash_o"], "lse": TOL["flash_lse"]},
         **flash, "kernel_ms": flash["ms"], "s4096": flash_4k},
        {"name": "rms_norm", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/rms_norm.cu",
         "replaces": "ray_tpu/ops/norms.py:34",
         "launches": served["launches"]["rms_norm"],
         "max_abs_err": rms_err,
         "tolerance": {"bf16": TOL["rms_bf16"], "f32": TOL["rms_f32"]},
         **rms_pre, "kernel_ms": rms_pre["ms"], "decode": rms_dec},
    ]
    print(smi)                  # name, power limit as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
