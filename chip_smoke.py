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
     backward kernels give the same bits; the paged decode kernel over
     PAGED_CASES (outputs, both caches after its K/V write, and the same
     bits from two launches);
     the flash autograd Function against autograd through
     `mha_reference`; a 2-layer model at the training width, its loss
     and grads in bf16 on the card against f32 on the CPU; a shape a
     kernel does not take must raise;
  4. time: each kernel, its plain version and one library call that
     computes the same function (a yardstick the port never calls),
     with CUDA events, beside the least time the card could take, at the
     serving and training shapes (the two backward kernels also as a
     pair against SDPA's backward; RMSNorm also with L2 flushed before
     each launch, since its 33.6 MB inputs fit in the card's L2);
  5. serve: llama3-8b at full width and depth (random weights from a
     seed) through the port's EngineCore, five requests, one submitted
     mid-flight; every serving kernel must have launched during this
     phase, and one prompt's prefill logits must agree with
     Transformer.apply; then LLMEngine, the serving deployment
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
  7. serve_llm: llama3-8b cut to its first SERVE_LLM_LAYERS layers (held
     to `serve()`'s schedule through EngineCore at that depth, made
     first) through `serve_llm`, the user's entry point:
     the weights `put` in the object store (each large tensor in its own
     shm segment), one `num_gpus=1` replica deployed by the Serve
     controller from that ObjectRef, the same five requests through
     `LLMHandle.generate` and their TokenStreams, which must give
     that EngineCore's tokens exactly, with the flash forward and
     RMSNorm launched in the replica; after `serve.shutdown()` the
     card's memory is back; then the same with the replica on a node
     agent's card: a head with no GPU, node agent A (a
     `ray_tpu_torch._private.node_agent` process owning the card's
     `GPU: 1`), the weights `put` on the head and relayed by the object
     plane into A's store when the replica, which must run on A's node,
     gets them (/dev/shm must hold both copies); the same tokens and
     launches, the relay's bytes and GB/s, TTFT and TPOT;
  8. train: the model of the repo's `bench.py` (~0.95 B params, bf16,
     seq 2048, batch 2) at full width and depth through
     `ray_tpu_torch.bench.train_step` (loss, backward, AdamW): 2 warm-up
     and 20 timed steps on a fixed batch (step time, and the host's
     time to enqueue a step), finite and falling loss, the launch counts
     of every kernel per step; then loss and backward under remat, full
     against save_attn (launch counts, bitwise equal loss and grads,
     each step's time);
  9. trainer: the same model, cut to its first TRAINER_LAYERS layers and
     held to the same steps in this process at that depth, and batch
     through `TorchTrainer`, the
     user's entry point to training: one `num_gpus=1` worker in a
     one-rank nccl group, batches from a `ray_tpu_torch.data` Dataset
     through `iter_torch_batches`, a checkpoint of the params and the
     AdamW state at step 3 (~2.0 GB at 4 layers, with a checksum of
     every tensor), the worker killed at step 5 and the group restarted
     from that checkpoint to step 7: step 0's loss equal to the
     reference's first, later losses within a stated tolerance of its
     same steps, every
     restored tensor equal to its checksum, 4 / 4 / 4 / 9 launches
     of the kernels a step in the worker; after `shutdown()` the card's
     memory is back;
 10. elastic: phase 9's cut model and batch through the elastic
     `TorchTrainer` (`ScalingConfig(elastic=ElasticConfig(...))`) across
     a node's death, one worker of `gpus_per_worker=1` (the bundle path
     that runs k ranks a worker of k cards): a head with no GPU, the
     worker on node agent A (a `ray_tpu_torch._private.node_agent`
     process owning the card's `GPU: 1`), world rank 0 of 1 and local
     rank 0 of 1, pinned to the card before its first CUDA call, a
     checkpoint at step 3, agent A SIGKILLed after step 5 (its worker
     gone and the card's memory back within a bound), then agent B,
     where the loop forms a new group whose worker (again rank 0 of 1,
     pinned before CUDA) restores the checkpoint through the object
     plane and trains to step 7: every loss on both nodes equal to
     phase 9's reference at the same step bit for bit, each step once
     in `metrics_history`, every
     restored tensor equal to its checksum, 4 / 4 / 4 / 9 launches a
     step on both nodes, the restore's broadcast to B complete and its route
     (TCP or mapped in place) printed; after `shutdown()` the card's
     memory is back;
 11. parallel: the parallel layer (`ray_tpu_torch.parallel`) on a
     one-rank nccl mesh: (a) the bench model with DTensor parameters
     placed by its logical axes, 5 AdamW steps whose losses are held to
     phase 8's and whose kernels run inside `local_map` (16 / 16 / 16 /
     33 launches a step); (b) the bench model's widths with Mixtral
     8x7B's routing (8 experts, top 2, ~4.83 B params): every expert set
     to the dense FFN gives the dense forward with nothing dropped, then
     6 AdamW steps in process, then the same 6 through `TorchTrainer`
     from one `num_gpus=1` worker with `ScalingConfig(mesh=MeshSpec())`,
     its losses held to the in-process ones. One card makes every mesh
     axis size 1: no multi-rank time is taken;
 12. pipeline: (a) a channel DAG of two `num_gpus=0.5` actors
     (`ActorMethod.bind`, `experimental_compile(enable_shm_channels=
     True)`): the first returns a bf16 CUDA tensor of the bench
     activation's shape, the channel lands it on the second's card, 20
     executions whose checksums must equal the first's bit for bit, with
     the channel's write and read time; (b) the bench model at full width
     and depth through `TorchTrainer(pipeline_stages=2)`: two stage
     workers with `GPU: 0.5` each, 8 layers a stage, the 1F1B schedule
     over shm channels, 2 microbatches, 5 steps of a per-stage AdamW:
     losses held to the same steps in one process and to phase 8's step
     0, exact launch counts a step read in each stage worker (32 / 16 /
     16 / 64 on stage 0, 16 / 16 / 16 / 34 on stage 1), the bubble
     fraction from the stage spans, each stage's peak memory; after
     `shutdown()` the card's memory is back;
 13. rl: `ray_tpu_torch.rllib` with CartPole-v1 written here in numpy
     (`CartPoleVec`, gymnasium's dynamics, seeding and autoreset; the
     chip machine has no gymnasium) and handed to the env runners as a
     callable: (a) a PPO learner on the card against one on the CPU,
     one update each on a toy batch and on a 64 × 32 CartPole batch,
     every metric and parameter within stated tolerances, TF32 off,
     the learner's state on the card; (b) the PPO CartPole gate of
     `tests/test_rllib.py` (PPOConfig defaults, seed 0, a mean return
     of 450 within 250 iterations) with the learner on the card, and
     its update timed on the card and on the CPU; (c) PPO through the
     runtime: two CPU runner actors and a learner actor holding
     `GPU: 1`, 20 iterations, the runners' weights equal to the
     learner's after every sync (checksums), a rising return, the
     card's memory back after `stop()`; (d) `ConvActorCriticModule` at
     its defaults (84 × 84 × 4 uint8, the Atari conv stack) through
     `PPOLearner(module=...)`: one update on the card against one on
     the CPU in float64, the float32 forward card against CPU, then its
     update ms and peak at T 64 × N 32; (e) `MultiAgentPPO`, two policies on two numpy
     CartPoles, both learners on the card, finite returns. No kernel
     of the port lies on this path (the JAX RL stack is plain XLA);
 14. rl algorithms: `ray_tpu_torch.rllib.algorithms`, `rllib.offline`
     and `rllib.sebulba` with the learners on the card, the envs numpy
     callables (`CartPoleVec`, and `PendulumVec`, Pendulum-v1 with
     gymnasium's dynamics, seeding and autoreset): (a) IMPALA, APPO,
     DQN (scalar, and C51 + dueling + noisy with fixed noise), SAC,
     DreamerV3, BC, MARWIL and CQL, one update each on the card against
     one on the CPU from the same weights, batch and draws, TF32 off
     (in float64 for the learners whose update switches on an argmax, a
     floor, a ReLU or a sampled one-hot, their float32 forward held to
     1e-5), the learners' state on the card; (b) the IMPALA CartPole
     gate of `tests/test_rllib.py` (4 runner actors × 8 envs, a mean
     return of 450 within 200 iterations, seeds 1 then 7) through the
     runtime, its update timed on the card and on a CPU learner; (c)
     Sebulba through the runtime, 4 env-runner actors against 2 numpy
     inference actors and then one inference actor whose forward runs
     on the card (`TorchPolicy`): every update counted, no shard gap,
     staleness within (rl_ring_depth + 2) × runners; (d) the DreamerV3
     gate of `tests/test_rllib.py` and a state round trip; (e) DQN
     (C51 + noisy) and SAC for fixed iterations: finite losses, targets
     moving, update ms; the card's memory back after every stop(). No
     kernel of the port lies on this path either;
 15. periphery: (a) the GPU accelerator manager counts the card (its
     count, `torch.cuda.device_count()` and the runtime's `GPU` total are
     1), `slice_bundles("<gen>-1")` is one bundle with `GPU: 1` and the
     head resource, and the dashboard's `/api/cluster` reports `GPU` 1;
     (b) the graft entry's forward (`ray_tpu_torch/graft_entry.py`, the
     flagship model: 8 layers, d_model 512, head_dim 64, bf16) in this
     process: its logits against the same forward in f32 on the CPU
     through the plain versions (a stated tolerance relative to
     max|logit|, and the share of rows whose argmax agrees), on its own
     zero tokens and on seeded random ones, two calls the same bits,
     exactly 8 flash forward and 17 RMSNorm launches a forward, both
     kernels timed at its shapes; (c) a remote driver: a separate
     process that connects with `init(address=...)` to this process's
     head (started with `bind_host`), imports no torch, and submits a
     `num_gpus=1` task that runs the same forward on the card: its
     checksum and launches equal (b)'s; (d) `TorchTrainer` with
     `ScalingConfig(topology="<gen>-1")`: one worker in the slice's
     STRICT_SPREAD placement group (the group's bundles, strategy and
     node, and the worker actor's group and bundle index, read from the
     head while it runs) runs the same forward with the same checksum
     and launches; (e) the card's memory back after
     `shutdown()`;
 7b. (after the agent phase) serve tp: llama3-8b cut to its first
     SERVE_LLM_LAYERS layers (phase 7's depth, held to its EngineCore
     tokens) from a replica sharded over two tensor-parallel ranks on
     the card (gloo, each rank its
     Megatron shard of the seed-0 weights and a cache of its kv heads):
     (a) this process as rank 0 and a `num_gpus=0.5` rank actor against
     one process, the 2,900-token prefill and 16 teacher-forced decode
     steps, max|Δ| over max|logit| within a stated limit, both ranks'
     launches counted; the flash forward at a rank's heads against its
     plain version; (b) `serve_llm(mesh={"dp": 1, "tp": 1})`, one
     `num_gpus=1` replica, `serve()`'s tokens exactly; (c)
     `serve_llm(mesh={"tp": 2})` with `num_gpus=0.5` a rank: `serve()`'s
     tokens but for printed near ties (steps whose one-process top-2
     margin is below (a)'s gap), each rank half of (b)'s cache at its
     page count, both ranks' launches; (d) the card's memory back;
 12b. (after the pipeline phase) tune: a `Tuner` over a `TorchTrainer`
     with one `GPU: 1` worker, the bench model cut to 4 layers, an lr
     grid of three under ASHA: a trial STOPPED, the best result the
     lowest last loss, every trial's first loss bit-equal to this
     process's, all four kernels launched in every trial's worker.
The last three lines are the card (`nvidia-smi`), the kernels as JSON,
and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
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
import tempfile
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
from ray_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                            paged_decode_attention_reference)
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
# paged decode timing: the chat cell's mean context (its 256 rows at
# ~1,064 positions, ROADMAP / PERF.md), and serve()'s 8 rows at 2,048
PAGED_CHAT_CONTEXT, PAGED_ROWS8_CONTEXT = 1064, 2048
# bench.py's training shape: batch, seq, heads (MHA), d_model
TRAIN_B, TRAIN_S, TRAIN_HEADS, TRAIN_D = 2, 2048, 16, 2048
TRAIN_STEPS, TRAIN_WARMUP = 20, 2
# the graft entry's norm rows (2 x 256 tokens) and d_model
GRAFT_ROWS, GRAFT_D = 512, 512
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
#  * the graft entry's logits (bf16 through 8 layers, head_dim 64)
#    against the same weights in f32 on the CPU: every activation is
#    rounded to bf16 (2^-8 relative) on the card only, ~20 tensors a
#    layer; 5e-2 of max|logit| (the CPU's bf16 forward of the port is
#    1.0e-2 from its f32 one), and the argmax of at least 90% of rows
#    must agree (the f32 top-2 margin is ~0.14, seven times the gap).
#  * paged decode O (bf16) against the plain version on the card: both
#    widen the same bf16 operands exactly and compute scores, softmax and
#    PV in f32 (sum order and exp2f against exp aside, ~1e-7 of the
#    outputs' scale), then round once to bf16: at most one bf16 ulp
#    apart, 2^-7 of the value; 1e-5 absolute for outputs near 0.
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
    "graft_logits_rel_to_max": 5e-2,
    "graft_argmax_share": 0.9,
    "paged_o": dict(rtol=2 ** -7, atol=1e-5),
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
    """x in bf16 and f32, w in f32 (llama3-8b serving, the graft entry at
    d 512, where the kernel runs a row a warp) and bf16 (the bench model
    trains with bf16 parameters)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, TOL["rms_bf16"]),
                       (torch.float32, TOL["rms_f32"])):
        for rows, d, wdt in ((DECODE_ROWS, D_MODEL, torch.float32),
                             (S_MAIN, D_MODEL, torch.float32),
                             (1000, D_MODEL, torch.float32),
                             (TRAIN_B * TRAIN_S, TRAIN_D, torch.bfloat16),
                             (GRAFT_ROWS, GRAFT_D, torch.float32)):
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
# (both masks, and at a tp=2 rank's heads) and training shapes, s 4096, ragged s 1000, sq != sk under
# each mask (top-left causal alignment), the graft entry's shape (head_dim
# 64, kv heads 4, causal); then the edges of the kernel's
# 64-row warpgroup tiles, 128-row blocks and 128-row K/V tiles, s 1 to 257
# with both masks and head dims, the GQA group cycling through 1, 4 and 8
FWD_EDGES = itertools.product(
    (1, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257), (64, 128),
    (True, False))
FWD_CASES = [(1, HEADS, KV_HEADS, S_MAIN, S_MAIN, HEAD_DIM, True),
             (1, HEADS, KV_HEADS, S_MAIN, S_MAIN, HEAD_DIM, False),
             (1, HEADS // 2, KV_HEADS // 2, S_MAIN, S_MAIN, HEAD_DIM, True),
             (TRAIN_B, TRAIN_HEADS, TRAIN_HEADS, TRAIN_S, TRAIN_S, 128, True),
             (1, HEADS, KV_HEADS, 4096, 4096, HEAD_DIM, True),
             (1, 8, 2, 1000, 1000, 128, True),
             (1, 8, 2, 1000, 1000, 128, False),
             (2, 8, 2, 100, 300, 128, True), (2, 8, 2, 100, 300, 128, False),
             (2, 8, 2, 300, 100, 64, True), (2, 8, 2, 300, 100, 64, False),
             (2, 8, 4, 256, 256, 64, True)] + [
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


def paged_refusals(dev) -> list:
    """(what, arguments) the paged decode kernel does not take: f32 q, a
    head_dim of 96, a strided q, page size 32, 16 q heads on one kv head,
    caches of another page size than asked for."""
    base = paged_inputs(4, 8, 2, 64, 8, 8, (1, 60), dev, 21, holes=False)
    odd = paged_inputs(4, 8, 2, 96, 8, 8, (1, 60), dev, 22, holes=False)
    wide = paged_inputs(4, 16, 1, 64, 8, 8, (1, 60), dev, 23, holes=False)
    big = paged_inputs(4, 8, 2, 64, 32, 8, (1, 60), dev, 24, holes=False)
    strided = torch.empty(4, 8, 128, device=dev,
                          dtype=torch.bfloat16)[..., ::2]
    return [("f32 q", dict(base, q=base["q"].float())),
            ("head_dim=96", odd),
            ("strided q", dict(base, q=strided)),
            ("page size 32", big),
            ("group 16", wide),
            ("page size 16 on a cache of 8", dict(base, page_size=16))]


def paged_resources() -> dict:
    """The paged decode attention kernel's ptxas resources at (group 4,
    head_dim 128, page 16), the chat cell's instance, with its dynamic
    shared memory and resident blocks an SM; `SPILL:` is logged for any
    instance that spills."""
    from ray_tpu_torch.ops.paged_decode import _kernel as paged_kernel
    lib = paged_kernel()[0]
    text = _build.library_path("paged_decode").with_suffix(".log").read_text()
    res = ptxas_resources(text)
    main_entry = None
    for entry, r in res.items():
        if r.get("spill_store_bytes", 0) or r.get("spill_load_bytes", 0):
            log(f"SPILL: paged_decode {entry}: {r}")
        if "rtt_paged_decode_attn" in entry and "ILi4ELi128ELi16E" in entry:
            main_entry = entry
    if main_entry is None:
        raise RuntimeError("ptxas reported no paged decode kernel at "
                           "(4, 128, 16)")
    ptr = ctypes.POINTER(ctypes.c_int)
    lib.rtt_paged_decode_occupancy.argtypes = [ptr, ptr]
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.rtt_paged_decode_occupancy(
        ctypes.byref(smem), ctypes.byref(blocks)), "occupancy")
    r = res[main_entry]
    out = {"registers": r["registers"],
           "smem_bytes": r["smem_static_bytes"] + smem.value,
           "spill_bytes": r["spill_store_bytes"] + r["spill_load_bytes"],
           "blocks_per_sm": blocks.value,
           "ptxas": {e: v for e, v in res.items() if "paged_decode" in e}}
    log(f"  paged_decode (4, 128, 16): registers {out['registers']}, smem "
        f"{out['smem_bytes']}, blocks/SM {out['blocks_per_sm']}, spills "
        f"{out['spill_bytes']}")
    return out


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
    cases += [(f"paged decode {what}", functools.partial(
        paged_decode_attention, **args)) for what, args in paged_refusals(dev)]
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


def time_launches(fn, iters: int, before=None) -> float:
    """Device ms of one call, the mean over `iters` calls each between
    its own pair of CUDA events, all queued behind a sleep kernel; with
    `before`, that runs ahead of each call's first event (outside the
    timed span)."""
    fn()
    if before is not None:
        before()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(1 << 26)
    for start, end in events:
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
    events[-1][1].synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def l2_flush_buffer(dev) -> torch.Tensor:
    """A buffer twice the card's L2 (at least 128 MiB): writing all of it
    evicts whatever a kernel's inputs left there."""
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 0)
    return torch.empty(max(2 * l2, 128 << 20) // 4, dtype=torch.int32,
                       device=dev)


def time_rms(dev, peaks, rows: int, d: int = D_MODEL,
             wdt: torch.dtype = torch.float32) -> dict:
    """The kernel on bf16 x (rows, d) with a w of dtype `wdt`, against the
    plain version and F.rms_norm on the same x. `ms` is taken with x
    warm in L2 when it fits (33.6 MB at the prefill and training shapes,
    in a 50 MB L2); `flushed_ms` overwrites a buffer twice L2 before
    each launch, so x comes from HBM, `read_flushed_ms` reads that
    buffer instead (L2 then holds no dirty lines to write back during
    the launch), and `single_ms` times the same launches, one between
    each pair of events, without a flush."""
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
    flush = l2_flush_buffer(dev)
    out["flush_bytes"] = flush.numel() * 4
    out["flushed_ms"] = time_launches(lambda: rms_norm(x, w, EPS), iters,
                                      before=flush.zero_)
    total = torch.empty((), dtype=torch.int64, device=dev)
    out["read_flushed_ms"] = time_launches(
        lambda: rms_norm(x, w, EPS), iters,
        before=lambda: torch.sum(flush, 0, dtype=torch.int64, out=total))
    out["single_ms"] = time_launches(lambda: rms_norm(x, w, EPS), iters)
    out["flushed_bound_share"] = out["bound_ms"] / out["flushed_ms"]
    out["read_flushed_bound_share"] = out["bound_ms"] / out["read_flushed_ms"]
    del flush, total
    out["shape"] = f"x ({rows}, {d}) bf16, w {str(wdt).split('.')[-1]}"
    return out


def time_flash(dev, peaks, b: int, h: int, kvh: int, s: int,
               d: int = HEAD_DIM) -> dict:
    """The forward kernel, causal, head_dim `d`, against the plain version
    and SDPA on the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = fwd_inputs(b, h, kvh, s, s, d, dev, gen)
    out = time_three(lambda: flash_attention(q, k, v, causal=True),
                     lambda: flash_attention_reference(q, k, v, True),
                     lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=kvh != h),
                     20, 5)
    # causal: the lower triangle's s(s+1)/2 pairs, QK^T and PV, 2 FLOP
    # per multiply-add, for every q head
    ops = 2 * 2 * d * b * h * s * (s + 1) / 2
    nbytes = b * (2 * h + 2 * kvh) * s * d * 2 + b * h * s * 4
    out["bound_ms"], out["bound_by"] = bound(nbytes, ops, peaks[1], peaks)
    out["tflops"] = ops / out["ms"] / 1e9
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["shape"] = (f"q ({b}, {h}, {s}, {d}), k/v ({b}, {kvh}, {s}, "
                    f"{d}) bf16, causal")
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


# (rows, q heads, kv heads, head_dim, page size, table pages, contexts) of
# the paged decode checks: the chat cell's shape (Mistral-7B's heads, 256
# rows, contexts 16-4,096 over 256-page tables), llama3-8b's 8-row decode
# steps in serve() (512-page tables: the chunked path), a tp=2 rank's
# heads, head_dim 64 at page 8 (the card tests' engine), and the GQA
# groups 1, 2, 3 and 8; contexts are drawn from the range given, with a
# row at position 0 (only the new token is seen) in every case
PAGED_CASES = [
    (256, HEADS, KV_HEADS, HEAD_DIM, 16, 256, (16, 4096)),
    (DECODE_ROWS, HEADS, KV_HEADS, HEAD_DIM, 16, 512, (1, 3000)),
    (DECODE_ROWS, HEADS // 2, KV_HEADS // 2, HEAD_DIM, 16, 512, (1, 3000)),
    (8, 4, 2, 64, 8, 64, (1, 512)),
    (6, 8, 8, 128, 8, 40, (1, 320)),
    (6, 8, 4, 64, 16, 40, (1, 640)),
    (5, 12, 4, 128, 16, 20, (1, 320)),
    (5, 16, 2, 64, 8, 48, (1, 384)),
]


def paged_inputs(rows, heads, kvh, hd, ps, max_pages, contexts, dev,
                 seed: int, holes: bool = True) -> dict:
    """Arguments of `paged_decode_attention` for one layer: a pool of
    random bf16 pages, each active row's pages drawn without replacement
    (a shuffled pool) for a context drawn from `contexts` (its position
    the context's last), the rest of its table -1. With `holes`: the
    last row is inactive, one row has an unassigned page in the middle of
    its context, one its own page unassigned (it writes nothing), and one
    sits at position 0. Tables from a CPU generator, values from one on
    `dev`, both seeded with `seed`."""
    tables = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = contexts
    ctx = torch.randint(lo, hi + 1, (rows,), generator=tables)
    ctx = ctx.clamp(max=max_pages * ps)
    need = (ctx + ps - 1) // ps
    num_pages = int(need.sum()) + 4
    perm = torch.randperm(num_pages, generator=tables)
    pt = torch.full((rows, max_pages), -1, dtype=torch.int32)
    at = 0
    for r in range(rows):
        pt[r, :need[r]] = perm[at:at + need[r]].to(torch.int32)
        at += int(need[r])
    active = torch.ones(rows, dtype=torch.bool)
    if holes and rows >= 4:
        active[-1] = False
        if need[0] >= 3:
            pt[0, need[0] // 2] = -1                     # a hole
        if need[1] >= 2:
            pt[1, need[1] - 1] = -1                      # own page unassigned
        ctx[2], pt[2, 1:] = 1, -1                        # position 0
    shape = (num_pages, ps, kvh, hd)
    bf = torch.bfloat16
    return {"q": torch.randn(rows, heads, hd, generator=gen, device=dev
                             ).to(bf),
            "k_cache": torch.randn(shape, generator=gen, device=dev).to(bf),
            "v_cache": torch.randn(shape, generator=gen, device=dev).to(bf),
            "k": torch.randn(rows, kvh, hd, generator=gen, device=dev).to(bf),
            "v": torch.randn(rows, kvh, hd, generator=gen, device=dev).to(bf),
            "page_tables": pt.to(dev), "positions": (ctx - 1).to(torch.int32
                                                              ).to(dev),
            "active": active.to(dev), "page_size": ps,
            "scale": hd ** -0.5}


def run_paged(fn, args: dict) -> tuple:
    """(output, k cache, v cache) of `fn` on a copy of the caches."""
    a = dict(args, k_cache=args["k_cache"].clone(),
             v_cache=args["v_cache"].clone())
    out = fn(**a)
    return out, a["k_cache"], a["v_cache"]


def check_paged_decode(dev) -> float:
    """The kernel against the plain version over PAGED_CASES: active rows'
    outputs within TOL["paged_o"], a row at position 0 equal to its new
    v, both caches bit-equal after the write (inactive rows and rows
    whose page is unassigned write nothing), and two launches giving the
    same bits."""
    worst = 0.0
    for i, case in enumerate(PAGED_CASES):
        rows, heads, kvh, hd, ps, max_pages, contexts = case
        args = paged_inputs(rows, heads, kvh, hd, ps, max_pages, contexts,
                            dev, 11 + i)
        before = paged_decode_attention.launches
        got, gk, gv = run_paged(paged_decode_attention, args)
        again, _, _ = run_paged(paged_decode_attention, args)
        if paged_decode_attention.launches != before + 2:
            raise AssertionError(f"paged decode {case} did not launch")
        want, wk, wv = run_paged(paged_decode_attention_reference, args)
        torch.cuda.synchronize()
        act = args["active"]
        err = compare(got[act], want[act], TOL["paged_o"],
                      f"paged decode {case}")
        if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
            raise AssertionError(f"paged decode {case}: the caches differ "
                                 f"from the plain version's after the write")
        if not torch.equal(got, again):
            raise AssertionError(f"paged decode {case}: two launches differ")
        zero = (args["positions"] == 0) & act
        if zero.any():
            g = heads // kvh
            v0 = args["v"].repeat_interleave(g, dim=1)
            if not torch.equal(got[zero], v0[zero]):
                raise AssertionError(f"paged decode {case}: a row at "
                                     f"position 0 is not its new v")
        log(f"check paged_decode rows={rows} h={heads}/{kvh} d={hd} "
            f"page={ps} pages={max_pages} contexts={contexts}: max_abs_err "
            f"{err:.3e}")
        worst = max(worst, err)
        del args, got, gk, gv, again, want, wk, wv
    return worst


def time_paged_decode(dev, peaks, rows: int, heads: int, kvh: int,
                      context: int, max_pages: int, hd: int = HEAD_DIM,
                      ps: int = 16) -> dict:
    """The kernel and its plain version with every one of `rows` rows at
    `context` positions (the new token's included) in tables of
    `max_pages` pages. No single PyTorch call computes paged attention,
    so there is no library yardstick. Bound: each row's K and V read,
    its new k / v written, q read and O written (bf16), against the f32
    FLOPs of QK and PV at 67 TF/s."""
    args = paged_inputs(rows, heads, kvh, hd, ps, max_pages,
                        (context, context), dev, 13, holes=False)
    out = dict(zip(("ms", "call_ms"), time_ms(
        lambda: paged_decode_attention(**args), 50)))
    # the plain version syncs the host on its write rows (torch.nonzero),
    # so it cannot be queued behind a sleep: each call between its own
    # events (the card idles while the host waits, as on its main path)
    plain = functools.partial(paged_decode_attention_reference, **args)
    out["plain_ms"] = time_launches(plain, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        plain()
    torch.cuda.synchronize()
    out["plain_call_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    out["library_ms"] = None
    nbytes = 2 * (2 * rows * context * kvh * hd) + 2 * (
        2 * rows * kvh * hd) + 2 * (2 * rows * heads * hd)
    ops = 4 * rows * heads * hd * context
    out["bound_ms"], out["bound_by"] = bound(nbytes, ops, peaks[2], peaks)
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["gb_s"] = nbytes / out["ms"] / 1e6
    out["shape"] = (f"{rows} rows x {context} positions, q {heads} / kv "
                    f"{kvh} heads, head_dim {hd}, page {ps}, tables of "
                    f"{max_pages} pages, bf16")
    del args
    return out


def kernel_counts() -> dict:
    return {"flash_fwd": flash_attention.launches,
            "flash_dkdv": flash_attention.dkdv_launches,
            "flash_dq": flash_attention.dq_launches,
            "rms_norm": rms_norm.launches,
            "paged_decode": paged_decode_attention.launches}


def reset_counts() -> None:
    rms_norm.launches = flash_attention.launches = 0
    flash_attention.dkdv_launches = flash_attention.dq_launches = 0
    paged_decode_attention.launches = 0


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
            "rms_norm": (2 * cfg.n_layers + 1) * (n_prefill + n_decode),
            "paged_decode": cfg.n_layers * n_decode}
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


# Earlier paths cut in depth to keep the script inside its time limit:
# the serve_llm, agent and tp phases serve llama3-8b's first
# SERVE_LLM_LAYERS layers (the weights put and relayed, and the tp ranks'
# all-reduces a step, shrink with them), the trainer and
# elastic phases train the bench model's first TRAINER_LAYERS (their
# checkpoints shrink with them); each is held to the same calls in this
# process at the same depth
SERVE_LLM_LAYERS, TRAINER_LAYERS = 8, 4


def serve_tokens(dev, cfg) -> dict:
    """`serve()`'s schedule through EngineCore on `cfg` (seed-0 weights),
    checked as `serve()` checks it: the tokens by request id."""
    core = TimedCore(cfg, init_for_serving(Transformer(cfg), 0, dev),
                     device=dev, num_pages=1024, page_size=16,
                     max_batch=DECODE_ROWS)
    lens, new_tokens, prompts = serve_requests(cfg)
    tokens, done, _, _, launches = run_schedule(core, prompts, lens,
                                                new_tokens)
    check_schedule(cfg, core, prompts, new_tokens, tokens, done, launches)
    del core
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens": tokens, "layers": cfg.n_layers}


def train_reference(dev, cfg, steps: int) -> dict:
    """`train()`'s losses and step p50 on `cfg`: `steps` steps of
    `bench.train_step` on `train()`'s batch from seed 0, in this
    process."""
    model = Transformer(cfg)
    params = model.init(0, device=dev)
    opt = bench.make_optimizer(params)
    batch = bench.make_batch(cfg, TRAIN_B, TRAIN_S, dev)
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(bench.train_step(model, params, opt, batch).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del model, params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms_p50": statistics.median(step_ms[1:]),
            "layers": cfg.n_layers}


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
                or launches["rms_norm"] // per_pass <= admitted
                or launches["paged_decode"] != cfg.n_layers * (
                    launches["rms_norm"] // per_pass - admitted)):
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
                 "flash_dq": cfg.n_layers, "rms_norm": 4 * cfg.n_layers + 1,
                 "paged_decode": 0},
        "save_attn": {"flash_fwd": cfg.n_layers, "flash_dkdv": cfg.n_layers,
                      "flash_dq": cfg.n_layers,
                      "rms_norm": 4 * cfg.n_layers + 1, "paged_decode": 0}}
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
                "flash_dq": cfg.n_layers, "rms_norm": 2 * cfg.n_layers + 1,
                "paged_decode": 0}
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
        "peak_mem_gib": peak_gib,
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
    checkpoint at step 3 (params and AdamW state, 5.7 GB at full depth),
    the worker killed at step 5, and a restart from that checkpoint to
    step 7.
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
                    "flash_dq": cfg.n_layers,
                    "rms_norm": 2 * cfg.n_layers + 1, "paged_decode": 0}
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


# The elastic phase: steps of the run, the step whose checkpoint is
# reported, the step after whose report agent A is killed, and the bounds
# (s) for A's worker to be gone with the card's memory back, and for an
# agent to register
ELASTIC_STEPS, ELASTIC_CKPT_STEP, ELASTIC_KILL_STEP = 8, 3, 5
ELASTIC_GONE_S, ELASTIC_AGENT_S = 30.0, 60.0


def elastic_loop(config):
    """The elastic phase's `train_loop_per_worker` (pickled by value from
    the driver's `__main__`): the worker imports `chip_smoke` from the
    repo root on its PYTHONPATH and runs `elastic_worker` there."""
    import chip_smoke
    chip_smoke.elastic_worker(config)


def elastic_worker(config: dict) -> None:
    """In the elastic train worker, on an agent's node: the bench model
    from seed 0 (or restored from `get_checkpoint()`, every tensor held
    to the checksum saved with it), then a step a batch from
    `iter_torch_batches`, as `trainer_worker`; each step's node, loss,
    time and launches also go to the log file `config["log"]`, replayed
    steps included. A checkpoint at `ckpt_at`; in the first group, once
    the report of `kill_at` has returned, the worker writes its pid to
    `config["at_kill"]` and waits for its node to be killed."""
    import torch.distributed as dist

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models.config import TransformerConfig
    from ray_tpu_torch.train import Checkpoint
    loop_start = time.time()
    node = os.environ.get("RAY_TPU_NODE_ID")
    dev = torch.device(config["device"])
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = TransformerConfig(**config["cfg"])
    model = Transformer(cfg)
    params = model.init(0, device=dev)
    opt = bench.make_optimizer(params)
    ctx = rt_train.get_context()
    first = {"loop_start": loop_start, "pid": os.getpid(), "node": node,
             "ranks": [ctx.get_world_rank(), ctx.get_world_size(),
                       ctx.get_local_rank(), ctx.get_local_world_size()],
             "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
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
    batches = iter(rt_train.get_dataset_shard("train").iter_torch_batches(
        batch_size=config["batch"], device=dev))
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
                   "t": time.time(), "node": node,
                   "launches": {k: counts[k] - before[k] for k in counts},
                   **first}
        before, first = counts, {}
        with open(config["log"], "a") as f:
            f.write(json.dumps(metrics) + "\n")
        ckpt = None
        if step == config["ckpt_at"] and restored is None:
            sums = train_state_checksums(params, opt)
            ckpt = Checkpoint.from_state(
                rt_train.make_temp_checkpoint_dir(),
                {"params": params, "opt": opt.state_dict(), "step": step,
                 "checksums": sums})
            metrics["checksums"] = len(sums)
        if step == config["steps"] - 1:
            metrics["peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30 if on_card else 0.0)
        rt_train.report(metrics, ckpt)
        if step == config["kill_at"] and restored is None:
            # the driver holds this step's report: its node dies now
            with open(config["at_kill"] + ".tmp", "w") as f:
                f.write(str(os.getpid()))
            os.replace(config["at_kill"] + ".tmp", config["at_kill"])
            time.sleep(300)
            raise RuntimeError("the worker's node was not killed")


def pid_alive(pid: int) -> bool:
    """Whether process `pid` still runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def wait_until(pred, timeout: float, what: str, poll: float = 0.05) -> float:
    """Poll `pred` until it holds; the wall clock when it did. Raises
    after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout:.0f} s")
        time.sleep(poll)
    return time.time()


def start_agent(rt, num_gpus: int, resources=None) -> tuple:
    """A node agent (`python -m ray_tpu_torch._private.node_agent`) with
    `num_gpus` of GPU: the agent and its start (s, to registered)."""
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    t0 = time.time()
    agent = NodeAgentProcess(num_cpus=2, num_gpus=num_gpus,
                             resources=resources)

    def registered():
        node = rt.cluster.get_node(agent.node_id)
        return node is not None and node.alive
    try:
        at = wait_until(registered, ELASTIC_AGENT_S,
                        f"agent {agent.node_id} registered")
    except BaseException:
        agent.kill()
        raise
    return agent, at - t0


def pin_probe() -> dict:
    """In a train worker before its backend joins the process group (its
    first CUDA call on the card): the card it is pinned to and whether
    CUDA is already bound in it."""
    from ray_tpu_torch._private.accelerators import gpu
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "bound_before": gpu.cuda_bound(), "pid": os.getpid(),
            "node": os.environ.get("RAY_TPU_NODE_ID")}


def elastic_phase(trained: dict, dev, cfg=None, batch: int = TRAIN_B,
                  seq: int = TRAIN_S) -> dict:
    """The bench model trained through the elastic `TorchTrainer`
    (`ScalingConfig(elastic=ElasticConfig(...))`) across a node's death:
    the head owns no GPU, agent A (a node agent process with the card's
    `GPU: 1`) hosts the worker, which checkpoints at step 3; after step
    5's report agent A is SIGKILLed, its worker must be gone and the
    card's memory back within ELASTIC_GONE_S, then agent B starts and
    the elastic loop forms a new group there, whose worker restores from
    the checkpoint (through the object plane to B's store) and trains
    to step 7. Every step's loss, on A and on B, replayed ones included,
    must equal `train()`'s at the same step bit for bit, every restored
    tensor its checksum, each step must launch each kernel as a
    `train()` step does, `metrics_history` must hold each step once, and
    after `shutdown()` the card's memory is back within 1 GiB. `dev` is
    the card; the CPU only rehearses (gloo, agents with no GPU). The
    worker takes `gpus_per_worker=1`, the elastic bundle path of k ranks
    a worker at k = 1: in each group it must be world rank 0 of 1, local
    rank 0 of 1, pinned to the card before the backend's first CUDA call
    (read by `pin_probe` ahead of `TorchBackend.on_start`)."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import data as rt_data
    from ray_tpu_torch._private.accelerators.gpu import card_names
    from ray_tpu_torch._private.object_transfer import OBJECT_PLANE_STATS
    from ray_tpu_torch.train import (CheckpointConfig, CheckpointManager,
                                     ElasticConfig, RunConfig, ScalingConfig,
                                     TorchConfig, TorchTrainer)
    from ray_tpu_torch.train import backend as backend_mod
    from ray_tpu_torch.train import elastic as elastic_mod
    on_card = dev.type == "cuda"
    cfg = cfg or bench.bench_config()
    tokens = bench.make_batch(cfg, batch, seq, "cpu")["tokens"].numpy()
    ds = rt_data.from_numpy({"tokens": np.tile(tokens, (ELASTIC_STEPS, 1))})
    storage = tempfile.mkdtemp(prefix="rtt_elastic_phase_")
    config = {"cfg": dataclasses.asdict(cfg), "batch": batch,
              "steps": ELASTIC_STEPS, "ckpt_at": ELASTIC_CKPT_STEP,
              "kill_at": ELASTIC_KILL_STEP,
              "at_kill": os.path.join(storage, "at_kill"),
              "log": os.path.join(storage, "steps.jsonl"),
              "device": "cuda" if on_card else "cpu"}
    # on the CPU no GPU keeps the worker off the head: a resource does
    gpus, only_agents = (1, None) if on_card else (0, {"agent": 1.0})
    marks: dict = {"capacity": [], "pack": [], "bcast": [], "register": [],
                   "pins": []}
    # the runtime's pin; in the loop, after the backend: the same card,
    # or none in the CPU rehearsal (TorchConfig(platform="cpu") hides it)
    want_pin = card_names(1)[0] if on_card else None
    loop_pin = want_pin if on_card else ""
    originals = {}

    def timed(owner, name, key, size=None):
        """Wrap `owner.name` for the phase: each call's wall clock, and
        `size(out, args)` (else its result), the head's bytes served
        over the object plane during it."""
        fn = getattr(owner, name)
        originals[owner, name] = fn

        def wrapper(*args, **kwargs):
            t0, served = time.time(), OBJECT_PLANE_STATS["serve_bytes"]
            out = fn(*args, **kwargs)
            marks[key].append({
                "t0": t0, "t1": time.time(),
                "out": size(out, args) if size else out,
                "served": OBJECT_PLANE_STATS["serve_bytes"] - served})
            return out
        setattr(owner, name, wrapper)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    phase_at = time.time()
    rt = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    agents, watch = [], {}
    try:
        if ray_tpu_torch.cluster_resources().get("GPU", 0) != 0:
            raise AssertionError("the head node holds a GPU")
        agent_a, watch["a_start_s"] = start_agent(rt, gpus, only_agents)
        agents.append(agent_a)
        if on_card and ray_tpu_torch.cluster_resources().get("GPU") != 1:
            raise AssertionError(f"GPU {ray_tpu_torch.cluster_resources()} "
                                 f"after agent A joined, expected 1")

        def kill_a_then_start_b():
            try:
                wait_until(lambda: os.path.exists(config["at_kill"]), 900,
                           "the worker reached its kill step", poll=0.2)
                with open(config["at_kill"]) as f:
                    pid = int(f.read())
                watch["kill_at"] = time.time()
                agent_a.kill()           # SIGKILL: an unannounced death
                watch["dead_at"] = wait_until(
                    lambda: not rt.cluster.get_node(agent_a.node_id).alive,
                    ELASTIC_GONE_S, "the head marked agent A dead")
                watch["worker_gone_at"] = wait_until(
                    lambda: not pid_alive(pid), ELASTIC_GONE_S,
                    "agent A's worker gone")
                watch["memory_back_at"] = wait_until(
                    lambda: torch.cuda.mem_get_info()[0] >= free0 - 2 ** 30,
                    ELASTIC_GONE_S, "the card's memory back from A's worker")
                watch["b_started_at"] = time.time()
                agent_b, watch["b_start_s"] = start_agent(rt, gpus,
                                                          only_agents)
                agents.append(agent_b)
            except BaseException as e:   # raised again after fit()
                watch["error"] = e
        killer = threading.Thread(target=kill_a_then_start_b, daemon=True)
        killer.start()
        timed(elastic_mod._ElasticRun, "_await_capacity", "capacity")
        timed(elastic_mod, "pack_dir", "pack", lambda out, a: len(out))
        timed(ray_tpu_torch, "broadcast", "bcast")
        timed(CheckpointManager, "register_bytes", "register",
              lambda out, a: len(a[1]))
        on_start = backend_mod.TorchBackend.on_start
        originals[backend_mod.TorchBackend, "on_start"] = on_start

        def probed_on_start(backend, group, backend_config):
            marks["pins"].append({"ranks": group.world_size,
                                  "bundles": group.num_workers,
                                  "probe": group.run_on_all(pin_probe)})
            return on_start(backend, group, backend_config)
        backend_mod.TorchBackend.on_start = probed_on_start
        plane0 = dict(OBJECT_PLANE_STATS)
        fit_at = time.time()
        result = TorchTrainer(
            elastic_loop, train_loop_config=config,
            scaling_config=ScalingConfig(
                num_workers=1, use_gpu=on_card,
                gpus_per_worker=1 if on_card else 0,
                resources_per_worker=(None if on_card
                                      else {"CPU": 1.0, **only_agents}),
                elastic=ElasticConfig(min_workers=1, max_workers=1,
                                      checkpoint_every_n_steps=0)),
            run_config=RunConfig(
                name="elastic_phase", storage_path=storage,
                checkpoint_config=CheckpointConfig(num_to_keep=1)),
            backend_config=TorchConfig(
                distributed=True, platform=None if on_card else "cpu"),
            datasets={"train": ds}).fit()
        fit_s = time.time() - fit_at
        plane = {k: OBJECT_PLANE_STATS[k] - plane0[k] for k in plane0}
        nodes_plane = rt.state_op("object_plane_stats")["nodes"]
        liveness = dict(rt.cluster.liveness_counters)
        killer.join(timeout=ELASTIC_AGENT_S)
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)
        ray_tpu_torch.shutdown()
        for agent in agents:
            agent.terminate()
        for agent in agents:
            agent.wait(30)
    deadline = time.monotonic() + 60
    while (torch.cuda.mem_get_info()[0] < free0 - 2 ** 30
           and time.monotonic() < deadline):
        time.sleep(0.5)
    not_back = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 30
    phase_s = time.time() - phase_at
    try:
        if "error" in watch:
            raise watch["error"]
        if result.error is not None:
            raise AssertionError(f"elastic TorchTrainer failed: "
                                 f"{result.error!r}")
        if len(agents) != 2 or liveness["deaths"] != 1:
            raise AssertionError(f"agents {[a.node_id for a in agents]}, "
                                 f"liveness {liveness}, watch {watch}: "
                                 f"expected one death, agent A's, and "
                                 f"agent B after it")
        with open(config["log"]) as f:
            log_rows = [json.loads(line) for line in f]
        hist = result.metrics_history
        steps = [m["step"] for m in hist]
        if steps != list(range(ELASTIC_STEPS)):
            raise AssertionError(f"elastic steps {steps}, expected each of "
                                 f"0..{ELASTIC_STEPS - 1} once")
        node_a, node_b = agents[0].node_id, agents[1].node_id
        on_a = [r for r in log_rows if r["node"] == node_a]
        on_b = [r for r in log_rows if r["node"] == node_b]
        if ([r["step"] for r in on_a] != list(range(ELASTIC_KILL_STEP + 1))
                or [r["step"] for r in on_b] != list(
                    range(ELASTIC_CKPT_STEP + 1, ELASTIC_STEPS))
                or len(on_a) + len(on_b) != len(log_rows)):
            raise AssertionError(
                f"steps by node {[(r['node'], r['step']) for r in log_rows]}"
                f"; agent A {node_a}, agent B {node_b}")
        for r in log_rows + hist:
            if r["loss"] != trained["losses"][r["step"]]:
                raise AssertionError(
                    f"step {r['step']} on {r['node']}: loss {r['loss']!r}, "
                    f"train()'s {trained['losses'][r['step']]!r}")
        per_step = {"flash_fwd": cfg.n_layers, "flash_dkdv": cfg.n_layers,
                    "flash_dq": cfg.n_layers,
                    "rms_norm": 2 * cfg.n_layers + 1, "paged_decode": 0}
        for r in log_rows:
            if r["launches"] != per_step:
                raise AssertionError(f"step {r['step']} on {r['node']} "
                                     f"launched {r['launches']}, expected "
                                     f"{per_step}")
        # each group: one bundle of one rank, pinned before CUDA
        pins = [{"ranks": m["ranks"], "bundles": m["bundles"],
                 "visible": [p["visible"] for p in m["probe"]],
                 "bound_before": [p["bound_before"] for p in m["probe"]],
                 "node": [p["node"] for p in m["probe"]]}
                for m in marks["pins"]]
        seen = [{"node": r["node"], "ranks": r["ranks"],
                 "visible": r["visible"]} for r in (on_a[0], on_b[0])]
        if (pins != [{"ranks": 1, "bundles": 1, "visible": [want_pin],
                      "bound_before": [False], "node": [n]}
                     for n in (node_a, node_b)]
                or seen != [{"node": n, "ranks": [0, 1, 0, 1],
                             "visible": loop_pin}
                            for n in (node_a, node_b)]):
            raise AssertionError(f"elastic groups' ranks and pins "
                                 f"{pins}, in the loop {seen}: expected "
                                 f"rank 0 of 1, local 0 of 1, pinned to "
                                 f"{want_pin!r} before CUDA on A, then B")
        if on_b[0].get("checksums_equal") != hist[
                ELASTIC_CKPT_STEP]["checksums"]:
            raise AssertionError("the restore on B did not check every "
                                 "tensor against its checksum")
        el = result.artifacts["elastic"]
        bcast = el["restore_broadcast"]
        if (el["reshapes"] != 1 or el["restores"] != 1
                or len(marks["bcast"]) != 1 or bcast is None
                or bcast["failed"] or bcast.get("timed_out")
                or bcast["completed"] != bcast["nodes"]
                or bcast["nodes"] < 1):
            raise AssertionError(f"elastic artifacts {el}: the restore's "
                                 f"broadcast to B did not complete")
        if not_back > 1.0:
            raise AssertionError(f"{not_back:.2f} GiB of the card not back "
                                 f"after shutdown")
        if len(marks["register"]) != 1 or len(marks["pack"]) != 1:
            raise AssertionError(f"checkpoints registered "
                                 f"{marks['register']}, packed "
                                 f"{marks['pack']}")
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    pack, bc = marks["pack"][0], marks["bcast"][0]
    waited = marks["capacity"][1]
    nbytes = pack["out"]
    kill_at = watch["kill_at"]
    served = bc["served"]
    out = {
        "phase_s": phase_s, "fit_s": fit_s,
        "agent_a_start_s": watch["a_start_s"],
        "agent_b_start_s": watch["b_start_s"],
        "node_a": node_a, "node_b": node_b,
        "kill_to_dead_s": watch["dead_at"] - kill_at,
        "kill_to_worker_gone_s": watch["worker_gone_at"] - kill_at,
        "kill_to_memory_back_s": watch["memory_back_at"] - kill_at,
        "kill_to_b_started_s": watch["b_started_at"] - kill_at,
        "capacity_wait_s": waited["t1"] - waited["t0"],
        # the loop's capacity to its restore: placement, the worker's
        # spawn and imports, the nccl group's rendezvous on B
        "group_start_on_b_s": pack["t0"] - waited["t1"],
        "checkpoint_bytes": marks["register"][0]["out"],
        "checkpoint_register_s": (marks["register"][0]["t1"]
                                  - marks["register"][0]["t0"]),
        "restore": {
            "bytes": nbytes, "pack_s": pack["t1"] - pack["t0"],
            "put_s": bc["t0"] - pack["t1"],
            "broadcast_s": bc["t1"] - bc["t0"],
            "broadcast_gb_per_s": nbytes / (bc["t1"] - bc["t0"]) / 1e9,
            "broadcast": bc["out"],
            # the broadcast's end to the worker's loop on B: its get of
            # the ref from B's store, the untar, the session's start
            "fetch_unpack_s": on_b[0]["loop_start"] - bc["t1"],
            "load_s": on_b[0]["load_s"], "restore_s": on_b[0]["restore_s"],
            "checksums_equal": on_b[0]["checksums_equal"]},
        # how the restore's bytes reached B: over TCP when the head
        # served them during the broadcast (its OBJECT_PLANE_STATS),
        # else mapped in place
        "restore_route": "tcp" if served >= nbytes else "mapped in place",
        "head_object_plane": plane, "liveness": liveness,
        "nodes_object_plane": nodes_plane,
        "death_to_first_step_on_b_s": on_b[0]["t"] - kill_at,
        "losses": [m["loss"] for m in hist], "steps": steps,
        "step_ms_p50_on_a": statistics.median(
            r["step_ms"] for r in on_a[1:]),
        "step_ms_p50_on_b": statistics.median(
            r["step_ms"] for r in on_b[1:]),
        "train_step_ms_p50": trained["step_ms_p50"],
        "worker_peak_mem_gib": hist[-1]["peak_mem_gib"],
        "not_returned_gib": not_back,
        "launches_per_step": per_step,
        "launches": {k: sum(r["launches"][k] for r in log_rows)
                     for k in per_step},
        "pins": pins, "ranks_seen": seen,
        "elastic": {k: v for k, v in el.items() if k != "restore_broadcast"},
    }
    log(f"elastic: agent A start {out['agent_a_start_s']:.2f} s, agent B "
        f"start {out['agent_b_start_s']:.2f} s; kill to A dead "
        f"{out['kill_to_dead_s']:.2f} s, to its worker gone "
        f"{out['kill_to_worker_gone_s']:.2f} s, to the card's memory back "
        f"{out['kill_to_memory_back_s']:.2f} s")
    log(f"elastic: capacity wait {out['capacity_wait_s']:.2f} s, group "
        f"start on B {out['group_start_on_b_s']:.2f} s; death to the first "
        f"step on B {out['death_to_first_step_on_b_s']:.2f} s")
    log("elastic: restore " + json.dumps(out["restore"]))
    log(f"elastic: restore route {out['restore_route']} (head served "
        f"{served} of {nbytes} bytes)")
    for what, pin, rank in zip("AB", pins, seen):
        log(f"elastic: on {what} world rank {rank['ranks'][0]} of "
            f"{rank['ranks'][1]}, local rank {rank['ranks'][2]} of "
            f"{rank['ranks'][3]}, pinned to card {rank['visible']!r} "
            f"(before the backend's first CUDA call: "
            f"{pin['visible']}, bound {pin['bound_before']})")
    log(f"elastic: step p50 on A {out['step_ms_p50_on_a']:.2f} ms, on B "
        f"{out['step_ms_p50_on_b']:.2f} ms, train()'s "
        f"{out['train_step_ms_p50']:.2f} ms; phase {phase_s:.1f} s")
    return out


# The parallel phase: the dense steps on the one-rank mesh, the MoE
# steps, and the MoE routing of Mixtral 8x7B (`num_local_experts`,
# `num_experts_per_tok` of Mistral AI's published config) at the bench
# model's widths, with the JAX defaults' capacity factor and aux weight
PARALLEL_STEPS, MOE_STEPS = 5, 6
MOE_EXPERTS, MOE_TOP_K = 8, 2
# tolerances, set from the arithmetic before any run:
#  * dense steps on the mesh against train()'s: the same kernels on the
#    same tensors (one rank: every local shard is the whole tensor), the
#    matmuls through local_map and the embedding's backward through
#    F.embedding's where train() indexes; summation orders may differ in
#    the last bits of a bf16 weight per step, so 1e-3 of the loss;
#  * the MoE trainer's losses against the in-process MoE run: the same
#    program on the same card, the worker's under a one-rank mesh; 1e-3;
#  * the MoE forward with every expert holding the dense FFN's weights
#    against the dense forward (capacity factor E / top_k, nothing
#    drops): the two top-k weights are rounded to bf16 before the
#    combine (2^-8 of each), so a layer's FFN output moves by up to
#    ~2^-7 relative, through 16 layers of bf16 residual stream; the
#    logits' max difference within 5e-2 of their max, as the prefill
#    check's bf16 logits.
TOL.update({"mesh_loss_rel": 1e-3, "moe_trainer_loss_rel": 1e-3,
            "moe_parity_logits_rel_to_max": 5e-2})


def moe_config(cfg, **kw):
    return dataclasses.replace(cfg, moe_num_experts=MOE_EXPERTS,
                               moe_top_k=MOE_TOP_K, **kw)


class MoEStats:
    """Records `moe_ffn`'s aux of every call the model makes while
    entered (the transformer module's name is wrapped for the phase)."""

    def __init__(self):
        from ray_tpu_torch.models import transformer
        self.module, self.dropped, self.lb = transformer, [], []

    def __enter__(self):
        self.real = self.module.moe_ffn

        def recording(*args, **kwargs):
            y, aux = self.real(*args, **kwargs)
            self.dropped.append(aux["moe_dropped_fraction"].detach())
            self.lb.append(aux["moe_load_balance_loss"].detach())
            return y, aux
        self.module.moe_ffn = recording
        return self

    def __exit__(self, *exc):
        self.module.moe_ffn = self.real

    def summary(self) -> dict:
        def local(t):
            return float(t.to_local() if hasattr(t, "to_local") else t)
        d = [local(t) for t in self.dropped]
        lb = [local(t) for t in self.lb]
        return {"dropped_fraction_max": max(d) if d else None,
                "dropped_fraction_mean": statistics.mean(d) if d else None,
                "load_balance_loss_mean": statistics.mean(lb) if lb else None,
                "calls": len(d)}


def timed_steps(model, params, opt, batch, steps: int, dev) -> dict:
    """`steps` of `bench.train_step`: each loss, step time (ending in the
    loss's copy to the host) and kernel launches."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses, step_ms, launches = [], [], []
    for _ in range(steps):
        before = kernel_counts()
        t0 = time.perf_counter()
        loss = bench.train_step(model, params, opt, batch).item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        sync()
        after = kernel_counts()
        launches.append({k: after[k] - before[k] for k in after})
        losses.append(loss)
    return {"losses": losses, "step_ms": step_ms, "launches": launches}


def check_launches(runs: list, cfg, what: str) -> dict:
    per_step = {"flash_fwd": cfg.n_layers, "flash_dkdv": cfg.n_layers,
                "flash_dq": cfg.n_layers, "rms_norm": 2 * cfg.n_layers + 1,
                "paged_decode": 0}
    for i, got in enumerate(runs):
        if got != per_step:
            raise AssertionError(f"{what} step {i} launched {got}, expected "
                                 f"{per_step}")
    return per_step


def rel_losses(got: list, want: list, tol: float, what: str) -> float:
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if not all(np.isfinite(got)) or max(rel) > tol:
        raise AssertionError(f"{what} losses {got} against {want[:len(got)]}"
                             f" (max rel {max(rel)}, limit {tol})")
    return max(rel)


def parallel_loop(config):
    """The MoE trainer's `train_loop_per_worker` (pickled by value from the
    driver's `__main__`): the worker imports `chip_smoke` from the repo
    root on its PYTHONPATH and runs `moe_worker` there."""
    import chip_smoke
    chip_smoke.moe_worker(config)


def moe_worker(config: dict) -> None:
    """In the train worker: the mesh from the trainer's MeshSpec over the
    group TorchBackend formed (`prepare_mesh`), the MoE model from seed 0
    placed on it, and a step a report."""
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models.config import TransformerConfig
    from ray_tpu_torch.parallel import (MeshSpec, param_shardings,
                                        prepare_mesh, shard_pytree)
    dev = torch.device(config["device"])
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mesh = prepare_mesh(MeshSpec(**config["mesh"]),
                        device=None if on_card else "cpu")
    cfg = TransformerConfig(**config["cfg"])
    model = Transformer(cfg, mesh=mesh)
    params = shard_pytree(Transformer(cfg).init(0, device=dev),
                          param_shardings(mesh, model.param_logical_axes()))
    opt = bench.make_optimizer(params)
    batch = {"tokens": torch.as_tensor(np.asarray(config["tokens"]),
                                       device=dev)}
    with MoEStats() as stats:
        run = timed_steps(model, params, opt, batch, config["steps"], dev)
    for i, loss in enumerate(run["losses"]):
        metrics = {"step": i, "loss": loss, "step_ms": run["step_ms"][i],
                   "launches": run["launches"][i]}
        if i == config["steps"] - 1:
            metrics.update(stats.summary(), peak_mem_gib=(
                torch.cuda.max_memory_allocated() / 2 ** 30
                if on_card else 0.0))
        rt_train.report(metrics)


def parallel_phase(trained: dict, dev, smi: str, cfg=None,
                   batch: int = TRAIN_B, seq: int = TRAIN_S) -> dict:
    """The parallel layer on the card. (a) The bench model on a one-rank
    nccl mesh (`prepare_mesh(MeshSpec())`), parameters placed by
    `shard_pytree(param_shardings(...))`, PARALLEL_STEPS AdamW steps on
    train()'s batch: each loss within TOL of train()'s at the same step,
    16 / 16 / 16 / 33 launches a step (the kernels inside local_map).
    (b) The bench model's widths with Mixtral 8x7B's routing (8 experts,
    top 2): (i) every expert set to the dense FFN's weights at capacity
    factor 4.0 gives the dense forward with nothing dropped; (ii)
    MOE_STEPS AdamW steps in process without a mesh, the card freed, then
    the same steps through `TorchTrainer` from one `num_gpus=1` worker
    with `ScalingConfig(mesh=MeshSpec())`, whose loop calls
    `prepare_mesh`: losses within TOL of the in-process ones. `dev` is
    the card; the CPU only rehearses (gloo, tiny())."""
    import tempfile

    import torch.distributed as dist

    import ray_tpu_torch
    from ray_tpu_torch.parallel import (MeshSpec, param_shardings,
                                        prepare_mesh, shard_pytree)
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)
    on_card = dev.type == "cuda"
    cfg = cfg or bench.bench_config()
    data = bench.make_batch(cfg, batch, seq, dev)
    out = {"card": smi}

    # (a) dense on the one-rank mesh
    mesh = prepare_mesh(MeshSpec(), device=None if on_card else "cpu")
    try:
        model = Transformer(cfg, mesh=mesh)
        params = shard_pytree(Transformer(cfg).init(0, device=dev),
                              param_shardings(mesh,
                                              model.param_logical_axes()))
        opt = bench.make_optimizer(params)
        reset_counts()
        dense = timed_steps(model, params, opt, data, PARALLEL_STEPS, dev)
        out["dense_launches"] = kernel_counts()
    finally:
        dist.destroy_process_group()
    want = trained["losses"][:PARALLEL_STEPS]
    out["dense"] = {
        "losses": dense["losses"], "train_losses": want,
        "bit_equal": dense["losses"] == want,
        "loss_rel_err_max": rel_losses(dense["losses"], want,
                                       TOL["mesh_loss_rel"], "mesh dense"),
        "step_ms": dense["step_ms"],
        "step_ms_p50": statistics.median(dense["step_ms"][1:]),
        "train_step_ms_p50": trained["step_ms_p50"],
        "launches_per_step": check_launches(dense["launches"], cfg,
                                            "mesh dense")}
    log(f"parallel (a) [{smi}]: {json.dumps(out['dense'])}")
    del model, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (b)(i) identical experts give the dense forward
    dense_model = Transformer(cfg)
    moe_model = Transformer(moe_config(cfg, moe_capacity_factor=float(
        MOE_EXPERTS // MOE_TOP_K)))
    with torch.no_grad():
        dp = dense_model.init(0, device=dev)
        mp = {k: v for k, v in dp.items() if k != "layers"}
        mp["layers"] = []
        for layer in dp["layers"]:
            moe_layer = {k: layer[k] for k in ("attn_norm", "wq", "wk", "wv",
                                               "wo", "mlp_norm")}
            for name, src in (("moe_gate", "gate"), ("moe_up", "up"),
                              ("moe_down", "down")):
                moe_layer[name] = layer[src][None].expand(
                    (MOE_EXPERTS,) + tuple(layer[src].shape))
            moe_layer["router"] = 0.02 * torch.randn(
                cfg.d_model, MOE_EXPERTS, device=dev,
                generator=torch.Generator(device=dev).manual_seed(5)).to(
                    cfg.parameter_dtype)
            mp["layers"].append(moe_layer)
        want_logits = dense_model.apply(dp, data["tokens"])
        reset_counts()
        with MoEStats() as stats:
            got_logits = moe_model.apply(mp, data["tokens"])
        parity_launches = kernel_counts()
        diff = float((got_logits - want_logits).abs().max())
        scale = float(want_logits.abs().max())
    parity = {"max_abs_logit_diff": diff, "max_abs_logit": scale,
              "tolerance_rel_to_max": TOL["moe_parity_logits_rel_to_max"],
              **stats.summary(), "launches": parity_launches}
    if not diff <= TOL["moe_parity_logits_rel_to_max"] * scale:
        raise AssertionError(f"identical experts: logits differ by {diff} "
                             f"(max |logit| {scale})")
    if parity["dropped_fraction_max"] != 0.0:
        raise AssertionError(f"identical experts dropped tokens: {parity}")
    out["moe_parity"] = parity
    log(f"parallel (b)(i) [{smi}]: {json.dumps(parity)}")
    del dp, mp, want_logits, got_logits, dense_model, moe_model
    gc.collect()
    torch.cuda.empty_cache()

    # (b)(ii) MoE steps in process, then through TorchTrainer on a mesh
    moe_cfg = moe_config(cfg)
    model = Transformer(moe_cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device=dev)
    opt = bench.make_optimizer(params)
    reset_counts()
    with MoEStats() as stats:
        local = timed_steps(model, params, opt, data, MOE_STEPS, dev)
    out["moe_in_process"] = {
        "params": moe_cfg.num_params(),
        "active_params": moe_cfg.num_params(active_only=True),
        "losses": local["losses"], "step_ms": local["step_ms"],
        "step_ms_p50": statistics.median(local["step_ms"][1:]),
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else 0.0),
        **stats.summary(),
        "launches_per_step": check_launches(local["launches"], moe_cfg,
                                            "MoE in process"),
        "launches": kernel_counts()}
    log(f"parallel (b)(ii) in process [{smi}]: "
        f"{json.dumps(out['moe_in_process'])}")
    del model, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    storage = tempfile.mkdtemp(prefix="rtt_parallel_phase_")
    config = {"cfg": dataclasses.asdict(moe_cfg), "steps": MOE_STEPS,
              "mesh": dataclasses.asdict(MeshSpec()),
              "tokens": data["tokens"].cpu().numpy().tolist(),
              "device": "cuda" if on_card else "cpu"}
    ray_tpu_torch.init(num_cpus=4)
    try:
        fit_at = time.time()
        result = TorchTrainer(
            parallel_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card,
                                         mesh=MeshSpec()),
            run_config=RunConfig(name="parallel_phase", storage_path=storage),
            backend_config=TorchConfig(
                distributed=True, platform=None if on_card else "cpu"),
        ).fit()
        fit_s = time.time() - fit_at
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    if result.error is not None:
        raise AssertionError(f"MoE TorchTrainer failed: {result.error!r}")
    hist = result.metrics_history
    if [m["step"] for m in hist] != list(range(MOE_STEPS)):
        raise AssertionError(f"MoE trainer steps {[m['step'] for m in hist]}")
    losses = [m["loss"] for m in hist]
    last = hist[-1]
    out["moe_trainer"] = {
        "fit_s": fit_s, "losses": losses,
        "in_process_losses": local["losses"],
        "bit_equal": losses == local["losses"],
        "loss_rel_err_max": rel_losses(losses, local["losses"],
                                       TOL["moe_trainer_loss_rel"],
                                       "MoE trainer"),
        "step_ms_p50": statistics.median([m["step_ms"] for m in hist][1:]),
        "peak_mem_gib": last["peak_mem_gib"],
        "dropped_fraction_max": last["dropped_fraction_max"],
        "dropped_fraction_mean": last["dropped_fraction_mean"],
        "load_balance_loss_mean": last["load_balance_loss_mean"],
        "launches_per_step": check_launches([m["launches"] for m in hist],
                                            moe_cfg, "MoE trainer"),
        "launches": {k: sum(m["launches"][k] for m in hist)
                     for k in hist[0]["launches"]}}
    log(f"parallel (b)(ii) trainer [{smi}]: "
        f"{json.dumps(out['moe_trainer'])}")
    return out


def _double(x):
    return 2 * x


class GpuServer:
    """The runtime phase's actor, made remote with `num_gpus=1`: in its
    own worker process it must see the card, then `serve` runs the
    serving schedule of `serve()` through EngineCore there. It notes the
    card its process was pinned to before its first CUDA call."""

    def __init__(self):
        self.constructed = time.time()      # wall clock: the driver's too
        from ray_tpu_torch._private.accelerators import gpu
        self.pinned = os.environ.get("CUDA_VISIBLE_DEVICES")
        self.bound_before = gpu.cuda_bound()
        if not torch.cuda.is_available():
            raise RuntimeError("the GPU actor sees no card")
        self.pid = os.getpid()

    def ready(self) -> dict:
        name = torch.cuda.get_device_name(0)
        return {"pid": self.pid, "device": name,
                "constructed": self.constructed, "ready": time.time(),
                "pinned": self.pinned, "bound_before": self.bound_before,
                "count": torch.cuda.device_count(),
                "uuid": str(torch.cuda.get_device_properties(0).uuid)}

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
    card's free memory is back within 1 GiB. The runtime pins cards to
    leases: the first actor runs in the worker of an earlier CPU-only
    task, pinned (`CUDA_VISIBLE_DEVICES`) to the node's one card before
    its first CUDA call, and sees exactly that card, the driver's."""
    import ray_tpu_torch
    from ray_tpu_torch._private.accelerators.gpu import card_names
    from ray_tpu_torch._private.specs import SESSION_TAG
    from ray_tpu_torch.util.state import list_workers
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

        def cpu_probe() -> dict:
            # a CPU-only task (pickled by value: its worker imports no
            # torch): its process, its pin, whether CUDA is up there
            from ray_tpu_torch._private.accelerators import gpu
            return {"pid": os.getpid(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "cuda_bound": gpu.cuda_bound()}
        probe = ray_tpu_torch.get(
            ray_tpu_torch.remote(num_gpus=0)(cpu_probe).remote(),
            timeout=120)
        if probe["cuda_bound"]:
            raise AssertionError(f"a CPU-only task's worker has CUDA: "
                                 f"{probe}")
        wait_until(lambda: probe["pid"] in {
            w["pid"] for w in list_workers() if w["state"] == "idle"},
            30, "the CPU task's worker idle")
        idle_before = {w["pid"] for w in list_workers()
                       if w["state"] == "idle"}
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
        card0 = card_names(1)[0]
        out["pin"] = {"cpu_task": probe, "idle_before": sorted(idle_before),
                      "actor_pid": info["pid"],
                      "actor_pinned": info["pinned"],
                      "actor_bound_before": info["bound_before"],
                      "actor_count": info["count"],
                      "same_uuid": info["uuid"] == str(
                          torch.cuda.get_device_properties(0).uuid)}
        log(f"runtime pin: {json.dumps(out['pin'])}")
        if (info["pid"] not in idle_before or info["pinned"] != card0
                or info["bound_before"] or info["count"] != 1
                or not out["pin"]["same_uuid"]):
            raise AssertionError(
                f"the GPU actor (pid {info['pid']}) was not pinned to card "
                f"{card0!r} before its first CUDA call in a worker that "
                f"ran only CPU tasks ({sorted(idle_before)}): "
                f"{out['pin']}")
        got = ray_tpu_torch.get(first.serve.remote(), timeout=900)
        out["held_gib"] = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 30
        log(f"runtime: actor start {out['actor_start_s']:.2f} s, weights "
            f"init {got['weights_init_s']:.2f} s (in the actor)")
        log(f"runtime: decode p50 {got['decode_step_ms_p50']:.3f} ms in the "
            f"actor, {served['decode_step_ms_p50']:.3f} ms in serve()")
        if got["tokens"] != served["tokens"]:
            raise AssertionError(f"actor tokens {got['tokens']} differ from "
                                 f"EngineCore's {served['tokens']}")
        for name in ("flash_fwd", "rms_norm", "paged_decode"):
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


def await_replica(handle, ctx, rt_serve, timeout: float = 300.0) -> list:
    """The replicas' `engine_stats()` once one answers; raises, naming
    the deployment's status and the actors' states, after `timeout` s."""
    deadline = time.monotonic() + timeout
    while not (stats := handle.stats()):
        if time.monotonic() > deadline:
            actors = [(a["state"], a["num_restarts"], a["death_cause"])
                      for a in ctx.state_op("list_actors")]
            raise AssertionError(f"the replica did not answer in "
                                 f"{timeout:.0f} s: {rt_serve.status()}, "
                                 f"actors {actors}")
        time.sleep(0.2)
    if len(stats) != 1:
        raise AssertionError(f"{len(stats)} replicas answered, not 1")
    return stats


def drive_replica(handle, cfg, served: dict, what: str,
                  exact: bool = True) -> dict:
    """A warm-up (the replica's first cuBLAS calls and the stream's first
    connection), then `serve()`'s five requests through
    `LLMHandle.generate`, each TokenStream consumed on its own thread. The
    tokens must equal `serve()`'s EngineCore tokens exactly (with
    `exact`; else they are returned for the caller to judge), the flash
    forward must have launched once a layer a prefill in the replica
    (in each of its tp ranks) and RMSNorm there too. Returns the
    launches (differences of the replica's counts around the requests;
    by rank too for a replica over tp ranks), TTFT and TPOT p50 and the
    replica's peak."""
    lens, new_tokens, prompts = serve_requests(cfg)
    warm = handle.generate(prompts["r0"], max_tokens=2, timeout_s=120)
    if len(warm.tokens()) != 2:
        raise AssertionError("warm-up request")
    st0 = handle.stats()[0]
    before = st0.get("kernel_launches_by_rank", [st0["kernel_launches"]])
    submitted = {}
    streams = {}
    for rid in prompts:
        submitted[rid] = time.perf_counter()
        streams[rid] = handle.generate(prompts[rid],
                                       max_tokens=new_tokens[rid],
                                       timeout_s=120)
    tokens, stamps = consume_streams(streams, 300.0)
    after = handle.stats()[0]
    by_rank = [{k: a[k] - b[k] for k in b} for a, b in zip(
        after.get("kernel_launches_by_rank", [after["kernel_launches"]]),
        before)]
    if exact and tokens != served["tokens"]:
        raise AssertionError(f"{what} tokens {tokens} differ from "
                             f"EngineCore's {served['tokens']}")
    for rank, launches in enumerate(by_rank):
        if launches["flash_fwd"] != cfg.n_layers * len(prompts):
            raise AssertionError(
                f"flash_fwd launched {launches['flash_fwd']} times in rank "
                f"{rank} of the {what} replica, expected a layer a prefill")
        if launches["rms_norm"] <= 0:
            raise AssertionError(f"rms_norm never launched in rank {rank} "
                                 f"of the {what} replica")
        if (launches["paged_decode"] <= 0
                or launches["paged_decode"] % cfg.n_layers):
            raise AssertionError(
                f"paged_decode launched {launches['paged_decode']} times in "
                f"rank {rank} of the {what} replica, expected a layer a "
                f"decode step")
    ttft = [stamps[rid][0] - submitted[rid] for rid in prompts]
    tpot = [b - a for rid in prompts
            for a, b in zip(stamps[rid], stamps[rid][1:])]
    out = {"launches": {"flash_fwd": by_rank[0]["flash_fwd"],
                        "flash_dkdv": 0, "flash_dq": 0,
                        "rms_norm": by_rank[0]["rms_norm"],
                        "paged_decode": by_rank[0]["paged_decode"]},
           "ttft_ms_p50": statistics.median(ttft) * 1e3,
           "tpot_ms_p50": statistics.median(tpot) * 1e3,
           "generated_tokens": sum(map(len, tokens.values())),
           "replica_peak_gib": after.get("device_peak_bytes", 0) / 2 ** 30}
    if "tp" in after:
        out.update(launches_by_rank=by_rank, tokens=tokens,
                   stats={k: after[k] for k in (
                       "tp", "tp_backend", "num_pages", "cache_bytes_by_rank",
                       "weights_s", "tp_cards")})
    return out


def memory_back(free0: int) -> float:
    """GiB of the card not back (against `free0` free bytes) after up to
    60 s; raises over 1 GiB."""
    deadline = time.monotonic() + 60
    while (torch.cuda.mem_get_info()[0] < free0 - 2 ** 30
           and time.monotonic() < deadline):
        time.sleep(0.5)
    held = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 30
    if held > 1.0:
        raise AssertionError(f"{held:.2f} GiB of the card not back after "
                             f"shutdown")
    return held


def serve_llm_phase(served: dict, dev, cfg=None) -> dict:
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
    cfg = cfg or llama3_8b()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    out = {"layers": cfg.n_layers}
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

        t0 = time.perf_counter()
        handle = serve_llm(
            name="llama3-8b", model=cfg, weights=ref, num_replicas=1,
            num_pages=1024, page_size=16, max_batch=DECODE_ROWS,
            ray_actor_options={"num_gpus": 1} if on_card else {},
            device=None if on_card else "cpu")
        out["serve_llm_s"] = time.perf_counter() - t0
        stats = await_replica(handle, context.get_ctx(), rt_serve)
        out["replica_first_answer_s"] = time.perf_counter() - t0
        out["replica_weights_s"] = stats[0]["weights_s"]
        out.update(drive_replica(handle, cfg, served, "serve_llm"))
        del ref
    finally:
        try:
            rt_serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    out["not_returned_gib"] = memory_back(free0)
    log(f"serve_llm: put {out['put_s']:.2f} s ({out['shm_segments']} shm "
        f"segments), replica answers {out['replica_first_answer_s']:.2f} s "
        f"after serve_llm (weights {out['replica_weights_s']:.2f} s there), "
        f"TTFT p50 {out['ttft_ms_p50']:.1f} ms, TPOT p50 "
        f"{out['tpot_ms_p50']:.2f} ms")
    return out


# host room the agent phase needs beyond its two copies of the weights in
# /dev/shm (the head's store and agent A's): the processes' own memory
AGENT_HOST_SLACK = 8 * 2 ** 30


def host_room() -> dict:
    """/dev/shm's free bytes and the kernel's MemAvailable (bytes)."""
    st = os.statvfs("/dev/shm")
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    return {"shm_free_bytes": st.f_bavail * st.f_frsize,
            "mem_available_bytes": avail}


def actor_nodes(ctx) -> dict:
    """Each live actor's (name, node id), by actor id, from the head's
    own books: the actor's worker, and the node that worker runs on."""
    where = {w["worker_id"]: w["node_id"]
             for w in ctx.state_op("list_workers")}
    return {a["actor_id"]: (a["name"], where.get(a["worker_id"]))
            for a in ctx.state_op("list_actors") if a["state"] == "ALIVE"}


class BytesSampler:
    """Samples this process's `OBJECT_PLANE_STATS["serve_bytes"]` every
    `poll` s on a thread: the window in which the head served bytes is
    the relay's (first rise to last)."""

    def __init__(self, stats: dict, poll: float = 0.05):
        self._stats, self._poll = stats, poll
        self.start_bytes = self._seen = stats["serve_bytes"]
        self.first = self.last = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        now, t = self._stats["serve_bytes"], time.perf_counter()
        if now != self._seen:
            self.first = self.first or t - self._poll
            self.last, self._seen = t, now

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            self._sample()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(5)
        self._sample()
        served = self._stats["serve_bytes"] - self.start_bytes
        span = (self.last - self.first) if self.first else None
        return {"served_bytes": served, "relay_s": span,
                "relay_gb_s": served / span / 1e9 if span else None}


def serve_llm_agent_phase(served: dict, dev, cfg=None) -> dict:
    """llama3-8b through `serve_llm` with its replica on a node agent's
    card: the head owns no GPU (`init(num_cpus=4, num_gpus=0)`), agent A
    (a node agent process) owns the card's `GPU: 1`, the weights from
    seed 0 are made on the card and `put` on the head, and the replica
    (`num_gpus=1`) must run on A's node, so its `get` relays the weights
    ref (16.06 GB at full depth) from the head's store into A's over the
    object plane. `serve()`'s
    five requests through `LLMHandle.generate` must give its EngineCore
    tokens exactly, with the flash forward and RMSNorm launched in the
    replica; after `serve.shutdown()` and `shutdown()` the card's memory
    is back within 1 GiB. The ref lives in two stores on one host, so the
    phase raises if /dev/shm or the host's memory lacks room for both.
    `dev` is the card; the CPU only rehearses (the replica is kept off
    the head by a custom `agent` resource instead of `GPU`)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch._private import context
    from ray_tpu_torch._private.object_transfer import OBJECT_PLANE_STATS
    from ray_tpu_torch.serve import _CONTROLLER_NAME
    from ray_tpu_torch.serve.llm import serve_llm
    on_card = dev.type == "cuda"
    cfg = cfg or llama3_8b()
    room = host_room()
    log(f"serve_llm agent: /dev/shm free {room['shm_free_bytes']} B, "
        f"MemAvailable {room['mem_available_bytes']} B")
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    out = {"host_room": room, "layers": cfg.n_layers}
    phase_t0 = time.perf_counter()
    rt = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    agent = None
    try:
        if ray_tpu_torch.cluster_resources().get("GPU", 0) != 0:
            raise AssertionError("the head node holds a GPU")
        only_agent = None if on_card else {"agent": 1.0}
        agent, out["agent_start_s"] = start_agent(
            rt, num_gpus=1 if on_card else 0, resources=only_agent)
        params = init_for_serving(Transformer(cfg), seed=0, device=dev)
        sizes = [t.numel() * t.element_size() for t in bench.leaves(params)]
        out["weights_bytes"] = weights = sum(sizes)
        need = 2 * weights + AGENT_HOST_SLACK
        if min(room.values()) < need:
            raise AssertionError(
                f"the weights' two copies need {need} B of host memory and "
                f"/dev/shm: {room}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(params)
        out["put_s"] = time.perf_counter() - t0
        del params
        gc.collect()
        torch.cuda.empty_cache()

        ctx = context.get_ctx()
        before = set(actor_nodes(ctx))
        sampler = BytesSampler(OBJECT_PLANE_STATS)
        t0 = time.perf_counter()
        handle = serve_llm(
            name="llama3-8b-agent", model=cfg, weights=ref, num_replicas=1,
            num_pages=1024, page_size=16, max_batch=DECODE_ROWS,
            ray_actor_options=({"num_gpus": 1} if on_card
                               else {"resources": only_agent}),
            device=None if on_card else "cpu")
        out["serve_llm_s"] = time.perf_counter() - t0
        stats = await_replica(handle, ctx, rt_serve)
        out["replica_first_answer_s"] = time.perf_counter() - t0
        out["relay"] = sampler.stop()
        out["replica_weights_s"] = stats[0]["weights_s"]
        replicas = [node for aid, (name, node) in actor_nodes(ctx).items()
                    if aid not in before and name != _CONTROLLER_NAME]
        if replicas != [agent.node_id]:
            raise AssertionError(f"replica nodes {replicas}, not agent A's "
                                 f"{agent.node_id}")
        out["replica_node"], out["head_node"] = replicas[0], rt.head_node_id
        if out["relay"]["served_bytes"] < weights:
            raise AssertionError(f"the head served {out['relay']} over the "
                                 f"object plane, less than the weights' "
                                 f"{weights} B")
        out.update(drive_replica(handle, cfg, served, "agent's"))
        out["served_bytes_phase"] = (OBJECT_PLANE_STATS["serve_bytes"]
                                     - sampler.start_bytes)
        del ref
    finally:
        try:
            rt_serve.shutdown()
        finally:
            try:
                if agent is not None:
                    agent.terminate()
                    agent.wait(30)
            finally:
                ray_tpu_torch.shutdown()
    out["not_returned_gib"] = memory_back(free0)
    out["phase_s"] = time.perf_counter() - phase_t0
    relay = out["relay"]
    log(f"serve_llm agent: agent {out['agent_start_s']:.2f} s, put "
        f"{out['put_s']:.2f} s, replica on {out['replica_node']} answers "
        f"{out['replica_first_answer_s']:.2f} s after serve_llm (weights "
        f"{out['replica_weights_s']:.2f} s there), relay "
        f"{relay['served_bytes']} B in {relay['relay_s']} s "
        f"({relay['relay_gb_s']} GB/s), TTFT p50 {out['ttft_ms_p50']:.1f} "
        f"ms, TPOT p50 {out['tpot_ms_p50']:.2f} ms")
    return out


# ------------------------------------------------------------ phase 7b
# The tp phase: ranks of a replica, and the pages its kv budget buys at
# tp=1 (serve()'s pool: 1,024 pages of 16, 2 GiB at llama3-8b)
TP_RANKS, TP_BUDGET_PAGES = 2, 1024
# tolerance, set from the arithmetic before any run: the tp ranks sum
# the row-parallel products (wo, down) in f32 from two bf16 partials
# where one process rounds one bf16 product, so each of the 64 residual
# adds a token may round one bf16 ulp (2^-8 relative) the other way, and
# the difference grows through 32 layers like a random walk; 5e-2 of
# max|logit| is the limit of the prefill check against
# Transformer.apply, whose matmuls round in other shapes (and hold). A
# walk through n layers is sqrt(n / 32) as long: 2.5e-2 at the
# SERVE_LLM_LAYERS = 8 the phase runs.
TOL["tp_logits_rel_to_max"] = 0.05


def tp_logits_limit(n_layers: int) -> float:
    """(a)'s limit on max|Δ| over max|logit| through `n_layers` layers."""
    return TOL["tp_logits_rel_to_max"] * (n_layers / 32) ** 0.5


def teacher_forced(model, params, cache, prompt, forced, dev,
                   group=None) -> torch.Tensor:
    """Prefill `prompt` into pages 0.., then one decode step a token of
    `forced` (row 0 of a DECODE_ROWS batch), as EngineCore lays them out;
    with a tp `group`, each step is announced to the other ranks first.
    Returns the f32 logits rows on the host: row j is what chose token j
    of `forced` (the last row, what would follow it)."""
    from ray_tpu_torch.serve.llm import replica_group as rg
    from ray_tpu_torch.serve.llm.engine import _bucket
    cfg, page = model.config, 16
    n = len(prompt)
    max_pages = pages_needed(cfg.max_seq_len, page)
    table = np.full((max_pages,), -1, np.int32)
    used = pages_needed(n + len(forced), page)
    table[:used] = np.arange(used)
    padded = np.zeros((_bucket(n, hi=cfg.max_seq_len),), np.int32)
    padded[:n] = prompt
    if group is not None:
        group.send_step(rg.KIND_PREFILL, (padded, table), n)
    with torch.inference_mode():
        logits, _ = decode.prefill(model, params,
                                   torch.as_tensor(padded, device=dev), n,
                                   torch.as_tensor(table, device=dev),
                                   cache, page, group=group)
        rows = [logits]
        for j, tok in enumerate(forced):
            tokens = np.zeros((DECODE_ROWS,), np.int32)
            positions = np.zeros((DECODE_ROWS,), np.int32)
            pts = np.full((DECODE_ROWS, max_pages), -1, np.int32)
            active = np.zeros((DECODE_ROWS,), bool)
            tokens[0], positions[0], pts[0], active[0] = tok, n + j, table, 1
            if group is not None:
                group.send_step(rg.KIND_DECODE,
                                (tokens, positions, pts, active))
            logits, _ = decode.decode_step(
                model, params, cache,
                *(torch.as_tensor(a, device=dev)
                  for a in (tokens, positions, pts, active)), page,
                group=group)
            rows.append(logits[0])
        return torch.stack(rows).cpu()


def top2_margins(rows: torch.Tensor) -> list:
    top = rows.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def tp_model_check(served: dict, dev, cfg) -> dict:
    """Phase 7b (a), in a live runtime: every request of `serve()`
    teacher-forced on its tokens in this process with no group (the top-2
    margin of every step), the flash forward at a tp=2 rank's heads
    against its plain version, then this process as rank 0 of a
    `RankGroup` with one `num_gpus=0.5` rank actor (gloo: the ranks share
    the card) runs the 2,900-token prompt's prefill and 16 decode steps
    teacher-forced the same way; max|Δ| over max|logit| within
    `tp_logits_limit(cfg.n_layers)`, each rank's launches exact."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.llm import replica_group as rg
    on_card = dev.type == "cuda"
    model = Transformer(cfg)
    lens, new_tokens, prompts = serve_requests(cfg)
    want = served["tokens"]
    out = {}
    pages = pages_needed(4096 + 64, 16)
    params = init_for_serving(model, seed=0, device=dev)
    cache = decode.init_paged_cache(cfg, pages, 16, device=dev)
    margins, ref_rows, agree = {}, None, 0
    for rid in prompts:
        rows = teacher_forced(model, params, cache, prompts[rid], want[rid],
                              dev)
        margins[rid] = top2_margins(rows[:-1])
        agree += int((rows[:-1].argmax(-1) == torch.tensor(want[rid]))
                     .sum())
        if rid == "r3":
            ref_rows = rows
    out["one_process_argmax_agrees"] = f"{agree} of " \
        f"{sum(map(len, want.values()))}"
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(15)
    q, k, v = fwd_inputs(1, HEADS // TP_RANKS, KV_HEADS // TP_RANKS, S_MAIN,
                         S_MAIN, HEAD_DIM, dev, gen)
    ro, _ = flash_attention_reference(q, k, v, True)
    out["flash_local_heads_err"] = compare(
        flash_attention(q, k, v, causal=True), ro, TOL["flash_o"],
        "flash fwd at a tp=2 rank's heads")
    del q, k, v, ro

    t0 = time.perf_counter()
    ranks = rg.RankGroup(TP_RANKS, dev, {"num_gpus": 0.5} if on_card else {})
    try:
        if on_card and ranks.backend != "gloo":
            raise AssertionError(f"two ranks on one card chose "
                                 f"{ranks.backend}, not gloo")
        loads = ranks.setup(cfg, None, 0, pages, 16, DECODE_ROWS)
        shard = rg.rank_params(model, None, 0, TP_RANKS, 0, dev)
        cache = decode.init_paged_cache(cfg, pages, 16, device=dev,
                                        kv_heads=cfg.kv_heads // TP_RANKS)
        ray_tpu_torch.get(loads, timeout=600)
        ranks.start()
        out["ranks_start_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_counts()
        f0 = ranks.launches()
        t0 = time.perf_counter()
        rows = teacher_forced(model, shard, cache, prompts["r3"], want["r3"],
                              dev, group=ranks.group)
        out["teacher_forced_s"] = time.perf_counter() - t0
        counts = [kernel_counts()] + [{k: a[k] - b[k] for k in a}
                                      for a, b in zip(ranks.launches(), f0)]
    finally:
        ranks.close()
    del shard, cache
    gc.collect()
    torch.cuda.empty_cache()
    steps = 1 + len(want["r3"])
    for rank, c in enumerate(counts):
        if (c["flash_fwd"] != cfg.n_layers
                or c["rms_norm"] != (2 * cfg.n_layers + 1) * steps
                or c["paged_decode"] != cfg.n_layers * (steps - 1)):
            raise AssertionError(f"rank {rank} launched {c} in one prefill "
                                 f"and {steps - 1} decode steps")
    gap = (rows - ref_rows).abs().max().item()
    scale = ref_rows.abs().max().item()
    out.update(backend=ranks.backend, max_abs_diff=gap, max_abs_logit=scale,
               rel_to_max=gap / scale, limit=tp_logits_limit(cfg.n_layers),
               argmax_equal=int((rows.argmax(-1) == ref_rows.argmax(-1))
                                .sum()),
               rows=len(rows), launches_by_rank=counts, margins=margins)
    log("serve tp (a): " + json.dumps({k: v for k, v in out.items()
                                       if k != "margins"}))
    if gap > tp_logits_limit(cfg.n_layers) * scale:
        raise AssertionError("tp=2 logits disagree with one process's")
    return out


def serve_tp_phase(served: dict, dev, smi: str, llm_served: dict,
                   cfg=None) -> dict:
    """llama3-8b served from a replica sharded over tensor-parallel ranks
    (`LLMEngine(mesh=...)`, `serve_llm(mesh=...)`), both ranks on the
    card, seed-0 weights each rank makes and shards itself:
    (a) the model (`tp_model_check`): two ranks over gloo against one
        process, and the top-2 margin of every step of `serve()`'s five
        requests in one process;
    (b) `serve_llm(mesh={"dp": 1, "tp": 1})` with one `num_gpus=1`
        replica (a one-rank nccl group) and the `kv_budget_bytes` of
        `serve()`'s pool: `serve()`'s tokens exactly, its 1,024 pages,
        TPOT p50 (beside `serve()`'s decode step p50 and the serve_llm
        phase's TPOT at its depth);
    (c) `serve_llm(mesh={"tp": 2})` with `num_gpus=0.5` a rank and (b)'s
        page count: `serve()`'s tokens, except that a request may part
        at a step whose one-process top-2 margin is below (a)'s measured
        gap (each such step is printed; any other parting fails), each
        rank's cache half of (b)'s, both ranks' launches, TPOT p50;
    (d) after `serve.shutdown()` and `shutdown()` the card's free memory
        is back within 1 GiB.
    `dev` is the card; the CPU only rehearses."""
    import ray_tpu_torch
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch._private import context
    from ray_tpu_torch._private.accelerators.gpu import card_names
    from ray_tpu_torch.serve.llm import serve_llm
    on_card = dev.type == "cuda"
    cfg = cfg or llama3_8b()
    lens, new_tokens, prompts = serve_requests(cfg)
    want = served["tokens"]
    budget = TP_BUDGET_PAGES * decode.cache_page_bytes(cfg, 16)
    out = {"card": smi, "kv_budget_bytes": budget}
    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    try:
        out["a"] = tp_model_check(served, dev, cfg)
        margins, gap = out["a"].pop("margins"), out["a"]["max_abs_diff"]

        # (b) tp=1 through serve_llm: a one-rank nccl group
        t0 = time.perf_counter()
        handle = serve_llm(
            name="llama3-8b-tp1", model=cfg, mesh={"dp": 1, "tp": 1},
            num_replicas=1, kv_budget_bytes=budget, page_size=16,
            max_batch=DECODE_ROWS,
            ray_actor_options={"num_gpus": 1} if on_card else {},
            device=None if on_card else "cpu")
        await_replica(handle, context.get_ctx(), rt_serve)
        b = drive_replica(handle, cfg, served, "serve_llm tp=1")
        b["replica_first_answer_s"] = time.perf_counter() - t0
        st = b["stats"]
        if (st["tp"], st["tp_backend"]) != (1, "nccl" if on_card
                                            else "gloo"):
            raise AssertionError(f"tp=1 replica: {st}")
        if (st["num_pages"], st["cache_bytes_by_rank"]) != (
                TP_BUDGET_PAGES, [budget]):
            raise AssertionError(f"tp=1 cache {st}, budget {budget}")
        b["beside"] = {"serve_decode_step_ms_p50":
                       served.get("decode_step_ms_p50"),
                       "serve_llm_phase_tpot_ms_p50":
                       llm_served["tpot_ms_p50"],
                       "serve_llm_phase_layers": llm_served.get("layers")}
        out["b"] = {k: v for k, v in b.items() if k != "tokens"}
        log("serve tp (b): " + json.dumps(out["b"]))
        rt_serve.shutdown()

        # (c) tp=2 through serve_llm, both ranks on the card
        t0 = time.perf_counter()
        handle = serve_llm(
            name="llama3-8b-tp2", model=cfg, mesh={"tp": TP_RANKS},
            num_replicas=1, num_pages=st["num_pages"], page_size=16,
            max_batch=DECODE_ROWS,
            ray_actor_options={"num_gpus": 0.5} if on_card else {},
            device=None if on_card else "cpu")
        await_replica(handle, context.get_ctx(), rt_serve)
        c = drive_replica(handle, cfg, served, "serve_llm tp=2",
                          exact=False)
        c["replica_first_answer_s"] = time.perf_counter() - t0
        stc = c["stats"]
        half = [budget // TP_RANKS] * TP_RANKS
        if (stc["tp"] != TP_RANKS or stc["num_pages"] != st["num_pages"]
                or stc["cache_bytes_by_rank"] != half):
            raise AssertionError(f"tp=2 replica {stc}, expected "
                                 f"{st['num_pages']} pages and {half} B")
        if on_card and stc["tp_backend"] != "gloo":
            raise AssertionError(f"tp=2 on one card: {stc['tp_backend']}")
        # the runtime packs the two half-card leases onto one card and
        # pins both ranks' processes to it
        c["tp_cards"] = stc["tp_cards"]
        if on_card and (len(stc["tp_cards"]) != TP_RANKS
                        or set(stc["tp_cards"]) != {card_names(1)[0]}):
            raise AssertionError(f"tp=2 ranks of num_gpus=0.5 pinned to "
                                 f"{stc['tp_cards']}, not to the one card")
        got = c.pop("tokens")
        parted = []
        for rid in prompts:
            if len(got[rid]) != len(want[rid]):
                raise AssertionError(f"{rid}: {len(got[rid])} tokens")
            j = next((i for i, (x, y) in enumerate(zip(got[rid], want[rid]))
                      if x != y), None)
            if j is None:
                continue
            step = {"rid": rid, "step": j, "margin": margins[rid][j],
                    "gap": gap}
            log(f"serve tp (c): {rid} parts from serve() at step {j}: "
                f"one-process top-2 margin {margins[rid][j]:.4f}, (a)'s "
                f"gap {gap:.4f}")
            if margins[rid][j] >= gap:
                raise AssertionError(f"tp=2 tokens part from serve()'s at "
                                     f"{step}, not a near tie")
            parted.append(step)
        c["parted_near_ties"] = parted
        c["min_margin"] = min(min(m) for m in margins.values())
        out["c"] = c
        log("serve tp (c): " + json.dumps(c))
    finally:
        try:
            rt_serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    out["d_not_returned_gib"] = memory_back(free0)
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"serve tp: (a) max|Δ| {gap:.4f} of max|logit| "
        f"{out['a']['max_abs_logit']:.3f}; TPOT p50 tp=1 "
        f"{out['b']['tpot_ms_p50']:.2f} ms ({out['b']['beside']}), tp=2 "
        f"{c['tpot_ms_p50']:.2f} ms; "
        f"{len(parted)} near-tie partings; phase {out['phase_s']:.1f} s "
        f"({smi})")
    return out


# ------------------------------------------------------------ phase 12b
# The tune phase: the bench model cut to TUNE_LAYERS layers, an lr grid,
# steps a trial
TUNE_LAYERS, TUNE_LRS, TUNE_STEPS = 4, (3e-4, 1e-5, 3e-3), 4


def tune_loop(config):
    """The tune phase's `train_loop_per_worker` (pickled by value from
    this script's `__main__`): the worker imports `chip_smoke` and runs
    `tune_worker` there."""
    import chip_smoke
    chip_smoke.tune_worker(config)


def tune_worker(config: dict) -> None:
    """In a trial's worker: the cut bench model from seed 0, AdamW at the
    trial's lr, `train()`'s batch; a report a step with the loss, the
    first step's loss and this process's kernel launches so far."""
    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models.config import TransformerConfig
    dev = torch.device(config["device"])
    cfg = TransformerConfig(**config["cfg"])
    model = Transformer(cfg)
    params = model.init(0, device=dev)
    opt = bench.make_optimizer(params)
    for group in opt.param_groups:
        group["lr"] = config["lr"]
    batch = bench.make_batch(cfg, config["batch"], config["seq"], dev)
    reset_counts()
    first = None
    for step in range(config["steps"]):
        loss = bench.train_step(model, params, opt, batch).item()
        first = loss if first is None else first
        rt_train.report({"loss": loss, "first_loss": first, "step": step,
                         "launches": kernel_counts(), "pid": os.getpid()})


def tune_phase(dev, smi: str, cfg=None, batch: int = TRAIN_B,
               seq: int = TRAIN_S) -> dict:
    """A `Tuner` over a `TorchTrainer` with one `GPU: 1` worker, the bench
    model at full width and TUNE_LAYERS layers: an lr grid of three, one
    trial at a time, TUNE_STEPS steps a trial under ASHA (`max_t` 4,
    `grace_period` 1, reduction factor 2). At least one trial STOPPED;
    `get_best_result()` is the trial with the lowest last loss; every
    trial's first loss equal to the same model's first loss in this
    process bit for bit; every trial's worker launched all four kernels.
    `dev` is the card; the CPU only rehearses."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)
    on_card = dev.type == "cuda"
    cfg = cfg or dataclasses.replace(bench.bench_config(),
                                     n_layers=TUNE_LAYERS)
    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    model = Transformer(cfg)
    params = model.init(0, device=dev)
    opt = bench.make_optimizer(params)
    first = bench.train_step(model, params, opt,
                             bench.make_batch(cfg, batch, seq, dev)).item()
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    storage = tempfile.mkdtemp(prefix="rtt_tune_")
    ray_tpu_torch.init(num_cpus=4)
    try:
        trainer = TorchTrainer(
            tune_loop,
            train_loop_config={"cfg": dataclasses.asdict(cfg),
                               "device": "cuda" if on_card else "cpu",
                               "steps": TUNE_STEPS, "batch": batch,
                               "seq": seq, "lr": 0.0},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
            backend_config=TorchConfig(
                platform=None if on_card else "cpu"))
        t0 = time.perf_counter()
        grid = tune.Tuner(
            trainer, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1,
                scheduler=tune.ASHAScheduler(
                    metric="loss", mode="min", max_t=TUNE_STEPS,
                    grace_period=1, reduction_factor=2)),
            run_config=RunConfig(name="tune_phase",
                                 storage_path=storage)).fit()
        fit_s = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    trials = [{"lr": t.config["lr"], "status": t.status,
               "results": t.num_results, "error": t.error,
               **{k: t.last_result.get(k) for k in
                  ("loss", "first_loss", "launches", "pid")}}
              for t in grid.trials]
    out = {"card": smi, "layers": cfg.n_layers, "params": cfg.num_params(),
           "first_loss_in_process": first, "trials": trials,
           "fit_s": fit_s}
    log("tune: " + json.dumps(out))
    if grid.num_errors:
        raise AssertionError(f"trials failed: {trials}")
    if not any(t["status"] == "STOPPED" for t in trials):
        raise AssertionError(f"no trial STOPPED: {trials}")
    best = grid.get_best_result()
    lowest = min(trials, key=lambda t: t["loss"])
    if best.config["lr"] != lowest["lr"]:
        raise AssertionError(f"best result lr {best.config['lr']}, lowest "
                             f"last loss at lr {lowest['lr']}")
    for t in trials:
        if t["first_loss"] != first:
            raise AssertionError(f"trial lr {t['lr']}: first loss "
                                 f"{t['first_loss']!r}, in process "
                                 f"{first!r}")
        if on_card and min(n for k, n in t["launches"].items()
                           if k != "paged_decode") <= 0:
            raise AssertionError(f"trial lr {t['lr']} launched "
                                 f"{t['launches']}")
    out["best_lr"] = best.config["lr"]
    out["not_returned_gib"] = memory_back(free0)
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"tune: {len(trials)} trials in {fit_s:.1f} s, best lr "
        f"{out['best_lr']}, phase {out['phase_s']:.1f} s ({smi})")
    return out


# ---------------------------------------------------------------- phase 12
# The pipeline phase: executions of the channel DAG, microbatches and
# steps of the 2-stage pipeline
DAG_EXECS, PIPE_STAGES, PIPE_MB, PIPE_STEPS = 20, 2, 2, 5
# tolerances, set from the arithmetic before any run:
#  * the pipeline's losses against the same steps in one process: the
#    same stage functions, kernels, microbatches, recompute, sum order
#    and AdamW, and the channels carry the activations' and cotangents'
#    bits; only the embedding's backward may add a token's rows in
#    another order (atomics), a bf16 ulp of a weight a step carried on
#    by AdamW, so 1e-3 of the loss (bit-equal expected, and printed);
#  * step 0 against train()'s step 0: the same weights and tokens, the
#    mean of two equal microbatch means against the full-batch mean;
#    the matmuls run at batch 1 instead of 2 and may tile and round in
#    another order, so 1e-3 of the loss.
TOL.update({"pipeline_loss_rel": 1e-3, "pipeline_step0_rel": 1e-3})


def this_module():
    """This file as the module `chip_smoke`, also when it runs as
    `__main__`: what a worker is sent from it then pickles by reference,
    and the worker imports it from the repo root on its PYTHONPATH."""
    import importlib
    return importlib.import_module("chip_smoke")


class DagProducer:
    """Phase 12(a)'s first actor: a bf16 tensor of the bench activation's
    shape on its card, from a seed, and the checksum of each one made."""

    def __init__(self, shape, device: str):
        self.shape, self.device, self.sums = tuple(shape), device, []

    def make(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        t = torch.randn(self.shape, generator=gen, device=self.device,
                        dtype=torch.float32).to(torch.bfloat16)
        self.sums.append(checksum(t))
        return t

    def checksums(self):
        return self.sums


class DagConsumer:
    """Phase 12(a)'s second actor: the checksum of what arrived, where."""

    def take(self, t):
        return {"sum": checksum(t), "device": str(t.device),
                "dtype": str(t.dtype), "shape": list(t.shape)}


def channel_span_ms(procs: list, name: str) -> list:
    """Durations (ms) of the tracing plane's channel spans `name`."""
    return [(ev[6] - ev[5]) / 1e6 for proc in procs
            for ev in proc.get("events", ()) if ev[3] == "channel"
            and ev[4] == name]


def dag_phase(dev, shape=(1, TRAIN_S, TRAIN_D)) -> dict:
    """Phase 12(a): two actors (`num_gpus=0.5` each on the card) chained
    by `ActorMethod.bind` and compiled with `enable_shm_channels=True`;
    the first returns a bf16 CUDA tensor, which the channel carries as
    raw bytes and lands on the second actor's own card. DAG_EXECS
    executions, each checksum equal to the producer's bit for bit."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode
    me = this_module()
    on_card = dev.type == "cuda"
    nbytes = int(np.prod(shape)) * 2
    opts = {"num_gpus": 0.5} if on_card else {}
    ray_tpu_torch.init(num_cpus=4)
    try:
        a = ray_tpu_torch.remote(**opts)(me.DagProducer).remote(
            shape, "cuda" if on_card else "cpu")
        b = ray_tpu_torch.remote(**opts)(me.DagConsumer).remote()
        with InputNode() as inp:
            out = b.take.bind(a.make.bind(inp))
        dag = out.experimental_compile(enable_shm_channels=True,
                                       buffer_size_bytes=nbytes + (1 << 16))
        got, exec_ms = [], []
        try:
            for i in range(DAG_EXECS):
                t0 = time.perf_counter()
                got.append(dag.execute(i).get(timeout=120))
                exec_ms.append((time.perf_counter() - t0) * 1e3)
            from ray_tpu_torch._private import context as rt_ctx
            procs = rt_ctx.get_ctx().state_op("trace_dump").get(
                "processes", [])
        finally:
            dag.teardown()
        want = ray_tpu_torch.get(a.checksums.remote(), timeout=60)
    finally:
        ray_tpu_torch.shutdown()
    sums = [g["sum"] for g in got]
    if sums != want:
        raise AssertionError(f"channel DAG checksums {sums} != the "
                             f"producer's {want}")
    if on_card and any(not g["device"].startswith("cuda") for g in got):
        raise AssertionError(f"the consumer got tensors on "
                             f"{[g['device'] for g in got]}")
    if any(g["dtype"] != "torch.bfloat16" or g["shape"] != list(shape)
           for g in got):
        raise AssertionError(f"the consumer got {got[0]}")
    write = channel_span_ms(procs, "ch.write:make")
    read = channel_span_ms(procs, "ch.read:make")
    return {"executions": DAG_EXECS, "bit_equal": True,
            "bytes_per_execution": nbytes, "consumer_device": got[0]["device"],
            "execute_ms_p50": statistics.median(exec_ms[1:]),
            "execute_ms": [round(t, 3) for t in exec_ms],
            "channel_write_ms_p50": (statistics.median(write)
                                     if write else "not measured"),
            "channel_read_ms_p50": (statistics.median(read)
                                    if read else "not measured"),
            "channel_spans": [len(write), len(read)]}


def pipe_layers(cfg, dev) -> list:
    """The model's params (seed 0) as the pipeline's list of layers: the
    first layer also holds the embedding, the last the final norm and
    the head."""
    params = Transformer(cfg).init(0, device=dev)
    layers = [dict(layer) for layer in params["layers"]]
    layers[0]["embed"] = params["embed"]
    layers[-1]["final_norm"] = params["final_norm"]
    layers[-1]["lm_head"] = params["lm_head"]
    return layers


_PIPE_MODELS: dict = {}


def pipe_stage(layers, x, cfg_dict):
    """One pipeline stage of the model: the embedding where the stage
    holds it (x is then the tokens), its layers, and where it holds them
    the final norm and the head (the output is then f32 logits). The
    same ops, in the same order, as `Transformer.loss`."""
    from ray_tpu_torch.models.config import TransformerConfig
    from ray_tpu_torch.ops.rope import rope_cos_sin
    key = json.dumps(cfg_dict, sort_keys=True)
    if key not in _PIPE_MODELS:
        _PIPE_MODELS[key] = Transformer(TransformerConfig(**cfg_dict))
    model = _PIPE_MODELS[key]
    c = model.config
    if "embed" in layers[0]:
        x = model._embed_lookup(layers[0]["embed"], x.long())
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device).expand(b, s)
    cos, sin = rope_cos_sin(pos, c.head_dim, c.rope_theta)
    for layer in layers:
        x, _ = model._layer(x, layer, cos, sin)
    if "final_norm" in layers[-1]:
        x = model._norm(x, layers[-1]["final_norm"])
        x = (x @ layers[-1]["lm_head"].to(c.activation_dtype)).to(
            torch.float32)
    return x


def pipe_loss(logits, tokens):
    """The microbatch's mean next-token CE (`Transformer.loss`'s)."""
    from ray_tpu_torch.ops.losses import softmax_cross_entropy
    return softmax_cross_entropy(logits[:, :-1], tokens.long()[:, 1:])[0]


def pipe_adamw(leaves_: list):
    """bench.py's AdamW over a stage's leaves."""
    return torch.optim.AdamW(leaves_, lr=1e-4, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


class PipeAdamW:
    """A stage's `update_fn`: bench.py's AdamW over the stage's leaves,
    built on the stage process at the first call. Each call also appends
    to `log_path`, from the stage process, the kernel launches since the
    stage's loop unpickled this object (its start), the time, the peak
    device memory and what the process sees of the card."""

    def __init__(self, log_path: str):
        self.log_path, self.opt, self.base = log_path, None, None

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.base = kernel_counts()           # the stage loop's start

    def __call__(self, params, grads, step):
        from torch.utils._pytree import tree_leaves
        ps = tree_leaves(params)
        if self.opt is None:
            self.opt = pipe_adamw(ps)
        for p, g in zip(ps, tree_leaves(grads)):
            p.grad = g
        self.opt.step()
        on_card = ps[0].is_cuda
        if on_card:
            torch.cuda.synchronize()
        counts = kernel_counts()
        rec = {"step": step, "pid": os.getpid(), "t": time.time(),
               # the first stage holds the embedding (`pipe_layers`)
               "first": "embed" in params[0],
               "launches": {k: counts[k] - self.base[k] for k in counts},
               "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                if on_card else 0.0),
               "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "device": (torch.cuda.get_device_name(ps[0].device)
                          if on_card else "cpu")}
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return params


def pipe_reference(cfg, dev, tokens) -> list:
    """The pipeline's steps in this one process: the same two stage
    functions on the same microbatches, a non-last stage's forward
    without autograd and its backward recomputed (`stage_grads`), grads
    summed over the microbatches in their order, the same AdamW. Returns
    each step's loss."""
    from torch.utils._pytree import tree_leaves, tree_map

    from ray_tpu_torch.parallel.pipeline import partition_layers, slice_stage
    from ray_tpu_torch.train.pipeline import stage_grads
    cfg_dict = dataclasses.asdict(cfg)
    layers = pipe_layers(cfg, dev)
    stages = [slice_stage(layers, *p)
              for p in partition_layers(len(layers), PIPE_STAGES)]
    opts = [pipe_adamw(tree_leaves(st)) for st in stages]
    bs = tokens.shape[0] // PIPE_MB
    losses = []
    for _ in range(PIPE_STEPS):
        grads = [tree_map(torch.zeros_like, st) for st in stages]
        acc = 0.0
        for m in range(PIPE_MB):
            x = tokens[m * bs:(m + 1) * bs]
            with torch.no_grad():
                y = pipe_stage(stages[0], x, cfg_dict)
            loss_m, dp1, dx = stage_grads(
                pipe_stage, (cfg_dict,), stages[1], y,
                lambda out, x=x: pipe_loss(out, x))
            acc += float(loss_m)
            _, dp0, _ = stage_grads(pipe_stage, (cfg_dict,), stages[0], x,
                                    lambda out: out, dx)
            grads = [tree_map(lambda g, d: g + d, g_, d_)
                     for g_, d_ in zip(grads, (dp0, dp1))]
        for st, g_, opt in zip(stages, grads, opts):
            for p, g in zip(tree_leaves(st), tree_leaves(g_)):
                p.grad = g / PIPE_MB
            opt.step()
        losses.append(acc / PIPE_MB)
    return losses


def pipe_launches(cfg, stage: int) -> dict:
    """Launches a step in a stage worker: 8 layers a stage, PIPE_MB
    microbatches. A non-last stage runs each microbatch's forward twice
    (without autograd, then the recompute in its backward) and its
    backward once; the last stage runs forward and backward once. The
    RMSNorm backward is plain torch, so RMSNorm counts forwards only:
    two a layer, and the final norm on the last stage."""
    per_stage = cfg.n_layers // PIPE_STAGES
    last = stage == PIPE_STAGES - 1
    fwd = (1 if last else 2) * per_stage * PIPE_MB
    return {"flash_fwd": fwd, "flash_dkdv": per_stage * PIPE_MB,
            "flash_dq": per_stage * PIPE_MB,
            "rms_norm": 2 * fwd + (PIPE_MB if last else 0),
            "paged_decode": 0}


def pipeline_phase(trained: dict, dev, smi: str, cfg=None,
                   batch: int = TRAIN_B, seq: int = TRAIN_S) -> dict:
    """Phase 12: (a) `dag_phase`; (b) the bench model at full width and
    depth through `TorchTrainer(pipeline_stages=2)`: two stage workers
    with `GPU: 0.5` each on the one card, 8 layers a stage (the embedding
    on stage 0; the final norm, the head and the loss on stage 1), the
    1F1B schedule over shm channels, PIPE_MB microbatches of train()'s
    batch, PIPE_STEPS steps of a per-stage AdamW. Held to: the same
    steps in this process (`pipe_reference`, expected bit-equal: the
    kernels are deterministic and the channels carry bits), within
    TOL["pipeline_loss_rel"]; train()'s step-0 loss within
    TOL["pipeline_step0_rel"] (the mean of two equal microbatch means
    against the full-batch mean); a finite, falling loss; exact launch
    counts a step in each stage worker (`pipe_launches`), read there;
    both workers on the card; after shutdown the card's memory back."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.parallel.pipeline import partition_layers
    from ray_tpu_torch.train import (PipelineConfig, ScalingConfig,
                                     TorchTrainer)
    me = this_module()
    cfg = cfg or bench.bench_config()
    on_card = dev.type == "cuda"
    out = {"dag": dag_phase(dev, (1, seq, cfg.d_model))}
    log(f"pipeline (a) [{smi}]: {json.dumps(out['dag'])}")

    tokens = bench.make_batch(cfg, batch, seq, dev)["tokens"]
    t0 = time.perf_counter()
    ref_losses = pipe_reference(cfg, dev, tokens)
    ref_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    layers = [{k: v.cpu() for k, v in layer.items()}
              for layer in pipe_layers(cfg, dev)]
    gc.collect()
    torch.cuda.empty_cache()
    if on_card:
        torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    host_tokens = tokens.cpu().numpy()
    act_bytes = (batch // PIPE_MB) * seq * cfg.d_model * 2
    tok_bytes = (batch // PIPE_MB) * seq * host_tokens.itemsize
    log_dir = tempfile.mkdtemp(prefix="rtt_pipeline_phase_")
    log_path = os.path.join(log_dir, "stages.jsonl")
    res = {"GPU": 0.5, "CPU": 1} if on_card else {"CPU": 1}
    ray_tpu_torch.init(num_cpus=4)
    try:
        fit_at = time.time()
        result = TorchTrainer(
            pipeline_stages=PIPE_STAGES,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card,
                                         resources_per_worker=res),
            pipeline_config=PipelineConfig(
                init_params=layers, stage_fn=me.pipe_stage,
                loss_fn=me.pipe_loss, consts=(dataclasses.asdict(cfg),),
                batch_fn=lambda step: (host_tokens, host_tokens),
                steps=PIPE_STEPS, num_microbatches=PIPE_MB,
                schedule="1f1b", transport="shm",
                channel_capacity_bytes=act_bytes + (1 << 16),
                update_fn=me.PipeAdamW(log_path))).fit()
        fit_s = time.time() - fit_at
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 60
    while (torch.cuda.mem_get_info()[0] < free0 - 2 ** 30
           and time.monotonic() < deadline):
        time.sleep(0.5)
    not_back = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 30
    with open(log_path) as f:
        recs = [json.loads(line) for line in f]
    shutil.rmtree(log_dir, ignore_errors=True)
    if result.error is not None:
        raise AssertionError(f"pipeline TorchTrainer failed: "
                             f"{result.error!r}")
    if not_back > 1.0:
        raise AssertionError(f"the pipeline left {not_back:.2f} GiB of the "
                             f"card in use after shutdown")
    losses = [h["loss"] for h in result.metrics_history]
    if len(losses) != PIPE_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"pipeline losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"pipeline loss did not fall: {losses}")
    ref_rel = rel_losses(losses, ref_losses, TOL["pipeline_loss_rel"],
                         "pipeline against its one-process reference")
    step0_rel = abs(losses[0] - trained["losses"][0]) / trained["losses"][0]
    if step0_rel > TOL["pipeline_step0_rel"]:
        raise AssertionError(f"pipeline step 0 loss {losses[0]} against "
                             f"train()'s {trained['losses'][0]}")
    pids = sorted({r["pid"] for r in recs})
    if len(pids) != PIPE_STAGES:
        raise AssertionError(f"stage records from pids {pids}")
    stages, per_step = [], []
    first = {r["pid"] for r in recs if r["first"]}
    for stage, pid in enumerate(sorted(pids, key=lambda p: p not in first)):
        mine = sorted((r for r in recs if r["pid"] == pid),
                      key=lambda r: r["step"])
        want = pipe_launches(cfg, stage)
        prev = {k: 0 for k in want}
        steps = []
        for r in mine:
            steps.append({k: r["launches"][k] - prev[k] for k in want})
            prev = r["launches"]
        if steps != [want] * PIPE_STEPS:
            raise AssertionError(f"stage {stage} launched {steps} a step, "
                                 f"expected {want}")
        if on_card and (mine[0]["cuda_visible_devices"] == ""
                        or "H100" not in mine[0]["device"]
                        and not mine[0]["device"].startswith("NVIDIA")):
            raise AssertionError(f"stage {stage} saw {mine[0]}")
        per_step.append(want)
        stages.append({
            "pid": pid, "peak_mem_gib": mine[-1]["peak_mem_gib"],
            "device": mine[0]["device"],
            "cuda_visible_devices": mine[0]["cuda_visible_devices"],
            "launches_per_step": want,
            "launches": mine[-1]["launches"],
            "update_times": [r["t"] for r in mine]})
    # the last stage's updates end its steps; step 1's interval also
    # holds stage 0's first AdamW step (its state made) and the first
    # calls' set-up, so the p50 is of steps 2 on
    t_last = stages[-1]["update_times"]
    step_ms = [(b - a) * 1e3 for a, b in zip(t_last, t_last[1:])]
    n_parts = partition_layers(cfg.n_layers, PIPE_STAGES)
    out["pipeline"] = {
        "stages": PIPE_STAGES, "layers_per_stage": [c for _, c in n_parts],
        "microbatches": PIPE_MB, "steps": PIPE_STEPS, "fit_s": fit_s,
        "losses": losses, "reference_losses": ref_losses,
        "reference_s": ref_s, "bit_equal": losses == ref_losses,
        "loss_rel_err_max": ref_rel, "step0_rel_to_train": step0_rel,
        "train_step0_loss": trained["losses"][0],
        "step_ms": [round(t, 3) for t in step_ms],
        "step_ms_p50": statistics.median(step_ms[1:]),
        "train_step_ms_p50": trained.get("step_ms_p50"),
        "bubble_fraction": result.metrics.get("bubble_fraction",
                                              "not measured"),
        "channel_bytes_per_step": PIPE_MB * (2 * act_bytes + 2 * tok_bytes),
        "activation_bytes": act_bytes,
        "not_returned_gib": not_back,
        "stages_detail": [{k: v for k, v in s.items()
                           if k != "update_times"} for s in stages],
        "launches": [s["launches"] for s in stages]}
    log(f"pipeline (b) [{smi}]: {json.dumps(out['pipeline'])}")
    return out


# ---------------------------------------------------------------------
# Phase 13: RL. The chip machine has no gymnasium, so CartPole-v1 is
# written here in numpy and handed to the env runners as a callable.
# ---------------------------------------------------------------------
# Tolerances, set from the arithmetic before any run:
#  * a learner on the card against one on the CPU (f32, TF32 off, the
#    same weights, batch and permutations): matmuls, convs and sums
#    accumulate in other orders, a few f32 ulps a step; over the 32
#    Adam steps of an update a parameter moves by at most lr (3e-4) a
#    step, scaled by m / sqrt(v), so rounding differences stay orders
#    below 1e-5 where the loss is smooth in the parameters (the tanh
#    MLP; the conv module in float64, whose ReLU inputs do not round
#    across 0); a metric within 1e-4 of (1 + |m|), as the JAX dp case
#    holds its metrics.
#  * the conv module's logits and values, card against CPU (f32, TF32
#    off): each is ~5 dot products deep, the longest of 3,136 terms;
#    their rounding is ~1e-6 of outputs of order 1.
TOL.update({"rl_metric_rel": 1e-4, "rl_param_abs": 1e-5,
            "rl_forward_abs": 1e-5})
RL_GATE_RETURN, RL_GATE_ITERS = 450.0, 250    # tests/test_rllib.py:368
RL_RUNTIME_ITERS, RL_MA_ITERS = 20, 5


class Discrete:
    """gymnasium.spaces.Discrete's `n`, all the runners read."""

    def __init__(self, n: int):
        self.n = n


class Box:
    """gymnasium.spaces.Box's `low`, `high` and `shape`."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)
        self.shape = self.low.shape


class CartPoleVec:
    """CartPole-v1 as a vector env in numpy, with gymnasium's vector API.

    Gymnasium's dynamics (`envs/classic_control/cartpole.py`: Euler
    steps of 0.02 s, ±10 N, termination at |x| > 2.4 or |θ| > 12°), its
    500-step truncation, its seeding (env i of `reset(seed=s)` draws from
    `Generator(PCG64(SeedSequence(s + i)))`, the state from
    `uniform(-0.05, 0.05, 4)`) and its next-step autoreset: the step
    after an episode ends resets that env, with reward 0 and neither
    flag set."""

    gravity, masscart, masspole = 9.8, 1.0, 0.1
    total_mass = masspole + masscart
    length = 0.5
    polemass_length = masspole * length
    force_mag, tau = 10.0, 0.02
    theta_threshold = 12 * 2 * np.pi / 360
    x_threshold = 2.4
    max_episode_steps = 500

    def __init__(self, num_envs: int):
        self.num_envs = num_envs
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold * 2, np.inf], np.float32)
        self.single_observation_space = Box(-high, high)
        self.single_action_space = Discrete(2)
        self._rngs = [np.random.default_rng() for _ in range(num_envs)]
        self.state = np.zeros((num_envs, 4))
        self.steps = np.zeros(num_envs, np.int64)
        self._autoreset = np.zeros(num_envs, bool)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rngs = [np.random.Generator(np.random.PCG64(
                np.random.SeedSequence(seed + i)))
                for i in range(self.num_envs)]
        self.state = np.stack([r.uniform(-0.05, 0.05, 4)
                               for r in self._rngs])
        self.steps[:] = 0
        self._autoreset[:] = False
        return self.state.astype(np.float32), {}

    def step(self, actions):
        x, x_dot, theta, theta_dot = self.state.T
        force = np.where(np.asarray(actions) == 1, self.force_mag,
                         -self.force_mag)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole
                           * np.square(costheta) / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        state = np.stack([x + self.tau * x_dot, x_dot + self.tau * xacc,
                          theta + self.tau * theta_dot,
                          theta_dot + self.tau * thetaacc], axis=1)
        terminated = ((state[:, 0] < -self.x_threshold)
                      | (state[:, 0] > self.x_threshold)
                      | (state[:, 2] < -self.theta_threshold)
                      | (state[:, 2] > self.theta_threshold))
        self.steps += 1
        truncated = self.steps >= self.max_episode_steps
        reward = np.ones(self.num_envs)
        for i in np.nonzero(self._autoreset)[0]:
            state[i] = self._rngs[i].uniform(-0.05, 0.05, 4)
        reset = self._autoreset
        self.steps[reset] = 0
        terminated[reset] = truncated[reset] = False
        reward[reset] = 0.0
        self.state = state
        self._autoreset = terminated | truncated
        return state.astype(np.float32), reward, terminated, truncated, {}

    def close(self) -> None:
        pass


class PendulumVec:
    """Pendulum-v1 as a vector env in numpy, with gymnasium's vector API.

    Gymnasium's dynamics (`envs/classic_control/pendulum.py`: g 10, m 1,
    l 1, dt 0.05, torque clipped to ±2, speed to ±8, the cost on the
    normalised angle, the speed and the torque, in numpy's dtypes: the
    torque stays float32), its 200-step truncation (it never
    terminates), its seeding (env i of `reset(seed=s)` draws from
    `Generator(PCG64(SeedSequence(s + i)))`, the state from
    `uniform([-π, -1], [π, 1])`) and its next-step autoreset."""

    max_speed, max_torque, dt, g, m, l = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0
    max_episode_steps = 200

    def __init__(self, num_envs: int):
        self.num_envs = num_envs
        high = np.array([1.0, 1.0, self.max_speed], np.float32)
        self.single_observation_space = Box(-high, high)
        self.single_action_space = Box([-self.max_torque], [self.max_torque])
        self._rngs = [np.random.default_rng() for _ in range(num_envs)]
        self.state = np.zeros((num_envs, 2))
        self.steps = np.zeros(num_envs, np.int64)
        self._autoreset = np.zeros(num_envs, bool)

    def _draw(self, i: int) -> np.ndarray:
        high = np.array([np.pi, 1.0])
        return self._rngs[i].uniform(low=-high, high=high)

    def _obs(self) -> np.ndarray:
        # per env, on numpy scalars: numpy's vectorised sin and cos may
        # differ from its scalar ones by an ulp
        return np.array([[np.cos(th), np.sin(th), thdot]
                         for th, thdot in self.state], np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rngs = [np.random.Generator(np.random.PCG64(
                np.random.SeedSequence(seed + i)))
                for i in range(self.num_envs)]
        self.state = np.stack([self._draw(i) for i in range(self.num_envs)])
        self.steps[:] = 0
        self._autoreset[:] = False
        return self._obs(), {}

    def step(self, actions):
        u = np.clip(np.asarray(actions), -self.max_torque,
                    self.max_torque)[:, 0]
        state = np.empty_like(self.state)
        reward = np.empty(self.num_envs)
        g, m, l, dt = self.g, self.m, self.l, self.dt
        for i, ((th, thdot), u_i) in enumerate(zip(self.state, u)):
            norm = ((th + np.pi) % (2 * np.pi)) - np.pi
            reward[i] = -(norm ** 2 + 0.1 * thdot ** 2 + 0.001 * (u_i ** 2))
            newthdot = thdot + (3 * g / (2 * l) * np.sin(th)
                                + 3.0 / (m * l ** 2) * u_i) * dt
            newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
            state[i] = (th + newthdot * dt, newthdot)
        self.steps += 1
        truncated = self.steps >= self.max_episode_steps
        terminated = np.zeros(self.num_envs, bool)
        for i in np.nonzero(self._autoreset)[0]:
            state[i] = self._draw(i)
        reset = self._autoreset
        self.steps[reset] = 0
        truncated[reset] = False
        reward[reset] = 0.0
        self.state = state
        self._autoreset = truncated.copy()
        return self._obs(), reward, terminated, truncated, {}

    def close(self) -> None:
        pass


def pendulum_envs(num_envs: int) -> PendulumVec:
    """The env callable for Pendulum-v1 (as `cartpole_envs`)."""
    return PendulumVec(num_envs)


def cartpole_envs(num_envs: int) -> CartPoleVec:
    """The env callable of `EnvRunnerConfig.env` (a module-level function
    of `this_module()`, so it pickles by reference to runner actors)."""
    return CartPoleVec(num_envs)


class TwoCartPoles:
    """Two independent numpy CartPoles as one 2-agent env (the JAX
    test's `_TwoCartPoles`, tests/test_rllib.py:575, without gymnasium)."""

    agents = ("a0", "a1")

    def __init__(self):
        self._envs = {a: CartPoleVec(1) for a in self.agents}
        self._done = {a: False for a in self.agents}

    def reset(self, *, seed=None):
        obs = {}
        for i, a in enumerate(self.agents):
            o, _ = self._envs[a].reset(
                seed=None if seed is None else seed + i)
            obs[a] = o[0]
            self._done[a] = False
        return obs, {}

    def step(self, actions):
        obs, rew, term, trunc = {}, {}, {}, {}
        for a in self.agents:
            if self._done[a]:
                obs[a] = np.zeros(4, np.float32)
                rew[a], term[a], trunc[a] = 0.0, True, False
                continue
            o, r, te, tr, _ = self._envs[a].step(np.array([actions[a]]))
            obs[a], rew[a] = o[0], float(r[0])
            term[a], trunc[a] = bool(te[0]), bool(tr[0])
            if te[0] or tr[0]:
                self._done[a] = True
        term["__all__"] = all(self._done.values())
        trunc["__all__"] = False
        return obs, rew, term, trunc, {}

    def close(self) -> None:
        pass


def rl_toy_batch(T=16, N=8, D=4, A=2, seed=0) -> dict:
    """tests/test_rllib.py's `_toy_batch`."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(T + 1, N, D)).astype(np.float32),
        "actions": rng.integers(0, A, (T, N)).astype(np.int32),
        "logp": np.log(np.full((T, N), 1.0 / A, np.float32)),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "terminateds": np.zeros((T, N), np.float32),
        "dones": np.zeros((T, N), np.float32),
        "mask": np.ones((T, N), np.float32),
    }


def rl_pixel_batch(T: int, N: int, obs_shape=(84, 84, 4), A: int = 6,
                   seed: int = 0) -> dict:
    """A seeded uint8 pixel batch with masked filler steps after dones."""
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.05).astype(np.float32)
    mask = np.ones((T, N), np.float32)
    mask[1:] = 1.0 - dones[:-1]
    return {
        "obs": rng.integers(0, 256, (T + 1, N) + tuple(obs_shape),
                            dtype=np.uint8),
        "actions": rng.integers(0, A, (T, N)).astype(np.int32),
        "logp": np.log(np.full((T, N), 1.0 / A, np.float32)),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "terminateds": dones.copy(),
        "dones": dones,
        "mask": mask,
    }


def rl_pair(dev, cfg, module_fn=None) -> tuple:
    """A learner on the card and one on the CPU from the same config:
    both draw their weights on the CPU from `cfg.seed`."""
    from ray_tpu_torch.rllib.core.learner import PPOLearner
    learners = []
    for d in (dev, torch.device("cpu")):
        c = dataclasses.replace(cfg, device=str(d))
        learners.append(PPOLearner(c, module=module_fn() if module_fn
                                   else None))
    return tuple(learners)


def rl_on_device(learner, dev) -> None:
    """Every parameter and optimizer state tensor on `dev`'s type."""
    tensors = list(learner.module.parameters())
    for st in learner._opt.state.values():
        tensors += [v for k, v in st.items() if k != "step"]
    where = {t.device.type for t in tensors}
    if where != {dev.type}:
        raise AssertionError(f"learner state on {where}, not {dev.type}")


_RL_CONV_MODES = ("deterministic", "default", "no_cudnn")


@contextlib.contextmanager
def rl_f32(conv: str = "deterministic"):
    """The card's numerics for a comparison with the CPU: TF32 off and,
    by `conv`, cuDNN held to its deterministic algorithms
    ("deterministic"), left to its heuristics ("default"), or bypassed
    for the native im2col + GEMM convolution ("no_cudnn")."""
    if conv not in _RL_CONV_MODES:
        raise ValueError(f"conv mode {conv!r} not in {_RL_CONV_MODES}")
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.enabled)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic = conv == "deterministic"
    b.cudnn.benchmark = False
    b.cudnn.enabled = conv != "no_cudnn"
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark, b.cudnn.enabled) = saved


def rl_as(batch: dict, dtype) -> dict:
    """`batch` with its float arrays in `dtype` (integer ones kept)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return {k: v.astype(np_dtype) if np.issubdtype(v.dtype, np.floating)
            else v for k, v in batch.items()}


def rl_conv_module(dtype=torch.float32):
    """`rl_phase` (d)'s module: ConvActorCriticModule at its defaults, its
    parameters in `dtype`."""
    from ray_tpu_torch.rllib.core.rl_module import ConvActorCriticModule
    return ConvActorCriticModule((84, 84, 4), 6).to(dtype)


def rl_diff(card, cpu, batch, conv: str = "deterministic") -> tuple:
    """One update on both learners under `rl_f32(conv)`: the CPU's
    metrics, each metric's error relative to 1 + |m|, each parameter's
    largest absolute error."""
    with rl_f32(conv):
        m_card, m_cpu = card.update(batch), cpu.update(batch)
    metric = {k: abs(m_card[k] - v) / (1 + abs(v))
              for k, v in m_cpu.items() if k != "update_time_s"}
    w_card, w_cpu = card.get_weights(), cpu.get_weights()
    param = {k: float((w_card[k] - w_cpu[k]).abs().max()) for k in w_cpu}
    return m_cpu, metric, param


def rl_compare(card, cpu, batch, what: str) -> dict:
    """One update on both learners: every metric within
    TOL["rl_metric_rel"] × (1 + |m|), every parameter within
    TOL["rl_param_abs"]. TF32 off and cuDNN's deterministic algorithms
    for the comparison (`rl_f32`)."""
    m_cpu, metric, param = rl_diff(card, cpu, batch)
    for k, rel in metric.items():
        if not rel <= TOL["rl_metric_rel"]:
            raise AssertionError(f"rl {what}: {k} differs by {rel} "
                                 f"(cpu {m_cpu[k]})")
    worst = max(param, key=param.get)
    if not param[worst] <= TOL["rl_param_abs"]:
        raise AssertionError(f"rl {what}: parameters differ by "
                             f"{param[worst]} ({worst})")
    rl_on_device(card, card.device)
    return {"metric_rel_err": max(metric.values()),
            "param_max_abs_err": param[worst], "kl": m_cpu["kl"]}


def rl_forward_gap(card, cpu, obs: np.ndarray) -> float:
    """The largest gap between the card's and the CPU's logits and values
    on `obs` (TF32 off, cuDNN deterministic), checked against
    TOL["rl_forward_abs"]. The ReLUs are continuous, so a pre-activation
    that rounds to the other side of 0 moves the outputs by its own
    rounding only."""
    outs = []
    for ln in (card, cpu):
        with rl_f32(), torch.no_grad():
            outs.append([t.cpu() for t in ln.module(
                torch.as_tensor(obs, device=ln.device))])
    gap = max(float((a - b).abs().max()) for a, b in zip(*outs))
    if not gap <= TOL["rl_forward_abs"]:
        raise AssertionError(f"rl conv module: the forward differs by {gap}")
    return gap


def rl_conv_parity_runs(dev, repeats: int = 3, modes=_RL_CONV_MODES,
                        dtype=torch.float32) -> list:
    """`rl_phase` (d)'s update, card against CPU at T 16 × N 8 with the
    parameters in `dtype`, `repeats` times from fresh learners under each
    `rl_f32` mode: each run's worst parameter and the parameters over
    TOL["rl_param_abs"], then the gap between the card learners of a
    mode's first two runs (0 when the card repeats its bits). Not run by
    `main()`."""
    from ray_tpu_torch.rllib import PPOLearnerConfig
    cfg = PPOLearnerConfig(num_actions=6, seed=0)
    batch = rl_as(rl_pixel_batch(16, 8), dtype)
    runs = []
    for mode in modes:
        weights = []
        for r in range(repeats):
            card, cpu = rl_pair(dev, cfg, lambda: rl_conv_module(dtype))
            _, metric, param = rl_diff(card, cpu, batch, mode)
            worst = max(param, key=param.get)
            runs.append({"mode": mode, "dtype": str(dtype), "repeat": r,
                         "metric_rel_err": max(metric.values()),
                         "param_max_abs_err": param[worst], "worst": worst,
                         "over_tol": sorted(k for k, v in param.items()
                                            if v > TOL["rl_param_abs"])})
            weights.append(card.get_weights())
            log("rl conv parity: " + json.dumps(runs[-1]))
            del card, cpu
        if len(weights) > 1:
            runs.append({"mode": mode, "dtype": str(dtype),
                         "card_vs_card_max_abs": max(
                             float((weights[0][k] - weights[1][k])
                                   .abs().max()) for k in weights[0])})
            log("rl conv parity: " + json.dumps(runs[-1]))
    return runs


def rl_update_trace(learner, batch, conv: str) -> list:
    """One update of `learner` on `batch` under `rl_f32(conv)`, with,
    for each minibatch it runs, its parameters before the step, the
    step's ratios, its convolutions' outputs before their ReLUs, and the
    gradients and their global norm before the clip. Not run by
    `main()`."""
    steps = []
    loss, clip = learner._loss, learner._clip_by_global_norm

    def traced_loss(mb, denom):
        pre = []
        hooks = [conv.register_forward_hook(
            lambda m, i, o: pre.append(o.detach().cpu()))
            for conv in getattr(learner.module, "conv", ())]
        try:
            with torch.no_grad():
                logits, _ = learner.module(mb["obs"])
                logp = learner.module.dist_log_prob(logits, mb["actions"])
        finally:
            for h in hooks:
                h.remove()
        steps.append({"params": [p.detach().cpu().clone()
                                 for p in learner.module.parameters()],
                      "ratio": torch.exp(logp - mb["logp"]).cpu(),
                      "pre_relu": pre})
        return loss(mb, denom)

    def traced_clip(grads):
        steps[-1]["grad_norm"] = float(torch.nn.utils.get_total_norm(grads))
        steps[-1]["grads"] = [g.detach().cpu().clone() for g in grads]
        return clip(grads)

    learner._loss, learner._clip_by_global_norm = traced_loss, traced_clip
    try:
        with rl_f32(conv):
            learner.update(batch)
    finally:
        del learner._loss, learner._clip_by_global_norm
    return steps


def rl_conv_divergence(dev, modes=("deterministic",),
                       dtype=torch.float32) -> list:
    """Where a card learner's update parts from the CPU learner's on
    `rl_phase` (d)'s parity batch, the parameters in `dtype`: for each of
    `modes` (a fresh card learner each), each minibatch step's largest
    parameter, ratio and gradient gaps, both gradient norms, the samples
    on the other side of the ratio clip, and the convolution outputs on
    the other side of their ReLU's 0 (with the largest CPU value among
    them). Not run by `main()`."""
    from ray_tpu_torch.rllib import PPOLearnerConfig
    cfg = PPOLearnerConfig(num_actions=6, seed=0)
    batch = rl_as(rl_pixel_batch(16, 8), dtype)
    cpu = rl_conv_learner(cfg, "cpu", dtype)
    ref = rl_update_trace(cpu, batch, "deterministic")
    out = []
    for mode in modes:
        got = rl_update_trace(rl_conv_learner(cfg, dev, dtype), batch, mode)
        rows = []
        for i, (g, h) in enumerate(zip(got, ref)):
            flips = [(x > 0) != (y > 0)
                     for x, y in zip(g["pre_relu"], h["pre_relu"])]
            rows.append({
                "step": i,
                "param_gap": max(float((p - q).abs().max())
                                 for p, q in zip(g["params"], h["params"])),
                "grad_gap": max(float((p - q).abs().max())
                                for p, q in zip(g["grads"], h["grads"]))
                if "grads" in g else None,
                "grad_norm": [g.get("grad_norm"), h.get("grad_norm")],
                "ratio_max_gap": float((g["ratio"] - h["ratio"]).abs().max()),
                "ratio_clip_flips": int(
                    (((g["ratio"] - 1).abs() > cfg.clip_eps)
                     != ((h["ratio"] - 1).abs() > cfg.clip_eps)).sum()),
                "relu_flips": [int(f.sum()) for f in flips],
                "cpu_pre_relu_at_flips_max": max(
                    [float(y[f].abs().max())
                     for f, y in zip(flips, h["pre_relu"]) if f.any()],
                    default=None)})
        out.append({"mode": mode, "dtype": str(dtype), "steps": rows})
        log("rl conv divergence: " + json.dumps(out[-1]))
    return out


def rl_conv_learner(cfg, device, dtype):
    """A PPOLearner on `device` over `rl_conv_module(dtype)`, from `cfg`."""
    from ray_tpu_torch.rllib import PPOLearner
    return PPOLearner(dataclasses.replace(cfg, device=str(device)),
                      module=rl_conv_module(dtype))


def rl_update_ms(learner, batch, repeats: int) -> float:
    """p50 of `repeats` updates on `batch` (each ends in a host read)."""
    times = []
    for _ in range(repeats):
        times.append(learner.update(batch)["update_time_s"] * 1e3)
    return statistics.median(times)


def rl_gate(algo) -> tuple:
    """Train `algo` until a mean return of RL_GATE_RETURN, or for
    RL_GATE_ITERS iterations: (best return, iterations, each one's
    metrics)."""
    best, hist = 0.0, []
    for _ in range(RL_GATE_ITERS):
        hist.append(algo.train())
        r = hist[-1].get("episode_return_mean", float("nan"))
        if r == r:
            best = max(best, r)
        if best >= RL_GATE_RETURN:
            break
    return best, len(hist), hist


def rl_gate_runs(seeds=(0,), devices=(None,)) -> list:
    """The gate of `rl_phase` (b) for each learner device (None: the
    card) and seed: iterations to the bar and the return curve, to tell
    the card's trajectory from the CPU's. Not run by `main()`."""
    from ray_tpu_torch.rllib import PPOConfig
    runs = []
    for device in devices:
        for seed in seeds:
            algo = PPOConfig().environment(cartpole_envs).training(
                seed=seed, device=device).build()
            t0 = time.perf_counter()
            try:
                best, its, hist = rl_gate(algo)
            finally:
                algo.stop()
            runs.append({"seed": seed, "device": device or "card",
                         "iterations": its, "best": best,
                         "wall_s": time.perf_counter() - t0,
                         "returns": [round(h["episode_return_mean"], 3)
                                     for h in hist],
                         "kl": [h["kl"] for h in hist]})
            log("rl gate: " + json.dumps({k: v for k, v in runs[-1].items()
                                          if k not in ("returns", "kl")}))
    return runs


def rl_weight_sums(weights: dict) -> list:
    return [checksum(torch.as_tensor(weights[k])) for k in sorted(weights)]


def rl_phase(dev, smi: str, device=None) -> dict:
    """Phase 13, RL: (a) a PPO learner on the card against one on the
    CPU, one update on the toy batch and one on a 64 × 32 CartPole batch
    from the env runner; (b) the PPO CartPole gate in process (PPOConfig
    defaults, seed 0, ≥ 450 within 250 iterations, the learner on the
    card), and the same update timed on a CPU learner; (c) PPO through
    the runtime: two CPU runner actors and one learner actor holding
    `GPU: 1`, the runners' weights equal to the learner's after every
    sync, a rising mean return, the card's memory back after stop();
    (d) ConvActorCriticModule at its defaults (84 × 84 × 4, the Atari
    conv stack, hidden 256) through PPOLearner(module=...): card against
    CPU at T 16 × N 8, the update in float64 and the forward in float32,
    then the card's update ms and peak at T 64 × N 32;
    (e) MultiAgentPPO with two policies on TwoCartPoles, both learners on
    the card and both policies' returns finite. `device` is the
    algorithms' (None: the card, their default; a CPU rehearsal passes
    "cpu")."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import (EnvRunnerConfig, PPOConfig, PPOLearner,
                                     PPOLearnerConfig, SingleAgentEnvRunner)
    from ray_tpu_torch.rllib.env.multi_agent import (MultiAgentPPOConfig,
                                                     PolicySpec)
    t_phase = time.perf_counter()
    out = {"device": torch.cuda.get_device_name(0), "smi": smi}
    defaults = PPOConfig()

    # (a) parity, card against CPU, at PPOConfig's learner settings
    cfg = PPOLearnerConfig(
        obs_dim=4, num_actions=2, hidden=tuple(defaults.hidden),
        num_epochs=defaults.num_epochs,
        num_minibatches=defaults.num_minibatches,
        target_kl=defaults.target_kl, seed=0)
    card, cpu = rl_pair(dev, cfg)
    parity = {"toy": rl_compare(card, cpu, rl_toy_batch(), "toy batch")}
    runner = SingleAgentEnvRunner(EnvRunnerConfig(
        env=cartpole_envs, num_envs=defaults.num_envs_per_env_runner,
        rollout_length=defaults.rollout_length, seed=0))
    runner.set_weights(cpu.get_weights())
    cart_batch = runner.sample()
    runner.stop()
    parity["cartpole_64x32"] = rl_compare(card, cpu, cart_batch,
                                          "CartPole batch")
    out["parity"] = parity
    log(f"rl (a) [{smi}]: {json.dumps(parity)}")
    del card, cpu

    # (b) the PPO gate on the card, in process
    algo = PPOConfig().environment(cartpole_envs).training(
        seed=0, device=device).build()
    rl_on_device(algo.learner_group._local, dev)
    t0 = time.perf_counter()
    try:
        best, its, hist = rl_gate(algo)
        gate_s = time.perf_counter() - t0
        rl_on_device(algo.learner_group._local, dev)
        batch = algo.env_runner_group._local.sample()
        card_learner = algo.learner_group._local
        cpu_learner = PPOLearner(dataclasses.replace(card_learner.config,
                                                     device="cpu"))
        cpu_learner.set_state(card_learner.get_state())
        update_card = rl_update_ms(card_learner, batch, 10)
        update_cpu = rl_update_ms(cpu_learner, batch, 10)
    finally:
        algo.stop()
    gate = {
        "passed": best >= RL_GATE_RETURN, "best_return": best,
        "iterations": its, "wall_s": gate_s,
        "sample_ms_p50": statistics.median(
            h["time_sample_s"] * 1e3 for h in hist),
        "update_ms_p50": statistics.median(
            h["time_update_s"] * 1e3 for h in hist),
        "env_steps_per_s_p50": statistics.median(
            float(h["env_steps_per_s"]) for h in hist),
        "env_steps": hist[-1]["num_env_steps_sampled_lifetime"],
        "return_every_10": [round(h["episode_return_mean"], 1)
                            for h in hist[::10]],
        "update_ms_card_p50_after": update_card,
        "update_ms_cpu_p50_after": update_cpu,
        "cpu_threads": torch.get_num_threads(),
    }
    out["gate"] = gate
    log(f"rl (b) [{smi}]: {json.dumps(gate)}")
    if not gate["passed"]:
        raise AssertionError(f"PPO failed the CartPole gate on the card: "
                             f"best {best} in {its} iterations")

    # (c) through the runtime: CPU runner actors, a GPU learner actor
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    try:
        algo = PPOConfig().environment(this_module().cartpole_envs) \
            .env_runners(num_env_runners=2).resources(num_learners=1) \
            .training(seed=0, device=device).build()
        grp = algo.env_runner_group
        sync_ms = []
        sync_weights = grp.sync_weights

        def timed_sync(weights):
            t = time.perf_counter()
            sync_weights(weights)
            sync_ms.append((time.perf_counter() - t) * 1e3)
        grp.sync_weights = timed_sync
        returns, iters, t0 = [], [], time.perf_counter()
        try:
            for _ in range(RL_RUNTIME_ITERS):
                t = time.perf_counter()
                m = algo.train()
                iters.append({"iteration_ms": (time.perf_counter() - t) * 1e3,
                              "sample_ms": m["time_sample_s"] * 1e3,
                              "update_ms": m["time_update_s"] * 1e3,
                              "sync_ms": sync_ms[-1]})
                returns.append(m["episode_return_mean"])
                want = rl_weight_sums(algo.learner_group.get_weights())
                got = [rl_weight_sums(w) for w in
                       grp.manager.foreach_actor("get_weights").values()]
                if len(got) != 2 or any(g != want for g in got):
                    raise AssertionError("rl (c): a runner's weights differ "
                                         "from the learner's after a sync")
            wall = time.perf_counter() - t0
        finally:
            algo.stop()
    finally:
        ray_tpu_torch.shutdown()
    if not max(returns[-5:]) > returns[0]:
        raise AssertionError(f"rl (c): the mean return did not rise: "
                             f"{returns}")
    out["runtime"] = {
        "iterations": RL_RUNTIME_ITERS, "wall_s": wall,
        "return_first": returns[0], "return_last": returns[-1],
        "return_max": max(returns),
        **{f"{k}_p50": statistics.median(i[k] for i in iters)
           for k in ("iteration_ms", "sample_ms", "update_ms", "sync_ms")},
        "not_returned_gib": memory_back(free0)}
    log(f"rl (c) [{smi}]: {json.dumps(out['runtime'])}")

    # (d) the conv module at its defaults. Its update is held to the
    # CPU's in float64: in float32 a ReLU input that rounds to the other
    # side of 0 on one device switches a unit's gradient, and Adam
    # carries that past TOL["rl_param_abs"] (`rl_conv_divergence`). In
    # float32 the forward is held and the update's gap recorded.
    conv_cfg = PPOLearnerConfig(num_actions=6, seed=0)
    parity_batch = rl_pixel_batch(16, 8)
    card, cpu = rl_pair(dev, conv_cfg, lambda: rl_conv_module(torch.float64))
    conv = {"parity_16x8_f64": rl_compare(
        card, cpu, rl_as(parity_batch, torch.float64),
        "conv module (float64)")}
    del card, cpu
    card, cpu = rl_pair(dev, conv_cfg, rl_conv_module)
    rl_on_device(card, dev)
    conv["params"] = sum(p.numel() for p in card.module.parameters())
    conv["forward_16x8_f32_max_abs_err"] = rl_forward_gap(
        card, cpu, parity_batch["obs"])
    _, metric, param = rl_diff(card, cpu, parity_batch)
    conv["update_16x8_f32_gap"] = {
        "metric_rel_err": max(metric.values()),
        "param_max_abs_err": max(param.values())}
    del cpu
    big = rl_pixel_batch(64, 32, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv["update_ms_64x32_p50"] = rl_update_ms(card, big, 5)
    conv["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["conv"] = conv
    log(f"rl (d) [{smi}]: {json.dumps(conv)}")
    del card, big
    gc.collect()
    torch.cuda.empty_cache()

    # (e) multi-agent PPO, two policies, both learners on the card
    ma = MultiAgentPPOConfig(
        env_fn=TwoCartPoles,
        policies={"p0": PolicySpec(4, 2), "p1": PolicySpec(4, 2)},
        policy_mapping_fn=lambda a: "p0" if a == "a0" else "p1",
        num_envs_per_env_runner=16, rollout_length=64, seed=0,
        device=device).build()
    try:
        for ln in ma.learners.values():
            rl_on_device(ln, dev)
        for _ in range(RL_MA_ITERS):
            m = ma.train()
        rets = {pid: m[f"episode_return_mean/policy/{pid}"]
                for pid in ("p0", "p1")}
    finally:
        ma.stop()
    if not all(np.isfinite(v) for v in rets.values()):
        raise AssertionError(f"rl (e): returns {rets}")
    out["multi_agent"] = {"iterations": RL_MA_ITERS, "returns": rets,
                          "iteration_ms_last": m["time_iteration_s"] * 1e3}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"rl: {json.dumps(out)}")
    return out


# ------------------------------------------------- RL algorithms (phase 14)
# Iterations and sizes of rl_algos_phase: the JAX tests' own configs
# (tests/test_rllib.py:387-417, :839-869, :795-833; test_sebulba.py:253)
RL_IMPALA_RETURN, RL_IMPALA_ITERS, RL_IMPALA_SEEDS = 450.0, 200, (1, 7)
RL_DREAMER_ITERS = 12
RL_DQN_ITERS, RL_SAC_ITERS = 10, 6
RL_SEBULBA_ITERS = 2


def rl_double(obj) -> None:
    """Every module and floating tensor attribute of `obj` in float64, in
    place (before any optimizer step: Adam makes its state lazily)."""
    for v in vars(obj).values():
        if isinstance(v, torch.nn.Module):
            v.double()
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            v.data = v.data.double()


def rl_tensors(obj) -> dict:
    """Every parameter, buffer and floating tensor attribute of `obj`
    (its public attributes: acting state such as DreamerV3's carried
    (h, z) is private), by attribute and name, on its device."""
    out = {}
    for name, v in vars(obj).items():
        if name.startswith("_"):
            continue
        if isinstance(v, torch.nn.Module):
            out.update({f"{name}.{k}": t for k, t in v.state_dict().items()})
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out[name] = v.detach()
    return out


def rl_state_on(obj, dev) -> None:
    """Every tensor of `obj` (`rl_tensors`) and of its optimizers' state
    on `dev`'s type."""
    tensors = list(rl_tensors(obj).values())
    for v in vars(obj).values():
        opts = v if isinstance(v, list) else [v]
        for o in opts:
            if isinstance(o, torch.optim.Optimizer):
                for st in o.state.values():
                    tensors += [x for k, x in st.items() if k != "step"]
    where = {t.device.type for t in tensors}
    if where != {dev.type}:
        raise AssertionError(f"learner state on {where}, not {dev.type}")


def rl_to(x, dev):
    """`x` (a tensor, or a nest of them with Nones) on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: rl_to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(rl_to(v, dev) for v in x)
    return x


def rl_heuristic_cartpole(obs: np.ndarray) -> np.ndarray:
    """tests/test_connectors_offline.py's expert: angle + velocity."""
    return (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int32)


def rl_algo_specs(tmp: str) -> list:
    """(a)'s learners: name, f64 (its card update held to the CPU in
    float64, its f32 forward to TOL["rl_forward_abs"]), make(device) ->
    learner from a fixed seed (weights drawn on the CPU), inputs(cpu
    learner) -> the update's host inputs (batch and draws), step(learner,
    inputs, dev) -> metrics, forward(learner, inputs, dev) -> tensors."""
    from ray_tpu_torch.rllib.algorithms import (APPOLearner, DQNConfig,
                                                DreamerV3Config, IMPALAConfig,
                                                IMPALALearner,
                                                IMPALALearnerConfig,
                                                SACConfig)
    from ray_tpu_torch.rllib.algorithms.appo import APPOLearnerConfig
    from ray_tpu_torch.rllib.algorithms.sac import METRICS as SAC_METRICS
    from ray_tpu_torch.rllib.env.env_runner import (EnvRunnerConfig,
                                                    SingleAgentEnvRunner)
    from ray_tpu_torch.rllib.offline import (BCConfig, CQLConfig,
                                             MARWILConfig, _load_transitions,
                                             record_transitions)
    impala = IMPALAConfig()
    runner = SingleAgentEnvRunner(EnvRunnerConfig(
        env=cartpole_envs, num_envs=8, rollout_length=32, seed=0))
    vtrace_batch = runner.sample()
    runner.stop()
    path = record_transitions(cartpole_envs, rl_heuristic_cartpole,
                              os.path.join(tmp, "expert"), num_steps=2000,
                              seed=1)
    obs, actions, rewards, new_obs, terms, _ = _load_transitions(path)
    rows = np.random.default_rng(0).integers(0, len(obs), 256)
    offline = (obs[rows], actions[rows].astype(np.int32), rewards[rows],
               new_obs[rows], terms[rows])

    def learner(cls, cfg_cls, **kw):
        return lambda d: cls(cfg_cls(
            obs_dim=4, num_actions=2, hidden=tuple(impala.hidden),
            lr=impala.lr, max_grad_norm=impala.max_grad_norm, seed=0,
            device=str(d), **kw))

    def v_step(ln, inp, dev):
        return {k: v for k, v in ln.update(inp).items()
                if k != "update_time_s"}

    def v_forward(ln, inp, dev):
        return list(ln.module(torch.as_tensor(inp["obs"], device=dev)))

    def dqn_inputs(algo):
        b = algo._runners[0].sample(algo.config.rollout_steps_per_iteration)
        algo.buffer.add(b)
        return algo.buffer.sample(algo.config.train_batch_size), \
            algo.draw_noise()

    def dqn_step(algo, inp, dev):
        loss, td = algo._update(inp[0], rl_to(inp[1], dev))
        return {"loss": float(loss), "td_abs_sum": float(td.sum())}

    def dqn_forward(algo, inp, dev):
        # the network's outputs: Q, or C51's logits (its Q, their
        # softmax's mean over a support up to v_max = 200, sits where an
        # f32 ulp is 7.6e-6)
        m = algo.module
        obs = torch.as_tensor(inp[0]["obs"], device=dev).to(
            m.q[0].weight.dtype)
        with torch.no_grad():
            return [m.forward_dist(obs) if m.num_atoms > 1 else m(obs)]

    def sac_inputs(algo):
        b = algo._runners[0].sample(algo.config.rollout_steps_per_iteration)
        return b, algo.draw_noise(len(b["rewards"]))

    def sac_step(algo, inp, dev):
        return dict(zip(SAC_METRICS, algo._update(
            inp[0], inp[1].to(dev)).tolist()))

    def sac_forward(algo, inp, dev):
        m = algo.module
        obs = torch.as_tensor(inp[0]["obs"], device=dev)
        act = torch.as_tensor(inp[0]["actions"], device=dev)
        with torch.no_grad():
            return [*m.pi_dist(obs), m.q("q1", obs, act), m.q("q2", obs, act)]

    def dreamer_inputs(algo):
        b = algo._sample()
        return b, algo.draw(*b["actions"].shape)

    def dreamer_step(algo, inp, dev):
        stats = algo._update(inp[0], rl_to(inp[1], dev))
        return {k: float(v) for k, v in stats.items()}

    def dreamer_forward(algo, inp, dev):
        g = torch.Generator().manual_seed(3)
        feat = torch.randn((64, algo.feat_dim), generator=g).to(dev)
        h = torch.randn((64, algo.config.deter_dim), generator=g).to(dev)
        x = torch.randn((64, algo.z_dim + algo.num_actions),
                        generator=g).to(dev)
        from ray_tpu_torch.rllib.algorithms.dreamerv3 import _mlp
        with torch.no_grad():
            return [_mlp(algo.actor, feat), _mlp(algo.critic, feat),
                    algo.wm.gru(h, x)]

    def offline_step(args):
        def step(algo, inp, dev):
            out = algo._update(*[inp[i] for i in args])
            return {f"m{i}": v for i, v in enumerate(
                out.reshape(-1).tolist())}
        return step

    def offline_forward(algo, inp, dev):
        with torch.no_grad():
            out = algo.module(torch.as_tensor(inp[0], device=dev))
        return list(out) if isinstance(out, tuple) else [out]

    dqn = dict(env=cartpole_envs, seed=0)
    c51 = dict(dqn, num_atoms=51, v_min=0.0, v_max=200.0, dueling=True,
               noisy=True, n_step=3)
    dreamer = dict(env=cartpole_envs, num_envs=8, rollout_length=32,
                   num_updates_per_iteration=8, units=64, deter_dim=64,
                   embed_dim=32, actor_lr=3e-3, critic_lr=1e-3, wm_lr=6e-4,
                   ent_coef=1e-3, imag_starts=192, seed=0)
    offline_cfg = dict(env=cartpole_envs, input_path=path, seed=0)
    return [
        dict(name="impala", f64=False,
             make=learner(IMPALALearner, IMPALALearnerConfig),
             inputs=lambda ln: vtrace_batch, step=v_step, forward=v_forward),
        dict(name="appo", f64=False,
             make=learner(APPOLearner, APPOLearnerConfig),
             inputs=lambda ln: vtrace_batch, step=v_step, forward=v_forward),
        dict(name="dqn", f64=True,
             make=lambda d: DQNConfig(**dqn, device=str(d)).build(),
             inputs=dqn_inputs, step=dqn_step, forward=dqn_forward),
        dict(name="dqn_c51_dueling_noisy", f64=True,
             make=lambda d: DQNConfig(**c51, device=str(d)).build(),
             inputs=dqn_inputs, step=dqn_step, forward=dqn_forward),
        dict(name="sac", f64=True,
             make=lambda d: SACConfig(env=pendulum_envs, seed=0,
                                      device=str(d)).build(),
             inputs=sac_inputs, step=sac_step, forward=sac_forward),
        dict(name="dreamerv3", f64=True,
             make=lambda d: DreamerV3Config(**dreamer,
                                            device=str(d)).build(),
             inputs=dreamer_inputs, step=dreamer_step,
             forward=dreamer_forward),
        dict(name="bc", f64=False,
             make=lambda d: BCConfig(**offline_cfg, device=str(d)).build(),
             inputs=lambda a: offline, step=offline_step((0, 1)),
             forward=offline_forward),
        dict(name="marwil", f64=False,
             make=lambda d: MARWILConfig(**offline_cfg,
                                         device=str(d)).build(),
             inputs=lambda a: (offline[0], offline[1], a._rtg[rows]),
             step=offline_step((0, 1, 2)), forward=offline_forward),
        dict(name="cql", f64=True,
             make=lambda d: CQLConfig(**offline_cfg, device=str(d)).build(),
             inputs=lambda a: offline, step=offline_step((0, 1, 2, 3, 4)),
             forward=offline_forward),
    ]


def rl_stop(obj) -> None:
    stop = getattr(obj, "stop", None)
    if stop is not None:
        stop()


def rl_algo_parity(spec: dict, dev) -> dict:
    """(a) for one learner: one update on the card against one on the CPU
    from the same weights, inputs and draws (TF32 off; in float64 where
    `spec["f64"]`, its float32 forward then held to
    TOL["rl_forward_abs"]): every metric within TOL["rl_metric_rel"] ×
    (1 + |m|), every parameter within TOL["rl_param_abs"], the card
    learner's state and optimizer state on the card."""
    cpu_dev = torch.device("cpu")
    out = {"dtype": "float64" if spec["f64"] else "float32"}
    card, cpu = spec["make"](dev), spec["make"](cpu_dev)
    try:
        inputs = spec["inputs"](cpu)
        with rl_f32():
            fwd = [spec["forward"](ln, inputs, d)
                   for ln, d in ((card, dev), (cpu, cpu_dev))]
        out["forward_f32_max_abs_err"] = max(
            float((a.detach().cpu() - b.detach()).abs().max())
            for a, b in zip(*fwd))
        if not out["forward_f32_max_abs_err"] <= TOL["rl_forward_abs"]:
            raise AssertionError(f"rl algos (a) {spec['name']}: the f32 "
                                 f"forward differs by "
                                 f"{out['forward_f32_max_abs_err']}")
        if spec["f64"]:
            for ln in (card, cpu):
                rl_double(ln)
        with rl_f32():
            m_card = spec["step"](card, inputs, dev)
            m_cpu = spec["step"](cpu, inputs, cpu_dev)
        rel = {k: abs(m_card[k] - v) / (1 + abs(v)) for k, v in m_cpu.items()}
        w_card, w_cpu = rl_tensors(card), rl_tensors(cpu)
        param = {k: float((w_card[k].cpu() - v).abs().max())
                 for k, v in w_cpu.items()}
        worst_m = max(rel, key=rel.get)
        worst_p = max(param, key=param.get)
        if not rel[worst_m] <= TOL["rl_metric_rel"]:
            raise AssertionError(f"rl algos (a) {spec['name']}: {worst_m} "
                                 f"differs by {rel[worst_m]}")
        if not param[worst_p] <= TOL["rl_param_abs"]:
            raise AssertionError(f"rl algos (a) {spec['name']}: parameters "
                                 f"differ by {param[worst_p]} ({worst_p})")
        rl_state_on(card, dev)
        out.update(metric_rel_err=rel[worst_m], param_max_abs_err=param[worst_p],
                   params=sum(v.numel() for k, v in w_cpu.items()))
        return out
    finally:
        rl_stop(card)
        rl_stop(cpu)


def rl_update_card_cpu_ms(card, batch, repeats: int = 20) -> dict:
    """An IMPALA learner's update p50 on the card and on a CPU learner
    with the same state, same batch (each update ends in its host read of
    the metrics)."""
    from ray_tpu_torch.rllib.algorithms import IMPALALearner
    cpu = IMPALALearner(dataclasses.replace(card.config, device="cpu"))
    cpu.set_state(card.get_state())
    return {"update_ms_card_p50": rl_update_ms(card, batch, repeats),
            "update_ms_cpu_p50": rl_update_ms(cpu, batch, repeats)}


def rl_sync_ms(fn, repeats: int) -> float:
    """p50 of `repeats` calls of `fn`, each ended by a synchronize."""
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def rl_sebulba(dev, module_factory=None, num_inference: int = 2,
               inference_options=None, device=None) -> dict:
    """(c): Sebulba through the runtime: 4 env-runner actors on numpy
    CartPoles acting against `num_inference` inference actors (their
    forward in numpy, or `module_factory`'s), the learner on the card
    in this process; RL_SEBULBA_ITERS iterations of 8 updates. Asserts
    the updates counted, no shard sequence gap, staleness within
    (rl_ring_depth + 2) × runners, forwards ≤ requests."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib.sebulba import SebulbaConfig
    runners = 4
    cfg = SebulbaConfig(
        env=this_module().cartpole_envs, num_env_runners=runners,
        num_inference_actors=num_inference, num_envs_per_runner=4,
        rollout_length=8, num_updates_per_iteration=8, device=device,
        module_factory=module_factory,
        inference_options=inference_options)
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=runners + num_inference)
    try:
        t0 = time.perf_counter()
        tr = cfg.build()
        start_s = time.perf_counter() - t0
        publish_ms = []
        publish = tr._publish

        def timed_publish(force=False):
            t = time.perf_counter()
            publish(force)
            publish_ms.append((time.perf_counter() - t) * 1e3)
        tr._publish = timed_publish
        try:
            rl_state_on(tr.learner, dev)
            t0 = time.perf_counter()
            for _ in range(RL_SEBULBA_ITERS):
                m = tr.train()
            wall = time.perf_counter() - t0
            stats = ray_tpu_torch.get([h.stats.remote() for h in tr._infer])
        finally:
            tr.stop()
            del tr
    finally:
        ray_tpu_torch.shutdown()
    want = RL_SEBULBA_ITERS * cfg.num_updates_per_iteration
    bound = (CONFIG.rl_ring_depth + 2) * runners
    forwards = sum(s["forwards"] for s in stats)
    requests = sum(s["requests"] for s in stats)
    if m["num_learner_updates"] != want:
        raise AssertionError(f"sebulba: {m['num_learner_updates']} updates, "
                             f"not {want}")
    if m["seq_gaps"] != 0:
        raise AssertionError(f"sebulba: {m['seq_gaps']} shard gaps")
    if not m["staleness_max"] <= bound:
        raise AssertionError(f"sebulba: staleness {m['staleness_max']} > "
                             f"{bound}")
    if not 0 < forwards <= requests:
        raise AssertionError(f"sebulba: {forwards} forwards for {requests} "
                             f"requests")
    return {"start_s": start_s, "wall_s": wall,
            "updates": m["num_learner_updates"], "seq_gaps": m["seq_gaps"],
            "staleness_p50": m["staleness_p50"],
            "staleness_p95": m["staleness_p95"],
            "staleness_max": m["staleness_max"], "staleness_bound": bound,
            "publish_ms_p50": statistics.median(publish_ms),
            "publishes": len(publish_ms),
            "learner_transitions_per_s": m["env_steps_consumed"] / wall,
            "update_ms_last": m["update_time_s"] * 1e3,
            "forwards": forwards, "requests": requests,
            "policy_versions": [s["policy_version"] for s in stats],
            "not_returned_gib": memory_back(free0)}


def rl_algos_phase(dev, smi: str, device=None) -> dict:
    """Phase 14, the RL algorithms and Sebulba (`rllib/algorithms/`,
    `rllib/offline.py`, `rllib/sebulba/`), the learners on the card:
    (a) IMPALA, APPO, DQN (scalar; C51 + dueling + noisy with fixed
    noise), SAC, DreamerV3, BC, MARWIL and CQL: one update on the card
    against one on the CPU (`rl_algo_parity`); (b) the IMPALA CartPole
    gate of tests/test_rllib.py:387 through the runtime (4 runner actors
    × 8 CartPoleVec envs, rollout 32, lr 6e-4, 16 updates an iteration,
    seeds 1 then 7, a mean return of 450 within 200 iterations), its
    update timed on the card and on a CPU learner; (c) Sebulba through
    the runtime, with numpy inference actors and then one inference
    actor whose forward runs on the card (`TorchPolicy`); (d) the
    DreamerV3 gate of tests/test_rllib.py:839 and a get/set_state round
    trip; (e) DQN (C51 + dueling + noisy) on CartPoleVec and SAC on
    PendulumVec for fixed iterations: finite losses, the target networks
    moving, the update ms; (f) the card's memory back after every
    stop(). `device` is the algorithms' (None: the card)."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib.algorithms import (DQNConfig, DreamerV3Config,
                                                IMPALAConfig, SACConfig)
    from ray_tpu_torch.rllib.env.env_runner import (EnvRunnerConfig,
                                                    SingleAgentEnvRunner)
    from ray_tpu_torch.rllib.sebulba import TorchPolicy
    t_phase = time.perf_counter()
    out = {"device": torch.cuda.get_device_name(0), "smi": smi}

    def settle(what: str, free0: int) -> float:
        gc.collect()
        torch.cuda.empty_cache()
        held = memory_back(free0)
        out.setdefault("not_returned_gib", {})[what] = held
        return held

    # (a) every learner, card against CPU
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    tmp = tempfile.mkdtemp(prefix="rtt_rl_algos_")
    try:
        parity = {}
        for spec in rl_algo_specs(tmp):
            parity[spec["name"]] = rl_algo_parity(spec, dev)
            log(f"rl algos (a) {spec['name']} [{smi}]: "
                f"{json.dumps(parity[spec['name']])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["parity"] = parity
    settle("parity", free0)

    # (b) the IMPALA gate through the runtime, the learner on the card
    free0 = torch.cuda.mem_get_info()[0]
    ray_tpu_torch.init(num_cpus=4)
    gate = {"passed": False, "runs": []}
    try:
        best = 0.0
        for seed in RL_IMPALA_SEEDS:
            algo = (IMPALAConfig().environment(this_module().cartpole_envs)
                    .env_runners(num_env_runners=4, num_envs_per_env_runner=8,
                                 rollout_length=32)
                    .training(lr=6e-4, ent_coef=0.01,
                              num_updates_per_iteration=16, seed=seed,
                              device=device).build())
            try:
                rl_state_on(algo.learner, dev)
                hist, t0 = [], time.perf_counter()
                for _ in range(RL_IMPALA_ITERS):
                    hist.append(algo.train())
                    r = hist[-1].get("episode_return_mean", float("nan"))
                    if r == r:
                        best = max(best, r)
                    if best >= RL_IMPALA_RETURN:
                        break
                wall = time.perf_counter() - t0
                rl_state_on(algo.learner, dev)
                run = {"seed": seed, "best_return": best,
                       "iterations": len(hist), "wall_s": wall,
                       "update_ms_p50": statistics.median(
                           h["update_time_s"] * 1e3 for h in hist),
                       "iteration_ms_p50": statistics.median(
                           h["time_iteration_s"] * 1e3 for h in hist),
                       "env_steps": hist[-1]["num_env_steps_sampled_lifetime"],
                       "env_steps_per_s": (
                           hist[-1]["num_env_steps_sampled_lifetime"] / wall),
                       "weight_broadcasts": hist[-1]["num_weight_broadcasts"],
                       "dropped_batches": hist[-1]["dropped_batches_lifetime"],
                       "return_every_10": [round(h["episode_return_mean"], 1)
                                           for h in hist[::10]]}
                if best >= RL_IMPALA_RETURN:
                    runner = SingleAgentEnvRunner(EnvRunnerConfig(
                        env=cartpole_envs, num_envs=8, rollout_length=32,
                        seed=seed))
                    run.update(rl_update_card_cpu_ms(algo.learner,
                                                     runner.sample()))
                    runner.stop()
                gate["runs"].append(run)
                log(f"rl algos (b) [{smi}]: {json.dumps(run)}")
            finally:
                algo.stop()
                del algo
            if best >= RL_IMPALA_RETURN:
                gate["passed"] = True
                break
    finally:
        ray_tpu_torch.shutdown()
    out["impala_gate"] = gate
    settle("impala_gate", free0)
    if not gate["passed"]:
        raise AssertionError(f"IMPALA failed the CartPole gate on the card: "
                             f"{gate['runs']}")

    # (c) Sebulba through the runtime: numpy inference actors, then one
    # inference actor whose forward runs on the card
    out["sebulba"] = rl_sebulba(dev, device=device)
    log(f"rl algos (c) numpy inference [{smi}]: "
        f"{json.dumps(out['sebulba'])}")
    out["sebulba_card_inference"] = rl_sebulba(
        dev, module_factory=functools.partial(TorchPolicy, 4, 2, (64, 64),
                                              device="cuda"),
        num_inference=1, device=device,
        inference_options={"num_cpus": 1, "num_gpus": 1,
                           "max_concurrency": 16})
    log(f"rl algos (c) card inference [{smi}]: "
        f"{json.dumps(out['sebulba_card_inference'])}")

    # (d) the DreamerV3 gate, the world model and actor-critic on the card
    free0 = torch.cuda.mem_get_info()[0]
    algo = DreamerV3Config().environment(cartpole_envs).training(
        num_envs=8, rollout_length=32, num_updates_per_iteration=8,
        units=64, deter_dim=64, embed_dim=32,
        actor_lr=3e-3, critic_lr=1e-3, wm_lr=6e-4, ent_coef=1e-3,
        imag_starts=192, seed=0, device=device).build()
    try:
        t0 = time.perf_counter()
        stats = [algo.train() for _ in range(RL_DREAMER_ITERS)]
        rl_state_on(algo, dev)
        state = algo.get_state()
        algo.set_state(state)
        after = algo.train()
        wall = time.perf_counter() - t0
    finally:
        algo.stop()
        del algo
    wm_first = stats[0]["wm_loss"]
    wm_last = float(np.mean([s["wm_loss"] for s in stats[-3:]]))
    imag = float(np.mean([s["imag_return_mean"] for s in stats[-3:]]))
    dreamer = {"iterations": len(stats) + 1, "wall_s": wall,
               "iteration_ms_p50": statistics.median(
                   s["time_iteration_s"] * 1e3 for s in stats),
               "wm_loss_first": wm_first, "wm_loss_last3": wm_last,
               "imag_return_last3": imag,
               "actor_entropy_last": stats[-1]["actor_entropy"],
               "round_trip_iteration": after["training_iteration"]}
    out["dreamerv3"] = dreamer
    log(f"rl algos (d) [{smi}]: {json.dumps(dreamer)}")
    if not (after["training_iteration"] == RL_DREAMER_ITERS + 1
            and wm_last < 0.75 * wm_first and imag > 2.0
            and stats[-1]["actor_entropy"] < 0.65):
        raise AssertionError(f"DreamerV3 failed its gate on the card: "
                             f"{dreamer}")
    settle("dreamerv3", free0)

    # (e) DQN (C51 + dueling + noisy) and SAC for fixed iterations
    for name, config, iters in (
            ("dqn_c51_dueling_noisy", DQNConfig().environment(cartpole_envs)
             .training(num_atoms=51, v_min=0.0, v_max=200.0, dueling=True,
                       noisy=True, n_step=3, seed=0, device=device),
             RL_DQN_ITERS),
            ("sac", SACConfig().environment(pendulum_envs).training(
                seed=0, device=device), RL_SAC_ITERS)):
        free0 = torch.cuda.mem_get_info()[0]
        algo = config.build()
        try:
            target0 = {k: v.clone() for k, v in
                       algo.target.state_dict().items()}
            t0 = time.perf_counter()
            hist = [algo.train() for _ in range(iters)]
            wall = time.perf_counter() - t0
            rl_state_on(algo, dev)
            moved = max(float((v - target0[k]).abs().max())
                        for k, v in algo.target.state_dict().items())
            batch = algo.buffer.sample(algo.config.train_batch_size)
            if name == "sac":
                loss_keys = ("critic_loss", "actor_loss")
                ms = rl_sync_ms(lambda: algo._update(
                    batch, algo.draw_noise(len(batch["rewards"]))), 20)
            else:
                loss_keys = ("td_loss",)
                ms = rl_sync_ms(lambda: algo._update(
                    batch, algo.draw_noise()), 20)
        finally:
            algo.stop()
            del algo
        res = {"iterations": iters, "wall_s": wall,
               "updates": hist[-1]["num_updates_lifetime"],
               "losses_last": {k: hist[-1][k] for k in loss_keys},
               "target_moved_max_abs": moved, "update_ms_p50": ms,
               "iteration_ms_p50": statistics.median(
                   h["time_iteration_s"] * 1e3 for h in hist)}
        out[name] = res
        log(f"rl algos (e) {name} [{smi}]: {json.dumps(res)}")
        if not (all(np.isfinite(v) for v in res["losses_last"].values())
                and moved > 0):
            raise AssertionError(f"rl algos (e) {name}: {res}")
        settle(name, free0)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"rl algos: {json.dumps(out)}")
    return out

# ------------------------------------------------------------ periphery
PERIPHERY_POD = "rtt-smoke-slice"
# the remote driver, a separate process: it connects to the head at
# argv[1], imports no torch itself, and runs the graft entry's forward in
# a `num_gpus=1` task on device argv[2]
PERIPHERY_CLIENT = """
import json, sys, time
t0 = time.perf_counter()
import ray_tpu_torch
ray_tpu_torch.init(address=sys.argv[1])
init_s = time.perf_counter() - t0

def forward(device):
    import chip_smoke
    return chip_smoke.graft_forward(device)

heavy = sorted(n for n in ("jax", "torch") if n in sys.modules)
out = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(forward).remote(
    sys.argv[2]), timeout=600)
out.update(client_init_s=init_s, client_heavy_modules=heavy,
           client_init_to_result_s=time.perf_counter() - t0,
           client_heavy_after=sorted(n for n in ("jax", "torch")
                                     if n in sys.modules))
ray_tpu_torch.shutdown()
print("RESULT " + json.dumps(out))
"""


def card_generation() -> str:
    """'h100' from the card's name ('NVIDIA H100 80GB HBM3')."""
    m = re.search(r"\b([A-Z]\d{3})\b", torch.cuda.get_device_name(0))
    if m is None:
        raise AssertionError(f"no generation in the card's name "
                             f"{torch.cuda.get_device_name(0)!r}")
    return m.group(1).lower()


def graft_forward(device) -> dict:
    """In any process (a task, a train worker): the graft entry's forward
    once on `device`, summed up as the logits' checksum, the launches of
    this process during it and where it ran."""
    from ray_tpu_torch.graft_entry import entry
    fn, args = entry(torch.device(device))
    reset_counts()
    logits = fn(*args)
    return {"checksum": checksum(logits), "launches": kernel_counts(),
            "shape": list(logits.shape), "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "node": os.environ.get("RAY_TPU_NODE_ID")}


def periphery_loop(config):
    """The topology trainer's `train_loop_per_worker` (pickled by value
    from this script's `__main__`): the worker imports `chip_smoke` and
    reports `graft_forward` there."""
    import chip_smoke
    from ray_tpu_torch import train as rt_train
    ctx = rt_train.get_context()
    rt_train.report({**chip_smoke.graft_forward(config["device"]),
                     "world": ctx.get_world_size(),
                     "local_rank": ctx.get_local_rank(),
                     "local_world": ctx.get_local_world_size()})


def http_json(port: int, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def periphery_phase(dev, smi: str, peaks) -> dict:
    """Phase 15, the periphery (see the module docstring): the graft
    entry's forward in process, from a remote driver's task and from a
    topology-placed train worker, each with the same checksum and
    launches; the accelerator manager and the dashboard count the card."""
    import ray_tpu_torch
    from ray_tpu_torch._private.accelerators.gpu import (
        GPUAcceleratorManager, card_names, head_resource_name)
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.graft_entry import _flagship_config, entry
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.worker_group import WorkerGroup
    from ray_tpu_torch.util.accelerators.gpu import slice_bundles
    from ray_tpu_torch.util.placement_group import placement_group_table
    from ray_tpu_torch.util.state import list_actors
    t_phase = time.perf_counter()
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]

    # (b) the forward in this process, against f32 on the CPU
    fn, (params, tokens) = entry(dev)
    reset_counts()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    launches = kernel_counts()
    if not torch.equal(logits, fn(params, tokens)):
        raise AssertionError("two graft entry forwards differ")
    want = {"flash_fwd": 8, "flash_dkdv": 0, "flash_dq": 0, "rms_norm": 17,
            "paged_decode": 0}
    if launches != want:
        raise AssertionError(f"graft entry launches {launches}, want {want}")
    cpu = {k: ([{n: t.cpu() for n, t in layer.items()} for layer in v]
               if k == "layers" else v.cpu()) for k, v in params.items()}
    f32 = Transformer(_flagship_config(dtype="float32"))
    out["b"] = {"launches": launches, "checksum": checksum(logits),
                "tolerance": {"rel_to_max": TOL["graft_logits_rel_to_max"],
                              "argmax_share": TOL["graft_argmax_share"]}}
    # the entry's zero tokens give every position one hidden state, so
    # attention returns V whatever its scores: seeded random tokens hold
    # the scores, the mask and the softmax to f32 too
    rand = torch.randint(0, _flagship_config().vocab_size, tokens.shape,
                         generator=torch.Generator().manual_seed(16))
    reset_counts()
    rand_logits = fn(params, rand.to(dev))
    torch.cuda.synchronize()
    if kernel_counts() != want:
        raise AssertionError(f"graft entry launches {kernel_counts()} on "
                             f"random tokens, want {want}")
    for name, toks, got in (("zero_tokens", tokens, logits),
                            ("random_tokens", rand, rand_logits)):
        with torch.no_grad():
            ref = f32.apply(cpu, toks.cpu())
        got = got.cpu()
        out["b"][name] = {
            "rel_err_to_max": float((got - ref).abs().max()
                                    / ref.abs().max()),
            "argmax_share": float((got.argmax(-1) == ref.argmax(-1))
                                  .float().mean()),
            "distinct_argmax": len(set(ref.argmax(-1).flatten().tolist()))}
    log(f"periphery (b) [{smi}]: {json.dumps(out['b'])}")
    for name in ("zero_tokens", "random_tokens"):
        if (out["b"][name]["rel_err_to_max"] > TOL["graft_logits_rel_to_max"]
                or out["b"][name]["argmax_share"]
                < TOL["graft_argmax_share"]):
            raise AssertionError(f"graft entry logits against f32 on "
                                 f"{name}: {out['b']}")
    del fn, params, logits, rand_logits, cpu, got, ref
    if dev.type == "cuda":
        out["time"] = {"flash_fwd": time_flash(dev, peaks, 2, 8, 4, 256, 64),
                       "rms_norm": time_rms(dev, peaks, GRAFT_ROWS,
                                            GRAFT_D)}
        log(f"periphery (b) time [{smi}]: {json.dumps(out['time'])}")
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the accelerator manager and the dashboard count the card
    topo = f"{card_generation()}-1"
    os.environ["RAY_TPU_POD_NAME"] = PERIPHERY_POD
    os.environ["RAY_TPU_ACCELERATOR_TYPE"] = topo
    mgr = GPUAcceleratorManager
    extra = mgr.get_current_node_additional_resources()
    if extra != {PERIPHERY_POD: 1.0, head_resource_name(topo): 1.0}:
        raise AssertionError(f"slice resources {extra}")
    rt = ray_tpu_torch.init(num_cpus=4, bind_host="127.0.0.1",
                            resources=extra)
    try:
        counted = {"manager": mgr.get_current_node_num_accelerators(),
                   "torch": torch.cuda.device_count(),
                   "runtime": ray_tpu_torch.cluster_resources().get("GPU")}
        bundles = slice_bundles(topo, PERIPHERY_POD)
        want_bundle = [{"CPU": 1.0, "GPU": 1.0, PERIPHERY_POD: 1.0,
                        head_resource_name(topo): 1.0}]
        port = start_dashboard(port=0)
        try:
            counted["dashboard"] = http_json(
                port, "/api/cluster")["total"].get("GPU")
        finally:
            stop_dashboard()
        out["a"] = {"topology": topo, "counted": counted,
                    "bundles": bundles}
        log(f"periphery (a): {json.dumps(out['a'])}")
        if set(counted.values()) != {1} or bundles != want_bundle:
            raise AssertionError(f"periphery (a): {out['a']}")

        # (c) a remote driver's num_gpus=1 task
        host, port = rt.address
        env = dict(os.environ)
        env.pop("RAY_TPU_TORCH_SESSION", None)   # a client is its own
        root = os.path.dirname(os.path.abspath(this_module().__file__))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", PERIPHERY_CLIENT, f"{host}:{port}",
             dev.type], cwd=root, env=env, capture_output=True, text=True,
            timeout=900)
        out["c_process_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"remote driver exited {proc.returncode}:"
                                 f"\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-6000:]}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("RESULT "))
        out["c"] = json.loads(line[len("RESULT "):])
        log(f"periphery (c): {json.dumps(out['c'])}")
        if (out["c"]["checksum"] != out["b"]["checksum"]
                or out["c"]["launches"] != launches
                or out["c"]["client_heavy_modules"]
                or out["c"]["client_heavy_after"]
                or out["c"]["pid"] == os.getpid()):
            raise AssertionError(f"remote driver's forward {out['c']} "
                                 f"against this process's {out['b']}")

        # (d) a topology-placed train worker
        scaling = ScalingConfig(topology=topo, pod_name=PERIPHERY_POD)
        out["d_bundles"] = scaling.worker_bundles()
        out["d_strategy"] = scaling.placement_strategy
        log(f"periphery (d) bundle: {json.dumps(out['d_bundles'])} "
            f"{scaling.placement_strategy}")
        # where the group really went: its placement group and the
        # worker actors in it, read from the head once the group started
        placed = {}
        start = WorkerGroup.start

        def recording_start(group):
            start(group)
            placed["group"] = placement_group_table(group._pg)
            placed["actors"] = [
                {k: a[k] for k in ("actor_id", "placement_group_id",
                                   "placement_group_bundle_index")}
                for a in list_actors()
                if a["placement_group_id"] == group._pg.id]

        WorkerGroup.start = recording_start
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                result = TorchTrainer(
                    this_module().periphery_loop,
                    train_loop_config={"device": dev.type},
                    scaling_config=scaling,
                    run_config=RunConfig(name="periphery",
                                         storage_path=tmp),
                ).fit()
        finally:
            WorkerGroup.start = start
        out["d_fit_s"] = time.perf_counter() - t0
        if result.error is not None:
            raise AssertionError(f"topology trainer: {result.error!r}")
        out["d"] = {k: result.metrics[k] for k in
                    ("checksum", "launches", "pid", "visible", "node",
                     "world", "local_rank", "local_world")}
        group = placed["group"]
        out["d_placed"] = {
            "bundles": group["bundles"], "strategy": group["strategy"],
            "state": group["state"], "bundle_nodes": group["bundle_nodes"],
            "actors": placed["actors"]}
        log(f"periphery (d): {json.dumps(out['d'])} placed "
            f"{json.dumps(out['d_placed'])}")
        if (out["d"]["checksum"] != out["b"]["checksum"]
                or out["d"]["launches"] != launches
                or scaling.num_workers != 1
                or scaling.placement_strategy != "STRICT_SPREAD"):
            raise AssertionError(f"topology worker's forward {out['d']} "
                                 f"against this process's {out['b']}")
        # one card a host: one rank, pinned to that card
        if ((out["d"]["world"], out["d"]["local_rank"],
             out["d"]["local_world"]) != (1, 0, 1)
                or scaling.ranks_per_worker() != 1
                or out["d"]["visible"] != card_names(1)[0]):
            raise AssertionError(f"topology worker's ranks or pin "
                                 f"{out['d']}")
        if (group["bundles"] != want_bundle
                or group["strategy"] != "STRICT_SPREAD"
                or group["bundle_nodes"] != [out["d"]["node"]]
                or [a["placement_group_bundle_index"]
                    for a in placed["actors"]] != [0]):
            raise AssertionError(f"topology worker not in the slice's "
                                 f"group: {out['d_placed']}, it ran on "
                                 f"{out['d']['node']}")
    finally:
        ray_tpu_torch.shutdown()
        for var in ("RAY_TPU_POD_NAME", "RAY_TPU_ACCELERATOR_TYPE"):
            os.environ.pop(var, None)
    # (e) the card's memory back
    out["not_returned_gib"] = memory_back(free0)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"periphery [{smi}]: phase {out['phase_s']:.1f} s")
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
    res_paged = paged_resources()
    log(f"build: {build_s:.1f} s")

    rms_err = check_rms(dev)
    flash_err, lse_err = check_flash(dev)
    check_fwd_determinism(dev)
    bwd_err = check_flash_bwd(dev)
    check_bwd_determinism(dev)
    autograd_err = check_autograd(dev)
    model_check = check_model_grads(dev)
    paged_err = check_paged_decode(dev)
    check_refusals(dev)

    rms_pre = time_rms(dev, peaks, S_MAIN)
    rms_dec = time_rms(dev, peaks, DECODE_ROWS)
    rms_train = time_rms(dev, peaks, TRAIN_B * TRAIN_S, TRAIN_D,
                         torch.bfloat16)
    flash = time_flash(dev, peaks, 1, HEADS, KV_HEADS, S_MAIN)
    flash_4k = time_flash(dev, peaks, 1, HEADS, KV_HEADS, 4096)
    flash_tp2 = time_flash(dev, peaks, 1, HEADS // 2, KV_HEADS // 2, S_MAIN)
    flash_train = time_flash(dev, peaks, TRAIN_B, TRAIN_HEADS, TRAIN_HEADS,
                             TRAIN_S)
    bwd = time_flash_bwd(dev, peaks)
    # the chat cell's decode step at its mean context, and serve()'s
    paged_chat = time_paged_decode(dev, peaks, 256, HEADS, KV_HEADS,
                                   PAGED_CHAT_CONTEXT, 256)
    paged_8 = time_paged_decode(dev, peaks, DECODE_ROWS, HEADS, KV_HEADS,
                                PAGED_ROWS8_CONTEXT, 512)
    for what, t in (("rms_norm prefill", rms_pre),
                    ("rms_norm decode", rms_dec),
                    ("rms_norm train", rms_train),
                    ("flash_fwd s=2048", flash),
                    ("flash_fwd s=4096", flash_4k),
                    ("flash_fwd s=2048 tp=2 rank", flash_tp2),
                    ("flash_fwd train", flash_train),
                    ("flash_dkdv train", bwd["dkdv"]),
                    ("flash_dq train", bwd["dq"]),
                    ("flash_bwd pair train", bwd["pair"]),
                    ("paged_decode chat", paged_chat),
                    ("paged_decode 8 rows", paged_8)):
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
    cut_serve = dataclasses.replace(llama3_8b(), n_layers=SERVE_LLM_LAYERS)
    served_cut = serve_tokens(dev, cut_serve)
    llm_served = serve_llm_phase(served_cut, dev, cfg=cut_serve)
    log("serve_llm: " + json.dumps(llm_served))
    agent_served = serve_llm_agent_phase(served_cut, dev, cfg=cut_serve)
    log("serve_llm agent: " + json.dumps(agent_served))
    tp_served = serve_tp_phase(served_cut, dev, smi, llm_served,
                               cfg=cut_serve)
    log("serve tp: " + json.dumps(tp_served))
    gc.collect()
    torch.cuda.empty_cache()
    trained = train(dev, peaks)
    log("train: " + json.dumps(trained))
    gc.collect()
    torch.cuda.empty_cache()
    cut_train = dataclasses.replace(bench.bench_config(),
                                    n_layers=TRAINER_LAYERS)
    trained_cut = train_reference(
        dev, cut_train, max(TRAINER_STEPS, ELASTIC_STEPS))
    fitted = trainer_phase(trained_cut, dev, cfg=cut_train)
    log("trainer: " + json.dumps(fitted))
    gc.collect()
    torch.cuda.empty_cache()
    elastic = elastic_phase(trained_cut, dev, cfg=cut_train)
    log("elastic: " + json.dumps(elastic))
    gc.collect()
    torch.cuda.empty_cache()
    parallel = parallel_phase(trained, dev, smi)
    log("parallel: " + json.dumps(parallel))
    gc.collect()
    torch.cuda.empty_cache()
    piped = pipeline_phase(trained, dev, smi)
    log("pipeline: " + json.dumps(piped))
    gc.collect()
    torch.cuda.empty_cache()
    tuned = tune_phase(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    rl_phase(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    rl_algos_phase(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    periphery = periphery_phase(dev, smi, peaks)
    log("periphery: " + json.dumps(periphery))
    # launches on each main path, each read just after that path ran
    paths = {"engine_core": served["launches"],
             "llm_engine": served["llm_engine"]["launches"],
             "actor_engine_core": ran["actor"]["launches"],
             "serve_llm_replica": llm_served["launches"],
             "serve_llm_agent_replica": agent_served["launches"],
             "train_20_steps": trained["launches"],
             "train_remat_full_step":
                 trained["remat_steps"]["launches"]["full"],
             "train_remat_save_attn_step":
                 trained["remat_steps"]["launches"]["save_attn"],
             "trainer": fitted["launches"],
             "elastic_worker": elastic["launches"],
             "mesh_dense_5_steps": parallel["dense_launches"],
             "moe_parity_forward": parallel["moe_parity"]["launches"],
             "moe_in_process_6_steps": parallel["moe_in_process"]["launches"],
             "moe_trainer_6_steps": parallel["moe_trainer"]["launches"],
             "pipeline_stage0_5_steps": piped["pipeline"]["launches"][0],
             "pipeline_stage1_5_steps": piped["pipeline"]["launches"][1],
             "serve_llm_tp1_replica": tp_served["b"]["launches"]}
    zero = {"flash_dkdv": 0, "flash_dq": 0}
    for rank in range(TP_RANKS):
        paths[f"tp2_teacher_forced_rank{rank}"] = {
            **zero, **tp_served["a"]["launches_by_rank"][rank]}
        paths[f"serve_llm_tp2_rank{rank}"] = {
            **zero, **tp_served["c"]["launches_by_rank"][rank]}
    for i, trial in enumerate(tuned["trials"]):
        paths[f"tune_trial{i}_lr{trial['lr']:g}"] = trial["launches"]
    paths["graft_entry_forward"] = periphery["b"]["launches"]
    paths["client_task_forward"] = periphery["c"]["launches"]
    paths["topology_worker_forward"] = periphery["d"]["launches"]
    for name in ("flash_fwd", "flash_dkdv", "flash_dq", "rms_norm",
                 "paged_decode"):
        if sum(p.get(name, 0) for p in paths.values()) == 0:
            raise AssertionError(f"{name} never launched on a main path")

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in paths.items()}

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
         "tp2_rank": flash_tp2,
         "train": flash_train, "graft_entry": periphery["time"]["flash_fwd"],
         **resources(res, "fwd")},
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
         "train": rms_train, "graft_entry": periphery["time"]["rms_norm"]},
        {"name": "paged_decode", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/paged_decode.cu",
         "replaces": None,
         "launches": served["launches"]["paged_decode"],
         "launches_by_path": by_path("paged_decode"),
         "max_abs_err": paged_err, "tolerance": TOL["paged_o"],
         **paged_chat, "kernel_ms": paged_chat["ms"], "rows8": paged_8,
         **res_paged},
    ]
    log("check model: " + json.dumps(model_check))
    print(smi)                  # name, power limit as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
