"""Multi-rank dry run of the sharded training step on gloo CPU ranks.

The twin of `__graft_entry__.py::dryrun_multichip`: the FULL training
step (loss, grad, AdamW) of a tiny Transformer over n-rank meshes with
real dp/fsdp/tp/sp/pp/ep shardings (ring attention on the sp mesh, the
GPipe schedule on the pp mesh, an MoE model on the ep mesh), three steps
each, whose losses and grad norms must match a one-process run of the
same model: a sharding-correctness gate. The JAX function runs on n
virtual CPU devices of one process; PyTorch runs one process per rank,
so this spawns n processes that join one gloo group.

    python -m ray_tpu_torch.dryrun 8      # eight ranks, three meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.parallel.mesh import MeshSpec, axis_sizes, prepare_mesh
from ray_tpu_torch.parallel.sharding import (param_shardings, shard_pytree,
                                             sync_grads, tree_map)

# the JAX function's tolerances, relative to max(1, |reference|)
LOSS_RTOL, GRAD_NORM_RTOL = 2e-3, 5e-3


def _mesh_specs_for(n: int) -> list:
    """Mesh configs covering dp/fsdp/tp/sp/pp/ep across the dry run (the
    JAX list): the (pp, dp, tp) mesh runs the GPipe microbatch schedule
    (parallel/pipeline.py) against the same ground truth."""
    if n % 8 == 0:
        return [
            MeshSpec(dp=n // 4, fsdp=2, tp=2, sp=1),
            MeshSpec(dp=n // 8, fsdp=2, tp=2, sp=2),
            MeshSpec(pp=2, dp=n // 4, tp=2),
            MeshSpec(dp=n // 4, ep=2, tp=2),   # MoE expert parallelism
        ]
    if n % 2 == 0:
        return [MeshSpec(dp=n // 2, fsdp=2)]
    return [MeshSpec(dp=n)]


def _tiny_config(use_ring: bool) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, remat=False, dtype="float32",
        param_dtype="float32", use_ring_attention=use_ring)


def config_for(sizes: dict) -> TransformerConfig:
    cfg = _tiny_config(use_ring=sizes.get("sp", 1) > 1)
    if sizes.get("pp", 1) > 1:
        cfg = dataclasses.replace(cfg, pipeline_microbatches=2)
    ep = sizes.get("ep", 1)
    if ep > 1:
        # MoE on the ep axis; generous capacity so the sharded run
        # matches the one-process ground truth exactly.
        cfg = dataclasses.replace(cfg, moe_num_experts=2 * ep, moe_top_k=2,
                                  moe_capacity_factor=4.0)
    return cfg


def tokens_for(sizes: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Batch divisible by dp*fsdp and by the pp microbatches, seq by sp;
    from numpy seed 1."""
    batch = max(2, sizes.get("dp", 1) * sizes.get("fsdp", 1),
                2 * cfg.pipeline_microbatches)
    seq = 32 * max(sizes.get("sp", 1), 2)
    return torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, seq)))


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _grad_norm(params) -> float:
    total = 0.0
    for p in _leaves(params):
        sq = p.grad.to(torch.float32).square().sum()
        total += float(sq.full_tensor() if hasattr(sq, "full_tensor")
                       else sq)
    return total ** 0.5


def run_steps(model: Transformer, params, tokens: torch.Tensor,
              n_steps: int = 3) -> Tuple[List[float], List[float]]:
    """`n_steps` of AdamW (`optax.adamw(1e-3)`'s settings) on one batch;
    returns (losses, grad norms)."""
    ps = _leaves(params)
    for p in ps:
        p.requires_grad_(True)
    opt = torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    losses, gnorms = [], []
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, {"tokens": tokens})
        loss.backward()
        if model.mesh is not None:
            sync_grads(params)
        gnorms.append(_grad_norm(params))
        opt.step()
        losses.append(float(loss.detach()))
    return losses, gnorms


def check_spec(spec: MeshSpec, n_steps: int = 3) -> dict:
    """On every rank of the default group (gloo): the sharded run on the
    mesh of `spec` and the one-process ground truth of the same model
    (plain attention, same init and tokens); raises on a mismatch."""
    mesh = prepare_mesh(spec, device="cpu")
    sizes = axis_sizes(mesh)
    cfg = config_for(sizes)
    tokens = tokens_for(sizes, cfg)
    model = Transformer(cfg, mesh=mesh)
    params = shard_pytree(Transformer(cfg).init(0, "cpu"),
                          param_shardings(mesh, model.param_logical_axes()))
    t0 = time.perf_counter()
    losses, gnorms = run_steps(model, params, tokens, n_steps)
    sharded_s = time.perf_counter() - t0
    ref_model = Transformer(dataclasses.replace(
        cfg, use_ring_attention=False, pipeline_microbatches=0))
    ref_losses, ref_gnorms = run_steps(ref_model, ref_model.init(0, "cpu"),
                                       tokens, n_steps)
    for i, (l, rl, g, rg) in enumerate(zip(losses, ref_losses, gnorms,
                                           ref_gnorms)):
        if not np.isfinite(l):
            raise AssertionError(f"step {i}: non-finite loss {l}")
        if abs(l - rl) > LOSS_RTOL * max(1.0, abs(rl)):
            raise AssertionError(f"step {i}: sharded loss {l} != one-process "
                                 f"{rl} (mesh={sizes})")
        if abs(g - rg) > GRAD_NORM_RTOL * max(1.0, abs(rg)):
            raise AssertionError(f"step {i}: sharded grad-norm {g} != "
                                 f"one-process {rg} (mesh={sizes})")
    return {"mesh": sizes, "losses": losses, "ref_losses": ref_losses,
            "grad_norms": gnorms, "ref_grad_norms": ref_gnorms,
            "sharded_s": sharded_s}


def _rank_main(rank: int, world: int, port: int) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        results = [check_spec(spec) for spec in _mesh_specs_for(world)]
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print("RESULT " + json.dumps(results), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> list:
    """Spawn `n_devices` gloo CPU ranks and run every mesh of
    `_mesh_specs_for(n_devices)` against the one-process ground truth;
    raises if a rank fails. Returns rank 0's results, one per mesh."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=root + (os.pathsep + path if path else ""))
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(n_devices)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.dryrun", "--rank", str(r),
         "--world", str(n_devices), "--port", str(port)],
        stdout=log, stderr=subprocess.STDOUT, text=True, env=env)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p, log in zip(procs, logs):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            log.seek(0)
            outs.append((rc, log.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, (rc, out) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"dryrun rank {rank} exited {rc}:\n"
                                 f"{out[-4000:]}")
    line = next(ln for ln in outs[0][1].splitlines()
                if ln.startswith("RESULT "))
    results = json.loads(line[len("RESULT "):])
    for r in results:
        print(f"dryrun_multichip({n_devices}): mesh={r['mesh']} "
              f"losses={[round(x, 4) for x in r['losses']]} == one-process "
              f"ground truth OK")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks to spawn")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.port)
    else:
        dryrun_multichip(args.n)


if __name__ == "__main__":
    main()
