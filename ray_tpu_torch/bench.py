"""Training throughput of the port on one card: the counterpart of the
repo's root `bench.py`.

    python -m ray_tpu_torch.bench            # on the card
    python -m ray_tpu_torch.bench --cpu      # tiny() smoke on the CPU

Prints ONE JSON line with `bench.py`'s fields: tokens/s of a ~1B-param
Llama-style model (bf16, the flash-attention kernels, AdamW) and the
achieved MFU against the detected card's dense bf16 peak. `vs_baseline`
is MFU / 0.35, as in `bench.py`. On the CPU the model is `tiny()` at
batch 4, seq 64, 3 steps, and no MFU is given: the CPU has no peak in
the table.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List

import numpy as np
import torch

from ray_tpu_torch.models.config import TransformerConfig, tiny
from ray_tpu_torch.models.transformer import Params, Transformer
from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.parallel.sharding import sync_grads

# Dense bf16 tensor-core FLOP/s by part (NVIDIA data sheets).
PEAK_FLOPS = {"H100 PCIe": 756e12, "H100": 989e12, "H200": 989e12}


def bench_config() -> TransformerConfig:
    """The model `bench.py` trains on its chip: ~0.95 B params, bf16
    parameters and activations, no remat, unchunked loss."""
    return TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
        n_kv_heads=16, d_ff=5632, max_seq_len=2048, remat=False,
        dtype="bfloat16", param_dtype="bfloat16", loss_chunk=0,
        attn_block_q=1024, attn_block_k=1024)


def detect_peak(device: torch.device) -> float:
    """Dense bf16 peak of the card; raises for a part not in the table."""
    name = torch.cuda.get_device_name(device)
    for part, peak in PEAK_FLOPS.items():      # "H100 PCIe" before "H100"
        if all(word in name for word in part.split()):
            return peak
    raise RuntimeError(f"no bf16 peak for {name!r} in PEAK_FLOPS")


def leaves(params: Params) -> List[torch.Tensor]:
    """Every parameter tensor, in a fixed order: embed, the layers (each
    in its dict's order), final_norm, then lm_head if untied."""
    out = [params["embed"]]
    for layer in params["layers"]:
        out.extend(layer.values())
    out.append(params["final_norm"])
    if "lm_head" in params:
        out.append(params["lm_head"])
    return out


def make_optimizer(params: Params) -> torch.optim.Optimizer:
    """AdamW on every leaf, as `optax.adamw(1e-4)` (no decay mask):
    lr 1e-4, betas (0.9, 0.999), eps 1e-8, weight decay 1e-4. The
    moments are kept in each leaf's dtype, as torch and optax both do."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    return torch.optim.AdamW(ps, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def train_step(model: Transformer, params: Params,
               opt: torch.optim.Optimizer, batch) -> torch.Tensor:
    """One step: loss, backward, AdamW update (in place). Returns the
    loss, detached; it does not wait for the card. Under a mesh the
    parameters are DTensors, whose gradients are first summed onto their
    placements (`sync_grads`)."""
    opt.zero_grad(set_to_none=True)
    loss = model.loss(params, batch)
    loss.backward()
    if model.mesh is not None:
        sync_grads(params)
    opt.step()
    return loss.detach()


def make_batch(cfg: TransformerConfig, batch: int, seq: int, device,
               seed: int = 1):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (batch, seq))
    return {"tokens": torch.as_tensor(tokens, device=device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="tiny() on the CPU instead of the card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    if dev.type == "cuda":
        cfg, (batch, seq, steps) = bench_config(), (2, 2048, 20)
    else:
        cfg, (batch, seq, steps) = tiny(), (4, 64, 3)
    model = Transformer(cfg)
    params = model.init(0, device=dev)
    opt = make_optimizer(params)
    data = make_batch(cfg, batch, seq, dev)

    for _ in range(2):                          # warm-up
        float(train_step(model, params, opt, data))
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = train_step(model, params, opt, data)
    float(loss)                                 # waits for the card
    dt = time.perf_counter() - t0

    tok_per_s = batch * seq * steps / dt
    mfu = (tok_per_s * cfg.flops_per_token() / detect_peak(dev)
           if dev.type == "cuda" else None)
    out = {
        "metric": "train_tokens_per_sec_per_chip",
        "value": round(tok_per_s, 1),
        "unit": "tok/s/chip",
        "vs_baseline": None if mfu is None else round(mfu / 0.35, 4),
        "mfu": None if mfu is None else round(mfu, 4),
        "params": cfg.num_params(),
        "backend": dev.type,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
