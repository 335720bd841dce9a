"""2-worker TorchTrainer: tiny-transformer SFT with checkpoints.

On the card the two workers share it (half a GPU each); with
``--device cpu`` they run on the CPU.

Run: python -m ray_tpu_torch.examples.train_sft [--device cpu]
"""
import argparse
import tempfile

import ray_tpu_torch
from ray_tpu_torch.train import (CheckpointConfig, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)


def train_loop(config):
    import numpy as np
    import torch

    from ray_tpu_torch import train as rt_train
    from ray_tpu_torch.models.config import tiny
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.session import make_temp_checkpoint_dir

    dev = torch.device("cpu" if config["device"] == "cpu" else "cuda")
    cfg = tiny()
    model = Transformer(cfg)
    params = model.init(0, dev)
    leaves = [t for k, t in params.items() if k != "layers"] + [
        t for layer in params["layers"] for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=3e-3)
    rank = rt_train.get_context().get_world_rank()
    tokens = torch.from_numpy(np.random.default_rng(rank).integers(
        0, cfg.vocab_size, (4, 32))).to(dev)

    for i in range(config["steps"]):
        opt.zero_grad()
        loss = model.loss(params, {"tokens": tokens})
        loss.backward()
        opt.step()
        ckpt = None
        if i == config["steps"] - 1:
            d = make_temp_checkpoint_dir()
            ckpt = Checkpoint.from_state(
                d, {"params": [t.detach().cpu().numpy() for t in leaves]})
        rt_train.report({"loss": float(loss), "step": i}, ckpt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (default)")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    ray_tpu_torch.init(num_cpus=4)
    result = TorchTrainer(
        train_loop,
        train_loop_config={"steps": args.steps,
                           "device": "cpu" if cpu else "cuda"},
        scaling_config=ScalingConfig(
            num_workers=2,
            resources_per_worker=None if cpu else {"CPU": 1, "GPU": 0.5}),
        run_config=RunConfig(name="sft_example",
                             storage_path=tempfile.mkdtemp(),
                             checkpoint_config=CheckpointConfig(
                                 num_to_keep=1)),
        backend_config=TorchConfig(distributed=False,
                                   platform="cpu" if cpu else None),
    ).fit()
    print("final:", result.metrics, "checkpoint:", result.checkpoint)
    ray_tpu_torch.shutdown()
    if result.error is not None:
        raise result.error


if __name__ == "__main__":
    main()
