"""Per-operator streaming execution: a slow, resource-heavy stage gets
its own actor pool and backpressure, so the fast reader can't flood it.

Run:  python -m ray_tpu_torch.examples.data_streaming_stages
"""
import time

import numpy as np

import ray_tpu_torch
import ray_tpu_torch.data as rd


class Embedder:
    """Stateful transform: 'loads a model' once per pool worker."""

    def __init__(self, dim):
        time.sleep(0.2)                        # pretend model load
        rng = np.random.default_rng(0)
        self.w = rng.standard_normal((1, dim))

    def __call__(self, batch):
        x = np.asarray(batch["id"], dtype=np.float64)[:, None]
        return {"id": batch["id"], "emb": x @ self.w}


def main():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)

    ds = (rd.range(4000, override_num_blocks=16)
          .map_batches(lambda b: {"id": b["id"] * 2})   # fuses into read
          .map_batches(Embedder, fn_constructor_args=(8,),
                       compute=rd.ActorPoolStrategy(2),
                       num_cpus=1, concurrency=2))      # own stage

    n_rows = sum(len(b["id"]) for b in ds.iter_blocks())
    print(f"rows: {n_rows}")
    print(ds.stats())                   # per-stage tasks / task-s / blocks
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
