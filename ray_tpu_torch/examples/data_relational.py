"""Relational ray_tpu_torch.data: groupby/aggregate, sort, actor-pool maps.

A task-based hash/range exchange powers the all-to-all ops; stateful
preprocessing runs on a pool of long-lived actors. Reference analogue:
data/grouped_data.py + actor_pool_map_operator.py.

Run: python -m ray_tpu_torch.examples.data_relational
"""
import numpy as np

import ray_tpu_torch
from ray_tpu_torch import data as rd


class Standardizer:
    """Stateful transform: fit-once, reused across partitions."""

    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, batch):
        return {"k": batch["k"],
                "z": (batch["v"] - self.mean) / self.std}


def main():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    rng = np.random.default_rng(0)
    ds = rd.from_numpy({"k": rng.integers(0, 5, 1000),
                        "v": rng.normal(10.0, 2.0, 1000)},
                       override_num_blocks=8)

    stats = ds.groupby("k").aggregate(
        rd.Count(), rd.Mean("v"), rd.Std("v"))
    print("per-key stats:")
    for row in stats.sort("k").take_all():
        print(f"  k={int(row['k'])} n={int(row['count()'])} "
              f"mean={row['mean(v)']:.2f} std={row['std(v)']:.2f}")

    mu, sd = ds.mean("v"), ds.std("v")
    z = ds.map_batches(Standardizer, fn_constructor_args=(mu, sd),
                       compute=rd.ActorPoolStrategy(size=2))
    print("standardized mean ~0:", round(z.mean("z"), 4),
          "std ~1:", round(z.std("z"), 4))

    top = ds.sort("v", descending=True).take(3)
    print("top-3 v:", [round(r["v"], 2) for r in top])
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
