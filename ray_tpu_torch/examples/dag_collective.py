"""Compiled-DAG collective nodes: per-actor shards allreduce inside the
DAG (no driver hop), each participant continuing with the reduced value.

Run:  python -m ray_tpu_torch.examples.dag_collective
"""
import numpy as np

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce_bind


@ray_tpu_torch.remote
class Shard:
    def __init__(self, rank):
        self.rank = rank

    def grad(self, x):
        # pretend per-rank gradient: rank-scaled view of the input
        return np.asarray(x, dtype=np.float64) * (self.rank + 1)

    def apply(self, reduced):
        return float(np.sum(reduced))


def main():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    actors = [Shard.remote(r) for r in range(3)]

    with InputNode() as inp:
        grads = [a.grad.bind(inp) for a in actors]
        reduced = allreduce_bind(grads, op="mean")
        outs = [a.apply.bind(r) for a, r in zip(actors, reduced)]
        dag = MultiOutputNode(outs).experimental_compile()

    try:
        for step in range(3):
            x = np.full(4, step + 1.0)
            sums = ray_tpu_torch.get(dag.execute(x), timeout=120)
            # mean over scales (1,2,3) = 2x -> sum = 2 * 4 * (step+1)
            print(f"step {step}: {sums}")
            assert all(abs(s - 8.0 * (step + 1)) < 1e-9 for s in sums)
    finally:
        dag.teardown()
    ray_tpu_torch.shutdown()
    print("ok")


if __name__ == "__main__":
    main()
