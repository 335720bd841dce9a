"""Tasks, actors, objects, placement groups in 30 lines.

Run: python -m ray_tpu_torch.examples.core_tasks_actors
"""
import numpy as np

import ray_tpu_torch


@ray_tpu_torch.remote
def square(x):
    return x * x


@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0

    def add(self, k):
        self.n += k
        return self.n


def main():
    ray_tpu_torch.init(num_cpus=4)
    print("tasks:", ray_tpu_torch.get([square.remote(i) for i in range(8)]))

    c = Counter.remote()
    print("actor:", ray_tpu_torch.get([c.add.remote(i) for i in range(1, 5)]))

    big = ray_tpu_torch.put(np.arange(1_000_000))      # shm-backed object
    print("object sum:", ray_tpu_torch.get(square.remote(2)),
          int(ray_tpu_torch.get(big).sum()))

    from ray_tpu_torch.util.placement_group import placement_group
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    print("placement group ready:", pg.wait(timeout_seconds=30))
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
