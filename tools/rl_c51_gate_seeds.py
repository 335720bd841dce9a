"""The C51 learning gate of `tests/test_rllib.py:772` over seeds, in the
JAX package or the port (CPU learner), one line per seed.

    JAX_PLATFORMS=cpu python tools/rl_c51_gate_seeds.py jax 10
    JAX_PLATFORMS=cpu python tools/rl_c51_gate_seeds.py port 10

Each line: package, seed, the mean return of iterations 5-11 ("early"),
of the last 6 of 40 ("late"), and whether the gate's `late > early + 8`
holds.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GATE = dict(num_atoms=51, v_min=0.0, v_max=200.0, dueling=True, n_step=3,
            learning_starts=300, num_envs_per_env_runner=8,
            num_updates_per_iteration=8, train_batch_size=64)


def main(package: str, seeds: int) -> None:
    if package == "jax":
        from ray_tpu.rllib.algorithms.dqn import DQNConfig
        extra = {}
    else:
        import torch
        torch.set_num_threads(1)
        from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig
        extra = {"device": "cpu"}
    for seed in range(seeds):
        algo = DQNConfig().environment("CartPole-v1").training(
            **GATE, seed=seed, **extra).build()
        try:
            rets = [algo.train()["episode_return_mean"] for _ in range(40)]
        finally:
            algo.stop()
        early, late = np.nanmean(rets[5:12]), np.nanmean(rets[-6:])
        print(package, seed, round(early, 2), round(late, 2),
              bool(late > early + 8), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 10)
