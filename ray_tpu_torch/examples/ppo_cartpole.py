"""PPO learns CartPole to 450 (the tuned-example learning gate).

The learner runs on the card unless ``--device cpu``; the env runners
step gymnasium's CartPole-v1.

Run: python -m ray_tpu_torch.examples.ppo_cartpole [--device cpu]
"""
import argparse

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms import PPOConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the learner's device (default: the card)")
    ap.add_argument("--iters", type=int, default=250,
                    help="most training iterations")
    ap.add_argument("--target", type=float, default=450.0,
                    help="stop at this mean episode return")
    args = ap.parse_args(argv)
    ray_tpu_torch.init(num_cpus=4)
    algo = (PPOConfig().environment("CartPole-v1")
            .resources(device=args.device).build())
    for i in range(args.iters):
        m = algo.train()
        r = m.get("episode_return_mean", float("nan"))
        if i % 10 == 0:
            print(f"iter {i:3d} return {r:7.1f}")
        if r == r and r >= args.target:
            print(f"solved at iter {i}: {r:.1f}")
            break
    algo.stop()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
