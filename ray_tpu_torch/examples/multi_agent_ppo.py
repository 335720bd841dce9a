"""Multi-agent PPO: two policies learn two independent CartPoles.

The MultiAgentEnv steps all agents per tick with dict payloads;
policy_mapping_fn routes each agent's (env, agent) column to its own
PPO learner, on the card unless ``--device cpu``. Each agent's CartPole
is made through the runners' env seam (`make_env`), a vector env of one.
Reference analogue: rllib/env/multi_agent_env_runner.py.

Run: python -m ray_tpu_torch.examples.multi_agent_ppo [--device cpu]
"""
import argparse

import numpy as np

from ray_tpu_torch.rllib.env.env_runner import make_env
from ray_tpu_torch.rllib.env.multi_agent import (MultiAgentEnv,
                                                 MultiAgentPPOConfig,
                                                 PolicySpec)


class TwoCartPoles(MultiAgentEnv):
    agents = ("left", "right")

    def __init__(self):
        self._envs = {a: make_env("CartPole-v1", 1) for a in self.agents}
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
            o, r, te, tr, _ = self._envs[a].step(
                np.array([int(actions[a])]))
            obs[a], rew[a] = o[0], float(r[0])
            term[a], trunc[a] = bool(te[0]), bool(tr[0])
            if te[0] or tr[0]:
                self._done[a] = True
        term["__all__"] = all(self._done.values())
        trunc["__all__"] = False
        return obs, rew, term, trunc, {}

    def close(self):
        for e in self._envs.values():
            e.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the learners' device (default: the card)")
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    algo = MultiAgentPPOConfig(
        env_fn=TwoCartPoles,
        policies={"pl": PolicySpec(4, 2), "pr": PolicySpec(4, 2)},
        policy_mapping_fn=lambda a: "pl" if a == "left" else "pr",
        num_envs_per_env_runner=16, rollout_length=64, seed=0,
        device=args.device).build()
    for i in range(args.iters):
        m = algo.train()
        if i % 5 == 0:
            print(f"iter {i:3d} "
                  f"left={m.get('episode_return_mean/policy/pl'):.1f} "
                  f"right={m.get('episode_return_mean/policy/pr'):.1f}")
    algo.stop()


if __name__ == "__main__":
    main()
