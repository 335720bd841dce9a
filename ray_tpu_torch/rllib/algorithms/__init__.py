"""The port's algorithms: PPO (IMPALA, APPO, DQN, SAC and DreamerV3
follow with ROADMAP queue 1, item 8)."""
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig

__all__ = ["PPO", "PPOConfig"]
