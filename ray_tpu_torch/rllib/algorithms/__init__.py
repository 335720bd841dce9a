"""The port's algorithms (`ray_tpu/rllib/algorithms/`): PPO, IMPALA and
APPO (V-trace), DQN (double Q, dueling, C51, noisy nets, n-step,
prioritized replay), SAC and DreamerV3, each learning on the card unless
given `device="cpu"`."""
from ray_tpu_torch.rllib.algorithms.appo import (APPO, APPOConfig,
                                                  APPOLearner)
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig, QModule
from ray_tpu_torch.rllib.algorithms.dreamerv3 import (DreamerV3,
                                                       DreamerV3Config)
from ray_tpu_torch.rllib.algorithms.impala import (IMPALA, IMPALAConfig,
                                                    IMPALALearner,
                                                    IMPALALearnerConfig,
                                                    vtrace_returns)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig, SACModule

__all__ = ["APPO", "APPOConfig", "APPOLearner",
           "PPO", "PPOConfig", "IMPALA", "IMPALAConfig", "IMPALALearner",
           "IMPALALearnerConfig", "vtrace_returns", "DQN", "DQNConfig",
           "QModule", "SAC", "SACConfig", "SACModule",
           "DreamerV3", "DreamerV3Config"]
