from ray_tpu_torch.rllib.core.learner import LearnerGroup, PPOLearner
from ray_tpu_torch.rllib.core.rl_module import (ActorCriticModule,
                                                Categorical)

__all__ = ["ActorCriticModule", "Categorical", "PPOLearner", "LearnerGroup"]
