"""RLlib-equivalent: reinforcement learning on ray_tpu_torch.

Port of `ray_tpu/rllib/`. Component layout mirrors the reference's new
API stack (SURVEY.md §2.3): ActorCriticModule ~ RLModule,
PPOLearner/LearnerGroup ~ Learner stack, SingleAgentEnvRunner/
EnvRunnerGroup ~ EnvRunner stack, and FaultTolerantActorManager as the
shared actor-fleet substrate, and Sebulba's inference actors, env
runners and learner. The learners run on the card unless given
`device="cpu"`; the env runners sample in numpy on the CPU.
`tune_trainable` makes an algorithm config a Tune trainable.
"""
from ray_tpu_torch.rllib.actor_manager import (CallResult,
                                               FaultTolerantActorManager,
                                               RemoteCallResults)
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.core.learner import (LearnerGroup, PPOLearner,
                                              PPOLearnerConfig)
from ray_tpu_torch.rllib.core.rl_module import (ActorCriticModule,
                                                Categorical)
from ray_tpu_torch.rllib.env.env_runner import (EnvRunnerConfig,
                                                SingleAgentEnvRunner)
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.sebulba import (InferenceActor, Sebulba,
                                         SebulbaConfig, SebulbaEnvRunner,
                                         SebulbaLearner, SebulbaRunnerConfig)
from ray_tpu_torch.rllib.tune_adapter import tune_trainable

__all__ = [
    "AlgorithmConfig",
    "PPO", "PPOConfig", "PPOLearner", "PPOLearnerConfig", "LearnerGroup",
    "ActorCriticModule", "Categorical", "SingleAgentEnvRunner",
    "EnvRunnerConfig", "EnvRunnerGroup", "FaultTolerantActorManager",
    "RemoteCallResults", "CallResult",
    "InferenceActor", "SebulbaEnvRunner", "SebulbaRunnerConfig",
    "SebulbaLearner", "Sebulba", "SebulbaConfig", "tune_trainable",
]
