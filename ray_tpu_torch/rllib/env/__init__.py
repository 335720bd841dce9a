from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.env.multi_agent import (MultiAgentEnv,
                                                 MultiAgentEnvRunner,
                                                 MultiAgentPPO,
                                                 MultiAgentPPOConfig,
                                                 PolicySpec)

__all__ = ["SingleAgentEnvRunner", "EnvRunnerGroup", "MultiAgentEnv",
           "MultiAgentEnvRunner", "MultiAgentPPO", "MultiAgentPPOConfig",
           "PolicySpec"]
