"""Sebulba RL (r20): the Podracer actor/learner split on ray_tpu_torch.

Port of `ray_tpu/rllib/sebulba/`. Batched inference actors serve
actions to vectorized env runners over the direct call plane;
trajectory shards ride wire-channel rings (depth = queue bound =
staleness bound) to a V-trace learner on the card; refreshed weights
return via the broadcast tree, versioned so staleness is measurable end
to end. See PAPERS.md
"Podracer architectures for scalable Reinforcement Learning".
"""
from ray_tpu_torch.rllib.sebulba.env_runner import (SebulbaEnvRunner,
                                                    SebulbaRunnerConfig)
from ray_tpu_torch.rllib.sebulba.inference import (InferenceActor,
                                                   TorchPolicy)
from ray_tpu_torch.rllib.sebulba.learner import SebulbaLearner
from ray_tpu_torch.rllib.sebulba.trainer import Sebulba, SebulbaConfig

__all__ = [
    "InferenceActor", "SebulbaEnvRunner", "SebulbaRunnerConfig",
    "SebulbaLearner", "Sebulba", "SebulbaConfig", "TorchPolicy",
]
