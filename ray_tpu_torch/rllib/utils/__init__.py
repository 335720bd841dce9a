from ray_tpu_torch.rllib.utils.replay_buffers import (
    PrioritizedReplayBuffer, ReplayBuffer)
from ray_tpu_torch.rllib.utils.schedules import (ConstantSchedule,
                                                 LinearSchedule,
                                                 PiecewiseSchedule)

__all__ = ["ReplayBuffer", "PrioritizedReplayBuffer", "ConstantSchedule",
           "LinearSchedule", "PiecewiseSchedule"]
