"""ray_tpu_torch.experimental: channels and other pre-stable APIs (reference
python/ray/experimental/)."""
from ray_tpu_torch.experimental.channel import (Channel, ChannelClosed,
                                                ChannelReader,
                                                ChannelTimeout,
                                                ChannelWriter)
from ray_tpu_torch.experimental.wire_channel import (WireChannel,
                                                     WireChannelReader,
                                                     WireChannelWriter,
                                                     serve_channel)

__all__ = ["Channel", "ChannelReader", "ChannelWriter", "ChannelClosed",
           "ChannelTimeout", "WireChannel", "WireChannelReader",
           "WireChannelWriter", "serve_channel"]
