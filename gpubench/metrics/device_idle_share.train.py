"""device_idle_share.train: share of the traced slice with no operation
running on the device (%), from torch.profiler."""
from gpubench.readers import idle_share as read  # noqa: F401
