"""adamw_roofline.train: AdamW's least time (28 bytes a f32 parameter
at 3.35 TB/s) over the device time of the kernels launched within the
program's `train.optimizer` span (%)."""
from gpubench.program_spans import adamw_roofline as read  # noqa: F401
