"""moe_dispatch_ms.train: device ms a completed step of the kernels
launched within the program's `moe.route`, `moe.dispatch` and
`moe.combine` spans, forward and remat's recompute; their backward runs
under `train.backward` and is not counted (ms)."""
from gpubench.program_spans import moe_dispatch_ms as read  # noqa: F401
