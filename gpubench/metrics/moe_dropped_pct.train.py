"""moe_dropped_pct.train: 100 x the top-k slots the MoE layer dropped
at capacity over those it assigned, set-up's steps and the window's,
from the program's drop tally (%)."""
from gpubench.program_spans import moe_dropped_pct as read  # noqa: F401
