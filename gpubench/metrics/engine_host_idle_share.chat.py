"""engine_host_idle_share.chat: share of the traced slice in which the
device idled while the engine's step thread was inside `llm.step` and
outside `llm.prefill` / `llm.decode` (%), from torch.profiler."""
from gpubench.program_spans import engine_host_idle_share as read  # noqa: F401,E501
