"""The host ranges a `torch.profiler` capture records, for the tests of
the tracing plane's bridge: the capture is the benchmark's
(`gpubench/trace.py`), CPU activity on every thread
(`profile_all_threads`), so a range opened on the engine's step thread
or on autograd's is seen as the harness sees it."""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def user_ranges(fn: Callable[[], object]) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every user annotation (a
    `record_function` range) recorded while `fn()` runs, by start."""
    from torch.profiler import ProfilerActivity, profile
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        fn()
    evs = prof.profiler.kineto_results.events()
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in evs if e.is_user_annotation()),
                  key=lambda r: r[1])


def base(name: str) -> str:
    """A range's name without the parameters after its first colon."""
    return name.split(":")[0]
