"""Tracing/profiling hooks (SURVEY §5.1 — a full subsystem since r9).

Port of `ray_tpu/util/tracing.py`. Parity: reference util/tracing
(opt-in opentelemetry wrapping) + the nsight runtime-env plugin +
`ray timeline`. Three layers, coarsest to finest:

* :func:`task_timeline` — the cross-process runtime timeline, backed
  by the r9 tracing plane (`_private/tracing_plane.py`): every
  process's flight recorder is drained over the wire (``trace_dump``),
  clocks are aligned, and the result is a Chrome/Perfetto JSON with
  one track per process (driver, each agent, each worker) and flow
  arrows stitching a task's submit → queue/lease → recv/exec/put →
  done spans across processes. Open the output at https://ui.perfetto.dev
  or chrome://tracing. (``ray_tpu_torch.util.metrics.timeline`` remains
  the LEGACY head-events view: head-side RUNNING→FINISHED pairs only, no
  cross-process spans — see its docstring.)

* :func:`annotate` / :func:`annotate_fn` — named user spans. These
  land in the flight recorder, so user code shows up on the same
  task_timeline() as the runtime's own spans, and, being tracing-plane
  spans, as a `torch.profiler` range while a capture records (the
  plane's bridge). On a card each is also an NVTX range, for Nsight
  Systems: a `torch.profiler` capture records no NVTX range (torch
  2.11 on an H100: a range pushed around a matmul left no event).

* :func:`profile` — the device-level `torch.profiler` capture (CUDA
  kernels, host ops), written as a Chrome trace under `log_dir`;
  orthogonal to the task plane.

Knobs: ``RAY_TPU_TRACE`` (master switch, default on) and
``RAY_TPU_TRACE_RING`` (per-process recorder capacity, default 4096;
0 disables). See README "Distributed tracing".

    with ray_tpu_torch.util.tracing.profile("/tmp/tb"):  # device+host
        train_step(...)

    with ray_tpu_torch.util.tracing.annotate("sample"):  # named span
        ...

    ray_tpu_torch.util.tracing.task_timeline("out.json")  # Perfetto JSON
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Iterator, Optional


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Capture a `torch.profiler` trace (CUDA kernels when a card is
    present, host ops always) and write it as a Chrome trace under
    `log_dir`."""
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span: lands in the flight recorder (so it shows on
    task_timeline() next to the runtime's spans, joining the ambient
    trace when called inside a traced task, else starting its own), as
    a `torch.profiler` range while a capture records, and as an NVTX
    range on the card (for Nsight); near-zero cost when tracing is
    disabled and no card is in use. A process that never imported
    torch only records the span."""
    from ray_tpu_torch._private import tracing_plane as _tp
    with _tp.span("user", name, root=True):
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def annotate_fn(name: Optional[str] = None):
    """Decorator flavor of `annotate` (reference tracing_helper's
    function wrapping)."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(name or fn.__qualname__):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def task_timeline(filename: Optional[str] = None,
                  trace_id: Optional[int] = None) -> list:
    """Cross-process Perfetto timeline from the tracing plane's flight
    recorders (r9). Drains every process's recorder via the
    ``trace_dump`` state op (head + local workers + each agent + its
    workers), aligns clocks on the head's monotonic clock (RTT-
    midpoint offsets), and returns Chrome trace-event JSON: one
    Perfetto process per runtime process, spans as complete events,
    parent→child flow arrows across processes. `trace_id` filters to
    one trace. Load the file in https://ui.perfetto.dev.

    For the legacy head-events-only view (task RUNNING→FINISHED pairs,
    no per-process recorders needed) see `ray_tpu_torch.util.metrics
    .timeline`."""
    import json

    from ray_tpu_torch._private import context as _ctx
    from ray_tpu_torch._private import tracing_plane as _tp
    dump = _ctx.get_ctx().state_op("trace_dump")
    trace = _tp.chrome_trace(dump.get("processes", []),
                             trace_id=trace_id)
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
