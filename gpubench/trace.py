"""The device trace of a `--trace 1` run, and its reduction.

`Profile` runs `torch.profiler` (CPU and CUDA activity, every thread:
the engine steps on a thread of its own and autograd runs the backward
on another) over a slice of the window. `reduce_events` turns the raw
events into what the metric readers take:

- `kernels`: (name, start_s, dur_s, span) of every device operation
  (kernels, copies, sets), times in seconds from the slice's start;
  `span` indexes `spans`: the innermost host span (a `record_function`
  range) open when the operation was launched, found through the
  launch's correlation id, or -1 where none was;
- `spans`: (name, start_s, end_s) of every host span;
- `busy_s`: the union of the device operations' intervals within the
  slice; `window_s`: the slice's length;
- `device_ops` and `idle_gaps`, the breakdown: device seconds by
  operation name, and idle seconds by the span that launched the
  operation ending each gap.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

# span names carry their parameters after a colon ("model.prefill:2817")
SPAN_SEP = ":"


def slice_s(seconds: float) -> float:
    """The traced slice's length: the window's last 6 s (at most 40% of
    it), so the trace stays a few hundred MB and is read after the
    window has closed."""
    return min(6.0, 0.4 * seconds)


class Profile:
    """Start and stop the profiler around a slice of the window."""

    def __init__(self):
        self.prof = None
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        cfg = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        self.prof = profile(activities=acts, experimental_config=cfg)
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> dict:
        self.t1_ns = time.time_ns()
        self.prof.stop()
        evs = self.prof.profiler.kineto_results.events()
        raw = [(e.name(), str(e.device_type()).endswith("CUDA"),
                e.start_ns(), e.duration_ns(), e.correlation_id(),
                bool(e.is_user_annotation())) for e in evs]
        self.prof = None
        return reduce_events(raw, self.t0_ns, self.t1_ns)


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernelEx,
    cudaMemcpyAsync, ...): these carry the correlation id of the device
    operation they start."""
    return name.startswith("cu")


def reduce_events(raw: List[Tuple[str, bool, int, int, int, bool]],
                  t0_ns: int, t1_ns: int) -> dict:
    """`raw`: (name, on_device, start_ns, dur_ns, correlation_id,
    is_user_annotation) of each event; [t0_ns, t1_ns] the slice on the
    same clock."""
    spans, launches, device = [], {}, []
    # a host span also shows on the device, as a range over its kernels
    # (flagged as an annotation, or at least named as the host span)
    host_spans = {name for name, on_dev, _s, _d, _c, annot in raw
                  if annot and not on_dev}
    for name, on_dev, start, dur, corr, annot in raw:
        if on_dev:
            if not annot and name not in host_spans:
                device.append((name, start, dur, corr))
        elif annot:
            spans.append((name, start, start + dur))
        elif _is_launch(name):
            launches[corr] = start
    if device and not (t0_ns <= max(s for _, s, _, _ in device) and
                       min(s for _, s, _, _ in device) <= t1_ns):
        # the clocks do not line up: take the events' own range
        t0_ns = min(s for _, s, _, _ in device)
        t1_ns = max(s + d for _, s, d, _ in device)
    spans.sort(key=lambda s: s[1])
    starts = [s[1] for s in spans]

    def innermost(t: Optional[int]) -> int:
        if t is None:
            return -1
        i = bisect.bisect_right(starts, t)
        # spans nest, so the innermost one open at t is the latest start
        # among those still open; look back over a bounded number
        for j in range(i - 1, max(-1, i - 64), -1):
            _name, s, e = spans[j]
            if s <= t <= e:
                return j
        return -1

    # busy and gaps over every operation, clipped to the slice; the
    # kernel list keeps the operations that lie whole inside it
    ops, kernels = [], []
    for name, start, dur, corr in device:
        s, e = max(start, t0_ns), min(start + dur, t1_ns)
        if e <= s:
            continue
        span = innermost(launches.get(corr))
        ops.append(((s - t0_ns) / 1e9, (e - t0_ns) / 1e9, span))
        if s == start and e == start + dur:
            kernels.append((name, (s - t0_ns) / 1e9, dur / 1e9, span))
    ops.sort()
    kernels.sort(key=lambda k: k[1])
    window_s = (t1_ns - t0_ns) / 1e9
    busy, gaps, end = 0.0, [], 0.0
    for s, e, span in ops:
        if s > end:
            gaps.append((s - end, spans[span][0] if span >= 0 else ""))
        if e > end:
            busy += e - max(s, end)
            end = e
    if window_s > end:
        gaps.append((window_s - end, "end of slice"))
    return {"kernels": kernels,
            "spans": [(n, (s - t0_ns) / 1e9, (e - t0_ns) / 1e9)
                      for n, s, e in spans],
            "busy_s": busy, "window_s": window_s,
            "device_ops": top_by_name([(k[0], k[2]) for k in kernels]),
            "idle_gaps": top_by_name([(base(span) or "outside spans", g)
                                      for g, span in gaps])}


def base(span: str) -> str:
    """A span's name without its parameters."""
    return span.split(SPAN_SEP)[0]


def top_by_name(pairs: List[Tuple[str, float]], n: int = 10
                ) -> List[list]:
    acc: Dict[str, float] = {}
    for name, sec in pairs:
        acc[name[:120]] = acc.get(name[:120], 0.0) + sec
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            ][:n]


def span_params(span: str) -> List[int]:
    """The whole numbers a span's name carries after its base name."""
    return [int(x) for x in span.split(SPAN_SEP)[1:]]


def per_span(trace: dict, span_base: str, name_has: str = ""
             ) -> List[Tuple[List[int], float]]:
    """(parameters, device seconds) of each span whose base name is
    `span_base` and which lies whole inside the slice; the seconds are
    those of the operations launched inside it whose name holds
    `name_has`."""
    spans = trace["spans"]
    keep = {i: 0.0 for i, (n, s, e) in enumerate(spans)
            if base(n) == span_base and s >= 0 and e <= trace["window_s"]}
    for name, _s, dur, idx in trace["kernels"]:
        if idx in keep and name_has in name:
            keep[idx] += dur
    return [(span_params(spans[i][0]), sec) for i, sec in keep.items()]
