"""Readers of the program's own spans and counters.

The program names its phases (`ray_tpu_torch/_private/tracing_plane.py`):
each span lands in the process's flight recorder and, while the
profiler records, in the device trace as a host range of its name, so a
kernel launched inside it belongs to it (`trace.py`). The readers here
take the program's names:

- serving, on the engine's step thread: `llm.step:<running>:<waiting>`
  around a whole step (the wait for the engine's lock included), and
  inside it `llm.prefill:<length>` and `llm.decode:<rows>:<contexts>`
  around the calls into the model; on every other thread
  `llm.lock_wait.<caller>`, the wait for the engine's lock, in the
  flight recorder only;
- training: `train.loss:<tokens>`, `train.backward` and
  `train.optimizer` (torch's `Optimizer.step#AdamW.step` opens inside
  it), and in the MoE layer `moe.route`, `moe.dispatch`, `moe.experts`
  and `moe.combine`, in the forward and in remat's recompute;
- `ray_tpu_torch.models.moe.drop_tally(device)`: the top-k slots the
  MoE layer dropped at capacity, and those it assigned.

A program without these names (an older commit) gives every reader
nothing to read: each then returns None, and raises nothing.
"""
from __future__ import annotations

import bisect
import time
from typing import List, Optional, Set, Tuple

from gpubench import core, counts
from gpubench.trace import base

LOCK_WAITS = ("llm.lock_wait.generate", "llm.lock_wait.backlog")
MOE_MOVES = ("moe.route", "moe.dispatch", "moe.combine")
# AdamW's least traffic a parameter (f32): the parameter, its gradient
# and both moments read, the parameter and both moments written
ADAMW_BYTES_PER_PARAM = 28

Interval = Tuple[float, float]


# ------------------------------------------------------------ intervals
def union(intervals) -> List[Interval]:
    """Sorted, disjoint intervals covering `intervals`."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The parts of `a` outside `b` (both sorted and disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals, lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


# ------------------------------------------------------------ the trace
def spans_named(trace: dict, names) -> List[int]:
    """Indices of the spans whose base name is one of `names`."""
    names = set(names)
    return [i for i, (n, _s, _e) in enumerate(trace["spans"])
            if base(n) in names]


def inside(trace: dict, names) -> Set[int]:
    """Indices of the spans that lie within a span whose base name is one
    of `names` (those spans included). Spans carry no thread, so
    'within' is by time: the program opens these phases one after
    another, and while one is open no other thread launches work."""
    spans = trace["spans"]
    outer = sorted((spans[i][1], spans[i][2]) for i in
                   spans_named(trace, names))
    if not outer:
        return set()
    starts = [s for s, _e in outer]
    out = set()
    for i, (_n, s, e) in enumerate(spans):
        j = bisect.bisect_right(starts, s) - 1
        # the outer spans of one phase do not overlap: the last one to
        # start at or before s is the only candidate
        if j >= 0 and outer[j][0] <= s and e <= outer[j][1]:
            out.add(i)
    return out


def device_s_inside(trace: dict, names) -> Optional[float]:
    """Device seconds of the kernels whose innermost host span lies
    within a span named in `names`, or None where the trace has no
    such span or no kernel."""
    if not trace["kernels"] or not spans_named(trace, names):
        return None
    keep = inside(trace, names)
    return sum(k[2] for k in trace["kernels"] if k[3] in keep)


def completed_steps(trace: dict) -> int:
    """Training steps whose update lies whole inside the traced slice."""
    return sum(1 for i in spans_named(trace, ("train.optimizer",))
               if trace["spans"][i][1] >= 0
               and trace["spans"][i][2] <= trace["window_s"])


# ------------------------------------------------------------- readers
def lock_wait_p95_ms(rec: dict) -> Optional[float]:
    """p95 of the waits for the engine's lock in `generate` and in the
    stream's subscribe (`llm.lock_wait.generate`, `.backlog`) that start
    in the window, from this process's flight recorder after the run
    (ms). The recorder's clock is CLOCK_MONOTONIC, the window's is
    `time.perf_counter`: the same clock where both name it, and None
    otherwise. None where the ring overwrote an event that may have
    started in the window."""
    window = rec.get("window")
    if rec.get("kind") == "train" or not window:
        return None
    if not same_clock("perf_counter", "monotonic"):
        return None
    from ray_tpu_torch._private import tracing_plane
    d = tracing_plane.dump()
    events = d["events"]
    t0 = int(window["t0"] * 1e9)
    t1 = t0 + int(window["seconds"] * 1e9)
    # the ring keeps events in the order they ended: an overwritten one
    # ended before the oldest kept one did
    if d["dropped"] and (not events or events[0][6] >= t0):
        return None
    waits = [(ev[6] - ev[5]) / 1e9 for ev in events
             if ev[4] in LOCK_WAITS and t0 <= ev[5] <= t1]
    return core.percentile(waits, 95) * 1e3 if waits else None


def same_clock(a: str, b: str) -> bool:
    """Whether `time.get_clock_info` names one clock for both."""
    ia, ib = time.get_clock_info(a), time.get_clock_info(b)
    return ia.implementation == ib.implementation and \
        "CLOCK_MONOTONIC" in ia.implementation


def engine_host_idle_share(rec: dict) -> Optional[float]:
    """Share of the traced slice (%) in which the device ran nothing
    while the engine's step thread was inside `llm.step` and outside
    `llm.prefill` and `llm.decode`: its own host work between two calls
    into the model (the lock's handover, the batch's build, the
    buffers, the publish). Idle is the complement of the union of the
    slice's kernels."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or not t["kernels"]:
        return None
    spans, w = t["spans"], t["window_s"]
    steps = spans_named(t, ("llm.step",))
    if not steps:
        return None
    host = subtract(
        union(clip([spans[i][1:] for i in steps], 0.0, w)),
        union(clip([spans[i][1:] for i in spans_named(
            t, ("llm.prefill", "llm.decode"))], 0.0, w)))
    busy = union((s, s + d) for _n, s, d, _sp in t["kernels"])
    return 100.0 * length(subtract(host, busy)) / w


def adamw_roofline(rec: dict) -> Optional[float]:
    """AdamW's least time, 28 bytes a parameter at HBM bandwidth once for
    each update in the slice, over the device time of the kernels
    launched within `train.optimizer` (%)."""
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t:
        return None
    busy = device_s_inside(t, ("train.optimizer",))
    steps = completed_steps(t)
    if not busy or not steps:
        return None
    least = steps * ADAMW_BYTES_PER_PARAM * counts.total_params(
        rec["model"]) / counts.PEAK_HBM_BYTES_S
    return 100.0 * least / busy


def moe_dispatch_ms(rec: dict) -> Optional[float]:
    """Device ms a completed step of the kernels launched within
    `moe.route`, `moe.dispatch` and `moe.combine`: the routing, the
    one-hot dispatch and combine tensors and their two einsums, in the
    forward and in remat's recompute. Their backward runs under
    `train.backward` outside these spans and is not counted."""
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t:
        return None
    busy = device_s_inside(t, MOE_MOVES)
    steps = completed_steps(t)
    if busy is None or not steps:
        return None
    return 1e3 * busy / steps


def moe_dropped_pct(rec: dict) -> Optional[float]:
    """100 x dropped / assigned top-k slots of the MoE layer over the
    run, set-up's steps included, from the program's drop tally on the
    run's device (%)."""
    batches = rec.get("first_batches")
    if rec.get("kind") != "train" or not batches:
        return None
    try:
        from ray_tpu_torch.models import moe
    except ImportError:
        return None
    read = getattr(moe, "drop_tally", None)
    if read is None:
        return None
    tally = read(batches[0].device)
    if not tally["assigned"]:
        return None
    return 100.0 * tally["dropped"] / tally["assigned"]
