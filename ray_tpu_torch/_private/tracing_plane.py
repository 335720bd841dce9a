"""Distributed tracing plane: per-process flight recorders + trace
context that rides the wire (SURVEY §5.1, upgraded from shim to
subsystem in r9).

The runtime has had per-plane *counters* since r6-r8 (WIRE_STATS,
OBJECT_PLANE_STATS, head task events), but counters cannot answer
"where did this task's wall-clock go" across driver → head → agent →
worker → object plane. This module provides the three pieces that can:

1. **Flight recorder** — a fixed-size ring of typed span events
   ``(trace_id, span_id, parent_span, kind, name, t0_ns, t1_ns,
   extra)`` with CLOCK_MONOTONIC timestamps, one per process,
   always-on. Appends are a tuple build + one slot store under a lock
   whose critical section is two bytecodes — cheap enough for the
   dispatch hot path — and memory is bounded by ``RAY_TPU_TRACE_RING``
   slots (wraparound overwrites the oldest events; the watermark keeps
   counting so drops are visible). ``RAY_TPU_TRACE=0`` or
   ``RAY_TPU_TRACE_RING=0`` disables recording entirely: emission
   sites gate on :func:`enabled` (memoized per CONFIG generation, the
   same discipline as ``native.frame_engine_enabled``), and disabled
   senders attach no trace context, so envelopes carry zero extra
   bytes.

2. **Trace context** — ``(trace_id, span_id)`` pairs. Within a process
   the current context lives in a threadlocal (:func:`current` /
   :func:`set_current`); across processes it rides the wire in the
   Envelope's optional ``trace_id``/``parent_span`` fields (wire MINOR
   2 — see wire.py; old peers skip the unknown fields per proto3), as
   the message-dict key ``"_trace"``. Span/trace ids are random
   nonzero 63-bit ints (pooled PRNG reseeded at fork, same concern as
   specs.rand_hex).

3. **Export** — :func:`dump` snapshots this process's ring (plus its
   monotonic "now", so a collector can align clocks via the
   request/reply RTT midpoint), and :func:`chrome_trace` turns a list
   of per-process dumps into a Chrome/Perfetto trace-event JSON list:
   one Perfetto process per runtime process, one lane per trace, and
   flow arrows stitching parent → child spans across processes.

4. **The profiler bridge** — while a `torch.profiler` capture is
   recording in this process, every :class:`span` also opens a
   ``record_function`` range of its name, so the program's spans lie
   on the device trace's clock beside the kernels they launch. The
   bridge does not depend on the recorder: with ``RAY_TPU_TRACE=0`` a
   span still becomes a range, and with no capture recording it costs
   a dict lookup. ``span(..., profile=False)`` never becomes a range:
   a profiler gives each kernel to the latest-started range open at its
   launch on any thread, so a span on a thread that launches no device
   work (a request thread waiting for a lock) would take the kernels
   another thread launches meanwhile.

Reference parity: the reference's opt-in opentelemetry wrapping
(python/ray/util/tracing_utils) + task_event_buffer.cc execution-truth
timestamps, collapsed into one runtime-owned plane; the export format
is the same chrome://tracing JSON `ray timeline` emits.
"""
from __future__ import annotations

import itertools
import os
import random
import sys
import threading
import time
from typing import Any, Iterator, Optional

# ------------------------------------------------------------- ids
_rand = random.Random()


def _reseed() -> None:
    # fork safety: a child inheriting the PRNG state would mint the
    # same span ids as its parent
    _rand.seed()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed)


def new_id() -> int:
    """Random nonzero 63-bit id (fits int64 and protobuf fixed64)."""
    while True:
        v = _rand.getrandbits(63)
        if v:
            return v


def now() -> int:
    """Span timestamp: CLOCK_MONOTONIC ns (never wall clock — spans
    must subtract cleanly even when NTP steps the wall clock)."""
    return time.monotonic_ns()


def profiling() -> bool:
    """Whether a `torch.profiler` capture is recording in this process.
    Read from `torch.autograd.profiler._is_profiler_enabled`, which the
    capture sets for every thread; `torch._C._autograd.
    _profiler_enabled()` reads False on a thread of a capture started
    with `profile_all_threads`. A process that never imported torch
    pays one dict lookup."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and bool(getattr(prof, "_is_profiler_enabled",
                                             False))


def _profiler_range(name: str):
    """An entered `record_function` range named `name`, or None where no
    capture is recording."""
    if not profiling():
        return None
    rf = sys.modules["torch.autograd.profiler"].record_function(name)
    rf.__enter__()
    return rf


# --------------------------------------------------------- recorder
class FlightRecorder:
    """Fixed-size, lock-light ring of span events.

    Events are immutable tuples; `record` builds one and stores it in
    the next slot (modulo capacity) under a lock held for two
    assignments. The watermark `_n` counts every event ever recorded,
    so `snapshot` knows how many of the oldest were overwritten and
    heartbeats can carry progress without shipping events."""

    __slots__ = ("capacity", "_ring", "_n", "_lock")

    def __init__(self, capacity: int):
        self.capacity = max(0, int(capacity))
        self._ring: list = [None] * self.capacity
        self._n = 0
        self._lock = threading.Lock()

    def record(self, kind: str, name: str, t0_ns: int, t1_ns: int,
               trace_id: int = 0, span_id: int = 0,
               parent_span: int = 0,
               extra: Optional[dict] = None) -> None:
        if not self.capacity:
            return
        ev = (trace_id, span_id, parent_span, kind, name,
              t0_ns, t1_ns, extra)
        with self._lock:
            self._ring[self._n % self.capacity] = ev
            self._n += 1

    def watermark(self) -> int:
        """Total events ever recorded (monotonic; rides heartbeats)."""
        return self._n

    def dropped(self) -> int:
        """Events overwritten by wraparound since process start."""
        return max(0, self._n - self.capacity)

    def snapshot(self) -> list:
        """Events oldest → newest (at most `capacity`)."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                return list(self._ring[:n])
            i = n % self.capacity
            return self._ring[i:] + self._ring[:i]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._n = 0


# ------------------------------------------- process-global recorder
# (gen, recorder, enabled): memoized per CONFIG generation so the
# per-emission gate costs a dict hit, not env lookups. Flip modes
# in-process with env var + CONFIG.reload() (tests, bench A/Bs).
_state: tuple = (-1, FlightRecorder(0), False)
_role = "proc"
_role_name = ""


def set_role(role: str, name: str = "") -> None:
    """Tag this process's dumps (driver / agent / worker + id)."""
    global _role, _role_name
    _role = role
    _role_name = name


def _refresh() -> tuple:
    global _state
    from ray_tpu_torch._private.config import CONFIG
    gen = CONFIG._gen
    st = _state
    if st[0] == gen:
        return st
    cap = int(CONFIG.trace_ring) if CONFIG.trace else 0
    rec = st[1]
    if rec.capacity != cap:
        rec = FlightRecorder(cap)
    _state = (gen, rec, cap > 0)
    return _state


def enabled() -> bool:
    """Whether span emission should run (RAY_TPU_TRACE and a nonzero
    RAY_TPU_TRACE_RING). Hot paths call this before building spans."""
    return _refresh()[2]


def recorder() -> FlightRecorder:
    return _refresh()[1]


def record(kind: str, name: str, t0_ns: int, t1_ns: int,
           trace_id: int = 0, span_id: int = 0, parent_span: int = 0,
           extra: Optional[dict] = None) -> None:
    """Module-level convenience for emission sites that already hold
    the gate result."""
    _refresh()[1].record(kind, name, t0_ns, t1_ns, trace_id, span_id,
                         parent_span, extra)


# Message-dict carrier for the Envelope trace fields: senders attach
# msg[TRACE_KEY] = (trace_id, parent_span); the wire codecs move it
# between the dict and the proto fields (wire.py re-exports this).
TRACE_KEY = "_trace"

# ------------------------------------------------- sampling (r16)
# The head decides once, at submit, whether a ROOT task starts a
# trace (RAY_TPU_TRACE_SAMPLE = stride; 1-in-stride sampled). The
# decision propagates in the existing spec/envelope trace fields, so
# every downstream emission site keeps its r9 gate (`trace_id` truthy
# or a wire-carried ctx) and a sampled task is whole-or-nothing
# across driver, scheduler, agent, worker, and pull manager —
# unsampled tasks record nothing anywhere and their frames are
# byte-identical to RAY_TPU_TRACE=0 frames. The counter is a
# thread-safe itertools.count (deterministic: task k is sampled iff
# k % stride == 0, which the whole-or-nothing test relies on).
_sample_counter = itertools.count()


def sample() -> bool:
    """Head-side sampling decision for a new root trace. stride <= 1
    (incl. the 0 = off revert) keeps the pre-r16 trace-everything
    behavior; the counter only advances for root-submission decisions
    so nested/relayed submissions never skew the stride."""
    from ray_tpu_torch._private.config import CONFIG
    stride = int(CONFIG.trace_sample)
    if stride <= 1:
        return True
    return next(_sample_counter) % stride == 0

# ---------------------------------------------------- trace context
_tls = threading.local()


def current() -> Optional[tuple]:
    """The thread's active (trace_id, span_id), or None."""
    return getattr(_tls, "ctx", None)


def set_current(trace_id: int, span_id: int) -> None:
    _tls.ctx = (trace_id, span_id)


def clear_current() -> None:
    _tls.ctx = None


def wire_ctx() -> Optional[tuple]:
    """The context to attach to an outgoing message's ``"_trace"``
    key, or None when tracing is off / no trace is active."""
    if not enabled():
        return None
    return getattr(_tls, "ctx", None)


def stamp(msg: dict) -> dict:
    """Attach the calling thread's trace context to an outgoing
    message dict (the Envelope codec moves it into the wire's trace
    fields). No-op when tracing is off or no trace is active; returns
    `msg` for call-site chaining."""
    tr = wire_ctx()
    if tr is not None:
        msg[TRACE_KEY] = tr
    return msg


def recv_t0(msg: dict) -> Optional[int]:
    """Receive-side span gate: monotonic now when `msg` carries trace
    context and tracing is on here (the handler records a span with
    this start once its work completes), else None."""
    return now() if (msg.get(TRACE_KEY) and enabled()) else None


class span:
    """Context manager recording one span around a code block.

    Parentage: an explicit ``ctx=(trace_id, parent_span)`` wins, else
    the thread's current context; with neither, the span is recorded
    only when ``root=True`` (which starts a fresh trace — submit,
    broadcast, user annotate) — otherwise the block runs untraced, so
    un-traced operations cost nothing beyond the `enabled` gate.
    Inside the block the current context is this span, so nested
    runtime calls (and their wire messages) parent under it.

    Whether or not it is recorded, the span is also a profiler range of
    its name while a `torch.profiler` capture records (the bridge,
    module docstring), unless ``profile=False``."""

    __slots__ = ("kind", "name", "ctx", "root", "extra", "profile",
                 "_tid", "_sid", "_parent", "_t0", "_prev", "_on", "_rf")

    def __init__(self, kind: str, name: str,
                 ctx: Optional[tuple] = None, root: bool = False,
                 extra: Optional[dict] = None, profile: bool = True):
        self.kind = kind
        self.name = name
        self.ctx = ctx
        self.root = root
        self.extra = extra
        self.profile = profile
        self._on = False
        self._rf = None

    def __enter__(self) -> Optional[tuple]:
        if self.profile:
            self._rf = _profiler_range(self.name)
        if not enabled():
            return None
        cur = self.ctx if self.ctx is not None else current()
        if cur is None or not cur[0]:
            if not self.root:
                return None
            cur = (new_id(), 0)
        self._tid, self._parent = cur[0], cur[1]
        self._sid = new_id()
        self._prev = current()
        _tls.ctx = (self._tid, self._sid)
        self._t0 = now()
        self._on = True
        return (self._tid, self._sid)

    def __exit__(self, *exc) -> None:
        if self._on:
            _tls.ctx = self._prev
            record(self.kind, self.name, self._t0, now(), self._tid,
                   self._sid, self._parent, self.extra)
        if self._rf is not None:
            self._rf.__exit__(*exc)


# ------------------------------------------------------- collection
def fanout_dumps(targets: list, timeout_s: float,
                 extra: Optional[dict] = None,
                 mtype: Optional[str] = None) -> list:
    """TRACE_DUMP fan-out shared by the head and the agents: request
    each ``(meta, connection)`` concurrently, stamp each reply's
    ARRIVAL time the moment it lands (a slow earlier peer must not
    skew a fast later peer's clock offset), and drain under ONE
    shared deadline (N wedged peers cost ~timeout total, not
    N*timeout). `extra` fields ride each request (the head forwards
    its collection budget so agents bound their own worker drain).
    Returns ``[(meta, t0_ns, t1_ns, reply), ...]`` for the replies
    that made it; peers that died or missed the deadline are silently
    absent. `mtype` selects the dump protocol (default TRACE_DUMP; the
    metrics plane reuses this machinery with METRICS_DUMP)."""
    from ray_tpu_torch._private import protocol
    if mtype is None:
        mtype = protocol.TRACE_DUMP
    pending = []
    for meta, conn in targets:
        t0 = now()
        try:
            fut = conn.request_async(
                {"type": mtype, **(extra or {})})
        except protocol.ConnectionClosed:
            continue
        arrival: dict = {}
        fut.add_done_callback(
            lambda f, a=arrival: a.setdefault("t1", now()))
        pending.append((meta, t0, fut, arrival))
    out = []
    deadline = now() + int(timeout_s * 1e9)
    for meta, t0, fut, arrival in pending:
        left = max(0.05, (deadline - now()) / 1e9)
        try:
            rep = fut.result(left)
        except Exception:
            continue
        out.append((meta, t0, arrival.get("t1", now()), rep))
    return out


def dump() -> dict:
    """This process's recorder contents + clock sample, shaped for the
    ``trace_dump`` pull protocol (heartbeats carry only watermarks; the
    events move only when a collector asks). `now_ns` (CLOCK_MONOTONIC,
    the spans' clock) and `wall_ns` (`time.time_ns`, the clock of a
    `torch.profiler` trace) are read back to back, so `wall_ns - now_ns`
    places the recorder's spans on a profiler trace's clock."""
    rec = recorder()
    return {
        "role": _role, "name": _role_name, "pid": os.getpid(),
        "events": rec.snapshot(),
        "watermark": rec.watermark(),
        "dropped": rec.dropped(),
        "capacity": rec.capacity,
        "now_ns": now(),
        "wall_ns": time.time_ns(),
    }


def rtt_offset(t0_local_ns: int, t1_local_ns: int,
               peer_now_ns: int) -> int:
    """Clock offset of a peer whose dump was requested at local t0 and
    received at local t1: assume the peer sampled `now_ns` at the RTT
    midpoint, so ``peer_clock - local_clock ≈ peer_now - (t0+t1)/2``.
    Subtracting it maps peer timestamps onto the local monotonic
    clock (same-host processes share CLOCK_MONOTONIC, so the residual
    there is just the RTT jitter)."""
    return peer_now_ns - (t0_local_ns + t1_local_ns) // 2


# ----------------------------------------------------------- export
def _iter_spans(processes: list,
                trace_id: Optional[int]) -> Iterator[tuple]:
    for idx, proc in enumerate(processes):
        off = int(proc.get("offset_ns", 0))
        for ev in proc.get("events", ()):
            tid, sid, parent, kind, name, t0, t1, extra = ev
            if trace_id is not None and tid != trace_id:
                continue
            yield (idx, tid, sid, parent, kind, name,
                   t0 - off, t1 - off, extra)


def chrome_trace(processes: list,
                 trace_id: Optional[int] = None) -> list:
    """Chrome/Perfetto trace-event list from per-process dumps (as
    returned by the ``trace_dump`` state op). One Perfetto process per
    runtime process, one lane (tid) per trace_id, spans as complete
    ("X") events, and a flow arrow ("s"/"f" pair) for every
    parent→child edge whose two ends are present — every emitted flow is
    therefore begin+end complete by construction."""
    spans = list(_iter_spans(processes, trace_id))
    out: list = []
    for idx, proc in enumerate(processes):
        label = (f"{proc.get('role', 'proc')} "
                 f"{proc.get('name', '')}".strip()
                 + f" (pid {proc.get('pid', '?')})")
        out.append({"ph": "M", "name": "process_name", "pid": idx + 1,
                    "tid": 0, "args": {"name": label}})
    if not spans:
        return out
    base = min(s[6] for s in spans)
    by_sid: dict = {}
    rows = []
    for idx, tid, sid, parent, kind, name, t0, t1, extra in spans:
        lane = tid % 1_000_000 if tid else 0
        ts = (t0 - base) / 1e3                      # µs
        dur = max((t1 - t0) / 1e3, 0.001)
        rows.append((idx + 1, lane, ts, dur, sid, parent, kind, name,
                     tid, extra))
        if sid:
            by_sid[sid] = (idx + 1, lane, ts)
    for pid, lane, ts, dur, sid, parent, kind, name, tid, extra in rows:
        args = {"trace_id": f"{tid:x}", "span_id": f"{sid:x}",
                "parent_span": f"{parent:x}"}
        if extra:
            args.update({k: str(v) for k, v in extra.items()})
        out.append({"name": name, "cat": kind, "ph": "X",
                    "pid": pid, "tid": lane, "ts": round(ts, 3),
                    "dur": round(dur, 3), "args": args})
        src = by_sid.get(parent)
        if src is not None and sid:
            s_pid, s_lane, s_ts = src
            out.append({"ph": "s", "id": str(sid), "name": "parent",
                        "cat": "flow", "pid": s_pid, "tid": s_lane,
                        "ts": round(s_ts + 0.001, 3)})
            out.append({"ph": "f", "bp": "e", "id": str(sid),
                        "name": "parent", "cat": "flow", "pid": pid,
                        "tid": lane, "ts": round(ts + 0.001, 3)})
    return out
