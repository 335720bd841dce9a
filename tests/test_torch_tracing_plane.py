"""Distributed tracing plane (r9): flight recorders, wire-propagated
trace context, cross-process Perfetto timeline.

Done-criteria mirrored from r9:
- span parentage driver → scheduler → worker → TASK_DONE on a real
  2-agent cluster, with the remote-arg pull and the holder's serve on
  the same trace (>= 3 processes under one trace_id)
- an old-wire peer skips the unknown trace fields; a known-old peer
  costs no bytes (sender strips)
- ring wraparound keeps the newest events; the watermark counts drops
- disabled mode records nothing and adds no envelope bytes
- the Perfetto JSON is valid: every flow arrow has begin AND end

The port's twin of `tests/test_tracing_plane.py`, case for case.
"""
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import protocol, tracing_plane as tp, wire
from ray_tpu_torch._private.config import CONFIG


@pytest.fixture(params=["native", "python"])
def wire_engine_mode(request):
    """The conftest fixture of the same name, on the port: run a test
    under both of the port's wire engines, re-reading the port's CONFIG."""
    import os

    from ray_tpu_torch import native
    from ray_tpu_torch._private.config import CONFIG

    if request.param == "native" and not native.available():
        pytest.skip("no C compiler: native frame engine unavailable")
    prev = {k: os.environ.get(k) for k in
            ("RAY_TPU_WIRE_NATIVE", "RAY_TPU_WIRE_NATIVE_CODEC")}
    if request.param == "native":
        os.environ["RAY_TPU_WIRE_NATIVE"] = "1"
        os.environ["RAY_TPU_WIRE_NATIVE_CODEC"] = "1"
    else:
        os.environ["RAY_TPU_WIRE_NATIVE"] = "0"
    CONFIG.reload()
    try:
        yield request.param
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        CONFIG.reload()


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    """The conftest shuts the JAX runtime down at the session's end; the
    port's goes down at this module's end, so no later file finds it up."""
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture
def tracing_on():
    os.environ.pop("RAY_TPU_TRACE", None)
    os.environ.pop("RAY_TPU_TRACE_RING", None)
    # r16 sampled tracing: stride 1 = every task traced, which is what
    # these parentage/byte-shape assertions are about (sampling has its
    # own tests below)
    os.environ["RAY_TPU_TRACE_SAMPLE"] = "1"
    CONFIG.reload()
    yield
    os.environ.pop("RAY_TPU_TRACE", None)
    os.environ.pop("RAY_TPU_TRACE_RING", None)
    os.environ.pop("RAY_TPU_TRACE_SAMPLE", None)
    CONFIG.reload()


# ------------------------------------------------------- recorder
def test_ring_wraparound_keeps_newest():
    rec = tp.FlightRecorder(8)
    for i in range(20):
        rec.record("k", f"ev{i}", i, i + 1, trace_id=1, span_id=i + 1)
    snap = rec.snapshot()
    assert len(snap) == 8
    assert [e[4] for e in snap] == [f"ev{i}" for i in range(12, 20)]
    assert rec.watermark() == 20
    assert rec.dropped() == 12


def test_ring_snapshot_before_wrap():
    rec = tp.FlightRecorder(16)
    rec.record("k", "a", 1, 2)
    rec.record("k", "b", 2, 3)
    assert [e[4] for e in rec.snapshot()] == ["a", "b"]
    assert rec.dropped() == 0


def test_disabled_mode_records_nothing(tracing_on):
    os.environ["RAY_TPU_TRACE"] = "0"
    CONFIG.reload()
    assert not tp.enabled()
    base = tp.recorder().watermark()
    with tp.span("user", "x", root=True) as ctx:
        assert ctx is None
    tp.recorder().record("k", "direct", 1, 2)   # capacity-0 ring
    assert tp.recorder().watermark() == base == 0
    assert tp.wire_ctx() is None


def test_span_nesting_parentage(tracing_on):
    rec = tp.recorder()
    base = rec.watermark()
    with tp.span("user", "outer", root=True) as outer:
        assert tp.current() == outer
        with tp.span("user", "inner") as inner:
            assert inner[0] == outer[0]          # same trace
        assert tp.current() == outer             # TLS restored
    assert tp.current() is None
    evs = rec.snapshot()
    inner_ev = [e for e in evs if e[4] == "inner"][-1]
    outer_ev = [e for e in evs if e[4] == "outer"][-1]
    assert inner_ev[2] == outer_ev[1]            # parent = outer sid
    assert outer_ev[2] == 0                      # root
    assert inner_ev[6] >= inner_ev[5]            # t1 >= t0


def test_annotate_lands_in_recorder(tracing_on):
    from ray_tpu_torch.util import tracing
    rec = tp.recorder()
    base = rec.watermark()
    with tracing.annotate("my_phase"):
        pass
    evs = [e for e in rec.snapshot() if e[4] == "my_phase"]
    assert evs and evs[-1][3] == "user"
    assert rec.watermark() == base + 1


# ------------------------------------------------------------ wire
def test_wire_trace_roundtrip_all_paths(tracing_on, wire_engine_mode):
    msg = {"type": "task", "rid": 9, "spec": {"p": 1},
           "_trace": (0xabc123, 0x77)}
    data = wire.dumps(msg)
    out = wire.loads(data)
    assert out["_trace"] == (0xabc123, 0x77)
    assert out["spec"] == {"p": 1}
    # scatter-gather parts concatenation is byte-identical
    assert b"".join(wire.encode_frame_parts(msg)) == data
    # structural plane
    sm = wire.loads(wire.dumps({"type": "pull_object", "object_id":
                                "o1", "_trace": (5, 6)}))
    assert sm["_trace"] == (5, 6) and sm["object_id"] == "o1"
    # batch: every sub-frame keeps its own context
    batch = [dict(msg, rid=i) for i in range(4)]
    got = wire.loads(wire.dumps_batch(batch))
    assert [f["_trace"] for f in got["frames"]] == [(0xabc123, 0x77)] * 4


def test_wire_native_python_byte_parity(tracing_on):
    from ray_tpu_torch import native
    if not native.available():
        pytest.skip("no C compiler")
    msg = {"type": "task_done", "rid": 3, "task_id": "t1",
           "_trace": (123456789, 987654321)}
    try:
        os.environ["RAY_TPU_WIRE_NATIVE"] = "1"
        os.environ["RAY_TPU_WIRE_NATIVE_CODEC"] = "1"
        CONFIG.reload()
        b_native = wire.dumps(msg)
        parts = wire.encode_frame_parts(msg)
        os.environ["RAY_TPU_WIRE_NATIVE"] = "0"
        CONFIG.reload()
        b_py = wire.dumps(msg)
    finally:
        os.environ.pop("RAY_TPU_WIRE_NATIVE", None)
        os.environ.pop("RAY_TPU_WIRE_NATIVE_CODEC", None)
        CONFIG.reload()
    assert b_native == b_py
    assert b"".join(parts) == b_py


def test_unknown_future_fields_are_skipped(tracing_on, wire_engine_mode):
    """An old peer sees our trace fields as unknown fields and must
    skip them — symmetrically, WE must skip fields from a future
    MINOR. Append an unknown varint field (no. 15) to a trace-bearing
    envelope and decode."""
    msg = {"type": "task", "rid": 1, "x": 2, "_trace": (10, 20)}
    data = wire.dumps(msg) + b"\x78\x2a"     # field 15 varint 42
    out = wire.loads(data)
    assert out["x"] == 2 and out["_trace"] == (10, 20)


def test_disabled_costs_no_envelope_bytes(tracing_on):
    plain = {"type": "task", "rid": 7, "spec": {"x": 1}}
    base = wire.dumps(plain)
    traced = wire.dumps({**plain, "_trace": (1 << 60, 1 << 59)})
    # trace context costs exactly two fixed64 fields...
    assert len(traced) == len(base) + 18
    # ...and an untraced message (what disabled senders emit) has no
    # trace bytes at all — byte-identical to the pre-r9 encoding
    assert wire.pb.Envelope.FromString(base).trace_id == 0
    assert base == wire.dumps(dict(plain))


def _conn_pair(handler_b):
    """Two protocol.Connections over a real loopback socket."""
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a_sock = socket.create_connection(lst.getsockname())
    b_sock, _ = lst.accept()
    a = protocol.Connection(a_sock, lambda c, m: None, name="a")
    b = protocol.Connection(b_sock, handler_b, name="b")
    a.start()
    b.start()
    lst.close()
    return a, b


def test_old_peer_strip(tracing_on):
    """A sender that has OBSERVED an old-minor peer strips trace
    context before encode (no wasted bytes); toward a current peer it
    flows through."""
    got = []
    ev = threading.Event()

    def handler(conn, msg):
        got.append(msg)
        ev.set()

    a, b = _conn_pair(handler)
    try:
        a.peer_wire_version = 101        # peer demonstrated MINOR 1
        a.send({"type": "task", "n": 1, "_trace": (11, 22)})
        assert ev.wait(5)
        assert "_trace" not in got[0] and got[0]["n"] == 1
        ev.clear()
        a.peer_wire_version = wire.WIRE_VERSION
        a.send({"type": "task", "n": 2, "_trace": (11, 22)})
        assert ev.wait(5)
        assert got[1]["_trace"] == (11, 22)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------- export
def _fake_processes():
    t = 1_000_000_000
    return [
        {"role": "driver", "name": "head", "pid": 100, "offset_ns": 0,
         "events": [(7, 1, 0, "submit", "f", t, t + 1000, None)]},
        {"role": "worker", "name": "w1", "pid": 200,
         "offset_ns": 500,
         "events": [(7, 2, 1, "worker", "exec:f", t + 2500, t + 9500,
                     {"error": True}),
                    (9, 5, 6, "worker", "other", t, t + 10, None)]},
    ]


def test_chrome_trace_flows_paired_and_valid_json():
    trace = tp.chrome_trace(_fake_processes())
    json.loads(json.dumps(trace))                # serializable
    xs = [e for e in trace if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"f", "exec:f", "other"}
    starts = [e for e in trace if e["ph"] == "s"]
    ends = [e for e in trace if e["ph"] == "f"]
    assert len(starts) == len(ends) == 1         # only the 1->2 edge
    assert starts[0]["id"] == ends[0]["id"]
    assert all(e.get("bp") == "e" for e in ends)
    # clock alignment: exec start (t+2500 - offset 500) is 1µs after
    # submit start
    exec_ev = [e for e in xs if e["name"] == "exec:f"][0]
    submit_ev = [e for e in xs if e["name"] == "f"][0]
    assert abs((exec_ev["ts"] - submit_ev["ts"]) - 2.0) < 1e-6


def test_chrome_trace_filter_by_trace_id():
    trace = tp.chrome_trace(_fake_processes(), trace_id=9)
    xs = [e for e in trace if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["other"]
    assert not [e for e in trace if e["ph"] in ("s", "f")]


def test_rtt_offset_midpoint():
    # peer sampled now=5000 when local clock mid-request was 2000
    assert tp.rtt_offset(1000, 3000, 5000) == 3000


# ---------------------------------------- end-to-end: 2-agent cluster
def _events_by_trace(processes):
    out = {}
    for p in processes:
        for ev in p.get("events", ()):
            out.setdefault(ev[0], []).append(
                (p["role"], p["pid"], ev))
    return out


def test_two_agent_trace_parentage(tmp_path, tracing_on):
    """The acceptance scenario: a task with a remote arg on a real
    2-agent cluster produces one trace whose submit → queue/lease →
    recv/exec → done spans are parented across >= 3 processes, the
    arg pull and its serve land on the same trace, and the Perfetto
    export is flow-complete."""
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    from ray_tpu_torch.util import tracing

    if ray_tpu_torch.is_initialized():      # a shared suite runtime may be
        ray_tpu_torch.shutdown()            # live (one runtime per process)
    rt = ray_tpu_torch.init(num_cpus=1)
    agents = [NodeAgentProcess(num_cpus=1, max_workers=1,
                               resources={"tag_a": 1.0}),
              NodeAgentProcess(num_cpus=1, max_workers=1,
                               resources={"tag_b": 1.0})]
    try:
        deadline = time.time() + 60
        while (time.time() < deadline
               and len(rt.cluster.alive_nodes()) < 3):
            time.sleep(0.1)
        assert len(rt.cluster.alive_nodes()) >= 3

        @ray_tpu_torch.remote(resources={"tag_a": 0.5}, num_cpus=0.1)
        def produce():
            return np.arange(40_000, dtype=np.float64)   # > inline cap

        @ray_tpu_torch.remote(resources={"tag_b": 0.5}, num_cpus=0.1)
        def consume(arr):
            return float(arr.sum())

        ref = produce.remote()
        out = ray_tpu_torch.get(consume.remote(ref), timeout=120)
        assert out == float(np.arange(40_000).sum())
        time.sleep(0.5)                  # let trailing TASK_DONEs land

        dump = rt.state_op("trace_dump")
        traces = _events_by_trace(dump["processes"])

        # find the consume task's trace by its exec span (span names
        # carry the function qualname)
        def is_exec_consume(ev):
            return (ev[4].startswith("exec:")
                    and ev[4].endswith("consume"))

        tid = next(t for t, evs in traces.items()
                   if any(is_exec_consume(e[2]) for e in evs))
        evs = traces[tid]
        kinds = {(role, e[3]) for role, _, e in evs}
        assert ("driver", "submit") in kinds
        assert ("agent", "sched") in kinds
        assert ("worker", "worker") in kinds
        assert ("driver", "done") in kinds
        # the remote-arg pull ran on this trace, and its holder's
        # serve span landed on the SAME trace in another process
        assert ("agent", "pull") in kinds
        assert any(e[3] == "serve" for _, _, e in evs)
        # >= 3 distinct processes under one trace_id
        assert len({(role, pid) for role, pid, _ in evs}) >= 3
        # parentage: walk exec -> ... -> submit (root)
        by_sid = {e[1]: e for _, _, e in evs}
        cur = next(e for _, _, e in evs if is_exec_consume(e))
        names = []
        while cur[2] and cur[2] in by_sid:
            cur = by_sid[cur[2]]
            names.append(cur[4])
        assert cur[3] == "submit" and cur[2] == 0    # chain ends at root
        assert "queue" in names and "lease" in names and "recv" in names
        # r10 delegated dispatch (default-on): the head's lease_batch
        # span splices between the driver submit span and the agent's
        # queue span, so the delegated hop (submit -> lease-batch ->
        # agent-local queue/lease -> exec -> batched done) reads
        # straight off the parent chain
        from ray_tpu_torch._private.config import CONFIG as _CFG
        if _CFG.delegate:
            assert "lease_batch" in names, names

        # heartbeat watermarks (pull-only events; push carries counts)
        stats = rt.state_op("trace_stats")
        assert stats["enabled"]
        assert any(v > 0 for v in stats["nodes"].values())

        # Perfetto export: valid JSON, every flow has begin+end
        path = str(tmp_path / "timeline.json")
        trace = tracing.task_timeline(path, trace_id=tid)
        loaded = json.load(open(path))
        assert loaded == trace and len(trace) > 4
        s_ids = sorted(e["id"] for e in trace if e["ph"] == "s")
        f_ids = sorted(e["id"] for e in trace if e["ph"] == "f")
        assert s_ids and s_ids == f_ids
        procs_in_trace = {e["pid"] for e in trace if e["ph"] == "X"}
        assert len(procs_in_trace) >= 3
    finally:
        for a in agents:
            a.terminate()
        for a in agents:
            a.wait(10)
        ray_tpu_torch.shutdown()


# ---------------------------------------------- sampled tracing (r16)
def test_sample_stride_deterministic_and_knob_reverts(tracing_on):
    import itertools
    os.environ["RAY_TPU_TRACE_SAMPLE"] = "4"
    CONFIG.reload()
    tp._sample_counter = itertools.count()
    assert ([tp.sample() for _ in range(8)]
            == [True, False, False, False] * 2)
    # 0 reverts to pre-r16 trace-everything (the =0/off discipline);
    # 1 is explicit trace-everything
    for revert in ("0", "1"):
        os.environ["RAY_TPU_TRACE_SAMPLE"] = revert
        CONFIG.reload()
        assert all(tp.sample() for _ in range(5))


def test_unsampled_task_bytes_identical_to_trace_off(tracing_on):
    """The head's sampling decision is whole-or-nothing at the byte
    level: an unsampled spec carries trace_id 0 and its TASK frame is
    byte-identical to the RAY_TPU_TRACE=0 encoding (zero wire bytes),
    while a sampled spec records the submit span and stamps the spec."""
    import itertools

    from ray_tpu_torch._private.runtime import Runtime
    from ray_tpu_torch._private.specs import TaskSpec

    def spec():
        return TaskSpec(task_id="ab" * 8, func_id="f" * 16,
                        return_ids=["ab" * 8 + "r0"])

    os.environ["RAY_TPU_TRACE"] = "0"
    CONFIG.reload()
    off = spec()
    assert Runtime._stamp_trace(None, off) is None
    off_bytes = wire.dumps({"type": "task", "rid": 5, "spec": off})

    os.environ.pop("RAY_TPU_TRACE", None)
    os.environ["RAY_TPU_TRACE_SAMPLE"] = "1000"
    CONFIG.reload()
    tp._sample_counter = itertools.count()
    base = tp.recorder().watermark()
    sampled = spec()
    tr = Runtime._stamp_trace(None, sampled)      # count 0 -> sampled
    assert tr is not None and sampled.trace_id
    unsampled = spec()
    assert Runtime._stamp_trace(None, unsampled) is None
    assert unsampled.trace_id == 0
    assert (wire.dumps({"type": "task", "rid": 5, "spec": unsampled})
            == off_bytes)
    # no ring writes happened for the unsampled path (the sampled
    # submit span only records at _record_submit, not here)
    assert tp.recorder().watermark() == base


def test_sampling_whole_or_nothing_across_processes(tracing_on):
    """Acceptance: at stride N on a live runtime, exactly the sampled
    tasks produce spans — and each sampled task's spans appear in
    EVERY process it touched (driver submit/done + worker recv/exec),
    while unsampled tasks leave zero records anywhere."""
    import itertools

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_TRACE_SAMPLE"] = "3"
    CONFIG.reload()
    rt = ray_tpu_torch.init(num_cpus=1, max_workers=1)
    try:
        @ray_tpu_torch.remote
        def job(i):
            return i

        @ray_tpu_torch.remote
        def warmup():
            return -1

        # warm the single worker so exec spans don't race the spawn
        # (distinct name: the warm task may itself be sampled and must
        # not count against the stride-window assertion below)
        assert ray_tpu_torch.get(warmup.remote(), timeout=60) == -1
        time.sleep(0.2)
        tp._sample_counter = itertools.count()
        refs = [job.remote(i) for i in range(6)]     # samples #0, #3
        assert ray_tpu_torch.get(refs, timeout=60) == list(range(6))
        time.sleep(0.5)                  # trailing TASK_DONEs land
        dump = rt.state_op("trace_dump")
        traces = _events_by_trace(dump["processes"])
        exec_tids = {t for t, evs in traces.items()
                     if any(e[4].startswith("exec:")
                            and e[4].endswith("job")
                            for _, _, e in evs)}
        # exactly 2 of the 6 tasks were sampled...
        sampled = set()
        for t in exec_tids:
            kinds = {(role, e[3]) for role, _, e in traces[t]}
            if ("driver", "submit") in kinds:
                sampled.add(t)
                # ...and each sampled trace is WHOLE: spans in both
                # the driver and the worker process
                assert ("worker", "worker") in kinds, kinds
                assert ("driver", "done") in kinds, kinds
                roles = {role for role, _, _ in traces[t]}
                assert {"driver", "worker"} <= roles
        assert len(sampled) == 2, (len(sampled), len(exec_tids))
    finally:
        ray_tpu_torch.shutdown()
