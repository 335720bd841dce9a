"""Channel-backed compiled DAG execution (the aDAG fast path).

Port of `ray_tpu/experimental/dag_channels.py`; its abort segments are
the port's `rtt_` ones.

Parity: reference python/ray/dag/compiled_dag_node.py (CompiledDAG with
persistent per-actor exec loops :135-224, execute :2118 returning
CompiledDAGRef) over shared_memory_channel transport — re-designed for
this stack: compilation allocates one mutable channel per producer
node (single writer, one reader slot per consumer, plus the driver for
outputs), then installs a long-running exec loop on every actor via the
``__rtpu_apply__`` escape hatch. `execute()` writes the input into the
input channel and returns a CompiledDAGRef whose `get()` reads the
output channel — no task submission, object store traffic, or driver
hop between stages.

r13: channels come in two transports behind one endpoint API —
same-box mapped-shm rings (experimental/channel.py) and the cross-host
wire transport (experimental/wire_channel.py, tensors over the
Envelope `raw` zero-copy path). ``channel_transport`` selects per
compile: "shm" (default), "wire", or "auto" (wire for any edge whose
endpoints report different host IPs). Both transports are multi-slot
rings (RAY_TPU_CHANNEL_RING_DEPTH, default 2), so a producer can
publish message m and start computing m+1 while consumers drain m —
the transfer/compute overlap the MPMD pipeline (train/pipeline.py)
schedules against. Exec loops run under a per-stage trace context:
channel wait/write/read spans and per-execute compute spans land in
the r9 flight recorders, so `util.tracing.task_timeline()` shows stage
occupancy and bubbles.
"""
from __future__ import annotations

import struct
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch.experimental.channel import (Channel, ChannelClosed,
                                                ChannelTimeout, _ring_depth)
from ray_tpu_torch.experimental.wire_channel import (WireChannel,
                                                     _apply_serve, _my_ip,
                                                     serve_channel)


class AbortFlag:
    """One shared u64 in shm that exec loops poll between bounded channel
    reads, so a dead upstream actor can never wedge a loop forever: the
    driver raises the flag at teardown and every surviving loop exits at
    its next poll (reference CompiledDAG cancels exec loops instead).

    The segment is HOST-LOCAL to its creator (`host` rides the pickle):
    on any other host is_set() reports False — a cross-host wire-
    transport stage cannot see the driver's /dev/shm, and treating the
    unmappable segment as "aborted" would kill every remote loop at its
    first idle poll. Remote stages learn of teardown through their
    channels instead (close frames / dropped connections)."""

    def __init__(self, name: str, host: str = ""):
        self.name = name
        self.host = host
        self._mv = None
        self._reachable: Optional[bool] = None

    @classmethod
    def create(cls) -> "AbortFlag":
        from ray_tpu_torch._private.object_store import _create_segment
        from ray_tpu_torch._private.specs import SESSION_TAG
        name = f"rtt_{SESSION_TAG}_abort_{uuid.uuid4().hex[:12]}"
        _create_segment(name, memoryview(bytes(8)))
        return cls(name, _my_ip())

    def _map(self):
        if self._mv is None:
            from ray_tpu_torch._private.object_store import _map_segment
            self._mv = _map_segment(self.name, 8)
        return self._mv

    def set(self) -> None:
        struct.pack_into("<Q", self._map(), 0, 1)

    def is_set(self) -> bool:
        if self._reachable is None:
            self._reachable = (not self.host) or self.host == _my_ip()
        if not self._reachable:
            return False               # other host: channels signal
        try:
            return struct.unpack_from("<Q", self._map(), 0)[0] != 0
        except BaseException:
            # same host but the segment is gone: the driver destroyed
            # the DAG before this loop's first poll mapped it == abort
            return True

    def destroy(self) -> None:
        from ray_tpu_torch._private.object_store import unlink_segment
        self._mv = None
        unlink_segment(self.name)

    def __reduce__(self):
        return (AbortFlag, (self.name, self.host))


class _Err:
    """Error envelope forwarded through downstream channels so one
    failing node poisons the execution, not the pipeline."""

    def __init__(self, repr_: str):
        self.repr = repr_


class LoopWatchdog:
    """Dead-stage watchdog shared by ChannelCompiledDAG and the MPMD
    pipeline (train/pipeline.py): runs the driver's blocking channel
    reads/writes in bounded slices and, between slices, checks whether
    any long-lived exec-loop task ref resolved with an error (a loop
    only ERRORS when its actor died — normal exits return a value).
    A dead stage then surfaces as a RuntimeError at the channel op —
    execute()/run_step() — instead of hanging until the caller's
    timeout, and the abort flag is raised so every surviving loop
    unwedges at its next poll. The first error is memoized: a dead
    stage stays dead."""

    def __init__(self, loop_refs: List[Any], abort: AbortFlag,
                 what: str):
        self._refs = loop_refs          # by reference: callers append
        self._abort = abort
        self._what = what               # e.g. "compiled DAG stage"
        self._err: Optional[BaseException] = None

    def failed(self) -> Optional[BaseException]:
        if self._err is not None or not self._refs:
            return self._err
        try:
            done, _ = ray_tpu_torch.wait(self._refs,
                                   num_returns=len(self._refs),
                                   timeout=0)
        except Exception:
            return None
        for ref in done:
            try:
                ray_tpu_torch.get(ref, timeout=5.0)
            except BaseException as e:  # noqa: BLE001
                self._err = e
                return e
        return None

    def op(self, op, timeout: Optional[float], what: str):
        """Run `op(slice_timeout)` until it returns, the deadline
        expires, or a stage death converts into a RuntimeError."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            chunk = (1.0 if remaining is None
                     else min(1.0, max(0.05, remaining)))
            try:
                return op(chunk)
            except (ChannelTimeout, ChannelClosed) as e:
                # a wire reader sees the closed conn BEFORE the dead
                # actor's exec-loop ref resolves — give the failure a
                # moment to land so the caller gets the real cause
                polls = 20 if isinstance(e, ChannelClosed) else 1
                err = None
                for i in range(polls):
                    err = self.failed()
                    if err is not None:
                        break
                    if i + 1 < polls:
                        time.sleep(0.1)
                if err is not None:
                    try:
                        self._abort.set()
                    except BaseException:
                        pass
                    raise RuntimeError(
                        f"{self._what} died mid-pipeline ({what}): "
                        f"{err}") from err
                if isinstance(e, ChannelClosed):
                    raise
                if remaining is not None and remaining <= chunk:
                    raise


def _exec_loop(instance, method_name: str, in_channels: List[Any],
               in_reader_idx: List[int], arg_spec: List[Tuple],
               kw_spec: Dict[str, Tuple], out_channel: Any,
               abort: AbortFlag) -> int:
    """Runs INSIDE the actor (one long-lived call): read inputs, run the
    method, write the result; repeats until the upstream closes or the
    driver raises the abort flag (bounded reads — a dead peer can't
    wedge this loop forever)."""
    readers: List[Any] = []
    writer = None

    def bounded(fn, *a, **kw):
        while True:
            try:
                return fn(*a, timeout=1.0, **kw)
            except ChannelTimeout:
                if abort.is_set():
                    raise ChannelClosed("aborted") from None

    executed = 0
    try:
        for ch, i in zip(in_channels, in_reader_idx):
            readers.append(ch.reader(i))
        writer = out_channel.writer()
        # Per-stage trace lane: channel spans + compute spans inside
        # this loop share one trace id, so task_timeline() renders this
        # stage's occupancy as one coherent lane. Zero cost when
        # RAY_TPU_TRACE=0.
        if _tp.enabled():
            _tp.set_current(_tp.new_id(), 0)
        while True:
            vals: List[Any] = [None] * len(readers)
            err: Any = None
            try:
                if len(readers) == 1:
                    vals[0] = bounded(readers[0].read)
                else:
                    # overlap schedule (reference dag_node_operation.py
                    # intent): consume multi-node inputs in ARRIVAL
                    # order — a slow upstream never head-of-line-blocks
                    # the inputs that are already published
                    pending = set(range(len(readers)))
                    poll = 0.005
                    while pending:
                        progressed = False
                        for i in list(pending):
                            try:
                                vals[i] = readers[i].read(timeout=poll)
                                pending.discard(i)
                                progressed = True
                            except ChannelTimeout:
                                pass
                        if progressed:
                            poll = 0.005
                        else:
                            # idle between executes: back the poll off
                            # so a parked DAG doesn't burn a core
                            poll = min(poll * 2, 0.25)
                            if abort.is_set():
                                raise ChannelClosed("aborted")
            except ChannelClosed:
                # short ack wait: at teardown the driver may never ack
                # the final output, and a 5s stall here would outlive
                # the driver's loop-exit budget and get this actor
                # killed
                writer.close(timeout=0.5)
                return executed
            for v in vals:
                if isinstance(v, _Err):
                    err = v
                    break
            if err is None:
                def resolve(spec):
                    kind, payload = spec
                    return vals[payload] if kind == "n" else payload
                try:
                    args = [resolve(s) for s in arg_spec]
                    kwargs = {k: resolve(s) for k, s in kw_spec.items()}
                    with _tp.span("dag", f"exec:{method_name}"):
                        result = getattr(instance, method_name)(
                            *args, **kwargs)
                except BaseException as e:  # noqa: BLE001
                    import traceback
                    result = _Err("".join(traceback.format_exception(e)))
            else:
                result = err
            try:
                bounded(writer.write, result)
            except ChannelClosed:
                return executed
            executed += 1
    finally:
        # the loop's trace context must not outlive it — later tasks on
        # this actor would stamp their spans into the dead DAG's trace
        _tp.clear_current()
        # transport resources (wire: reader conns + writer-side server)
        # release with the loop, so surviving actors don't leak sockets
        for r in readers:
            try:
                r.release()
            except BaseException:
                pass
        if writer is not None:
            try:
                writer.release()
            except BaseException:
                pass


class CompiledDAGRef:
    """Result handle for one execute() (reference CompiledDAGRef):
    `get()` reads the output channel(s) in order. ray_tpu_torch.get() accepts
    it directly."""

    def __init__(self, dag: "ChannelCompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._consumed = False

    def get(self, timeout: Optional[float] = 30.0):
        if self._consumed:
            raise ValueError("CompiledDAGRef can only be read once")
        value = self._dag._fetch(self._seq, timeout)
        self._consumed = True          # only after a successful fetch
        if isinstance(value, _Err):
            raise RuntimeError(f"compiled DAG node failed:\n{value.repr}")
        if isinstance(value, list):
            for v in value:
                if isinstance(v, _Err):
                    raise RuntimeError(
                        f"compiled DAG node failed:\n{v.repr}")
        return value


class ChannelCompiledDAG:
    """Channel-transport compiled DAG (single InputNode, every actor
    hosts at most one node)."""

    def __init__(self, output, buffer_size_bytes: int = 1 << 20,
                 transport: str = "shm",
                 ring_depth: Optional[int] = None):
        from ray_tpu_torch.dag import (ClassMethodNode, CompiledDAG,
                                       InputNode, MultiOutputNode)
        if transport not in ("shm", "wire", "auto"):
            raise ValueError(
                f"channel_transport must be shm|wire|auto, "
                f"got {transport!r}")
        self._buffer = buffer_size_bytes
        self._depth = _ring_depth(ring_depth)
        # ring depth bounds unread in-flight executes per channel;
        # one extra execute may be mid-write
        self._max_in_flight = self._depth + 1
        base = CompiledDAG(output)          # reuse toposort + validation
        self._order = base._order
        self._input = base._input
        if self._input is None:
            raise ValueError("channel-mode DAG needs an InputNode")
        self._output = output
        nodes = [n for n in self._order
                 if isinstance(n, ClassMethodNode)]
        if not nodes:
            raise ValueError("channel-mode DAG needs actor nodes")
        actors = [n.actor for n in nodes]
        if len({a._actor_id for a in actors}) != len(actors):
            raise ValueError(
                "channel mode requires each actor to host exactly one "
                "DAG node (an actor's exec loop owns it exclusively)")
        out_nodes = (list(output.outputs)
                     if isinstance(output, MultiOutputNode) else [output])
        for o in out_nodes:
            if not isinstance(o, ClassMethodNode):
                raise ValueError("DAG outputs must be actor nodes")
        self._out_nodes = out_nodes

        # --- consumers per producer (input node included)
        consumers: Dict[int, List] = {id(self._input): []}
        for n in nodes:
            consumers[id(n)] = []
        for n in nodes:
            seen_up = set()
            for up in n.upstream:
                # dedup: a node passing the same upstream twice still
                # reads it through ONE reader slot
                if id(up) in seen_up:
                    continue
                seen_up.add(id(up))
                if isinstance(up, (ClassMethodNode, InputNode)):
                    consumers[id(up)].append(n)
        # the driver reads every output node's channel
        n_extra = {id(n): 0 for n in nodes}
        for o in out_nodes:
            n_extra[id(o)] += 1

        # --- transport per producer edge
        from ray_tpu_torch.actor import ActorMethod

        def _apply(actor, fn, *args):
            return ActorMethod(actor, "__rtpu_apply__", {}).remote(
                cloudpickle.dumps(fn), *args)

        host_of: Dict[int, str] = {}
        if transport == "auto":
            # one round trip per actor, compile-time only: every
            # endpoint reports its host IP; edges whose endpoints
            # disagree go wire, same-host edges stay shm
            refs = [_apply(n.actor, lambda inst: _my_ip())
                    for n in nodes]
            for n, ip in zip(nodes, ray_tpu_torch.get(refs, timeout=60)):
                host_of[id(n)] = ip
            driver_ip = _my_ip()

        def _edge_transport(key, cons) -> str:
            if transport != "auto":
                return transport
            ips = {host_of.get(id(c), driver_ip) for c in cons}
            ips.add(host_of.get(key, driver_ip))   # writer's host
            if n_extra.get(key, 0) or key == id(self._input):
                ips.add(driver_ip)                 # driver endpoint
            return "shm" if len(ips) <= 1 else "wire"

        # --- allocate channels (wire producers bind their server in
        # the writer's process before any loop starts)
        from ray_tpu_torch._private.specs import SESSION_TAG
        self._channels: Dict[int, Any] = {}
        node_label = {id(self._input): "in"}
        for n in nodes:
            node_label[id(n)] = n.method_name
        pending_serve: List[Tuple[int, Any, str, int]] = []
        for key, cons in consumers.items():
            extra = n_extra.get(key, 0)
            n_readers = len(cons) + extra
            if n_readers == 0:
                continue
            label = node_label.get(key, "")
            if _edge_transport(key, cons) == "shm":
                self._channels[key] = Channel.create(
                    capacity=buffer_size_bytes, n_readers=n_readers,
                    depth=self._depth, label=label)
            elif key == id(self._input):
                # driver is the writer: serve locally
                self._channels[key] = serve_channel(
                    capacity=buffer_size_bytes, n_readers=n_readers,
                    depth=self._depth, label=label)
            else:
                name = (f"rtt_{SESSION_TAG}_wch_"
                        f"{uuid.uuid4().hex[:12]}")
                producer = next(n for n in nodes if id(n) == key)
                ref = _apply(producer.actor, _apply_serve, name,
                             buffer_size_bytes, n_readers, self._depth,
                             label)
                pending_serve.append((key, ref, name, n_readers))
        for key, ref, name, n_readers in pending_serve:
            addr = ray_tpu_torch.get(ref, timeout=60)
            self._channels[key] = WireChannel(
                name, buffer_size_bytes, n_readers, self._depth,
                addr, node_label.get(key, ""))
        # reader slot assignment: consumers take slots in order; the
        # driver takes the last slot(s)
        slot: Dict[Tuple[int, int], int] = {}
        for key, cons in consumers.items():
            for i, c in enumerate(cons):
                slot[(key, id(c))] = i

        # --- install exec loops
        self._abort = AbortFlag.create()
        self._loop_refs = []
        self._loop_actors = []
        for n in nodes:
            in_chs, in_idx, arg_spec, kw_spec = [], [], [], {}
            seen_inputs: Dict[int, int] = {}

            def input_index(up) -> int:
                if id(up) not in seen_inputs:
                    seen_inputs[id(up)] = len(in_chs)
                    in_chs.append(self._channels[id(up)])
                    in_idx.append(slot[(id(up), id(n))])
                return seen_inputs[id(up)]

            for a in n.args:
                if isinstance(a, (ClassMethodNode, InputNode)):
                    arg_spec.append(("n", input_index(a)))
                else:
                    arg_spec.append(("c", a))
            for k, v in n.kwargs.items():
                if isinstance(v, (ClassMethodNode, InputNode)):
                    kw_spec[k] = ("n", input_index(v))
                else:
                    kw_spec[k] = ("c", v)
            method = ActorMethod(n.actor, "__rtpu_apply__", {})
            self._loop_refs.append(method.remote(
                cloudpickle.dumps(_exec_loop), n.method_name, in_chs,
                in_idx, arg_spec, kw_spec, self._channels[id(n)],
                self._abort))
            self._loop_actors.append(n.actor)

        # --- driver endpoints
        self._in_writer = self._channels[id(self._input)].writer()
        self._out_readers = []
        taken: Dict[int, int] = {}
        for o in out_nodes:
            ch = self._channels[id(o)]
            base_slot = len(consumers[id(o)]) + taken.get(id(o), 0)
            taken[id(o)] = taken.get(id(o), 0) + 1
            self._out_readers.append(ch.reader(base_slot))
        self._multi = isinstance(output, MultiOutputNode)
        self._lock = threading.Lock()
        self._next_seq = 0
        self._fetched: Dict[int, Any] = {}
        self._partial_row: List[Any] = []
        self._read_seq = 0
        self.num_executions = 0
        self._torn_down = False
        self._watch = LoopWatchdog(self._loop_refs, self._abort,
                                   "compiled DAG stage")

    # ------------------------------------------------------------- api
    def execute(self, *args) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("DAG was torn down")
        if len(args) != 1:
            raise TypeError(f"DAG takes exactly 1 input, got {len(args)}")
        with self._lock:
            # self-drain: pull finished results into _fetched so the
            # pipeline's bounded ring channels never back up into an
            # unbounded blocking input write
            while self._next_seq - self._read_seq >= self._max_in_flight:
                self._read_row(60.0)
            with _tp.span("dag", "execute", root=True):
                self._watch.op(
                    lambda t: self._in_writer.write(args[0], timeout=t),
                    60.0, "writing DAG input")
            seq = self._next_seq
            self._next_seq += 1
            self.num_executions += 1
        return CompiledDAGRef(self, seq)

    def _read_row(self, timeout: Optional[float]) -> None:
        """Read one full output row (resuming a partial row) into
        _fetched. Caller holds _lock."""
        while len(self._partial_row) < len(self._out_readers):
            r = self._out_readers[len(self._partial_row)]
            # _partial_row survives a timeout mid-row: each reader's
            # read consumes its ring slot, so a retry must RESUME at
            # the first unread output, never re-read consumed ones
            self._partial_row.append(self._watch.op(
                lambda t, r=r: r.read(t), timeout, "reading DAG output"))
        outs, self._partial_row = self._partial_row, []
        self._fetched[self._read_seq] = (outs if self._multi
                                         else outs[0])
        self._read_seq += 1

    def _fetch(self, seq: int, timeout: Optional[float]):
        with self._lock:
            while self._read_seq <= seq:
                self._read_row(timeout)
            return self._fetched.pop(seq)

    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        try:
            self._in_writer.close()
        except BaseException:
            pass
        # abort flag unwedges loops blocked on a dead peer's channel
        try:
            self._abort.set()
        except BaseException:
            pass
        remaining = list(zip(self._loop_refs, self._loop_actors))
        try:
            ray_tpu_torch.get(self._loop_refs, timeout=5.0)
            remaining = []
        except BaseException:
            pass
        # kill loops that still haven't exited — destroying segments
        # under a live reader would leave its thread stuck for the
        # actor's lifetime
        for ref, actor in remaining:
            try:
                done, _ = ray_tpu_torch.wait([ref], timeout=0.1)
                if not done:
                    ray_tpu_torch.kill(actor)
            except BaseException:
                pass
        for r in self._out_readers:
            try:
                r.release()
            except BaseException:
                pass
        try:
            self._in_writer.release()
        except BaseException:
            pass
        for ch in self._channels.values():
            try:
                ch.destroy()
            except BaseException:
                pass
        try:
            self._abort.destroy()
        except BaseException:
            pass

    def __del__(self):
        try:
            self.teardown()
        except BaseException:
            pass
