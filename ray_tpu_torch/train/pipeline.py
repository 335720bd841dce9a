"""MPMD pipeline parallelism: stage-per-worker-group training over
compiled-DAG channels (r13).

Port of `ray_tpu/train/pipeline.py`. A stage runs eagerly in PyTorch
where the JAX stage jits: its forward (a non-last stage) runs under
`torch.no_grad()` and keeps only the stage INPUT; its backward
recomputes the stage forward from that input with autograd on and takes
`torch.autograd.grad` of the output against the cotangent (the same
remat trade as the JAX stage's `jax.vjp`); the last stage's forward,
loss and backward are one pass. A stage moves its slice of the params
(and the consts) to its device when its loop starts, the card unless the
caller names the CPU, and returns its final params as CPU tensors
(numpy has no bfloat16). Activations and cotangents cross the channels
as tensors: a CUDA tensor lands on the next stage's own card.

MULTICHIP_r05 proved pp-axis parity INSIDE one process
(parallel/pipeline.py: SPMD GPipe/1F1B via shard_map + ppermute). This
module is the pod-scale shape from "Scaling Deep Learning Training
with MPMD Pipeline Parallelism" (PAPERS.md): every pipeline stage is
its OWN worker group running its OWN program on its own slice of the
layer stack, and activations/cotangents stream stage-to-stage over the
compiled-DAG channel layer — multi-slot rings (shm same-box, the wire
transport cross-host) whose depth >= 2 double-buffers each edge, so a
stage computes microbatch m+1 while m is still in flight to its
neighbor. The driver never touches an activation: it feeds microbatch
inputs to stage 0, targets to the last stage, and reads one loss per
step ("Exploring the limits of Concurrency in ML Training on Google
TPUs": the control plane stays off the hot path).

Schedules: classic 1F1B (stage s runs S-1-s warmup forwards, then
alternates forward/backward, then drains — at most S-s stashed
activations per stage independent of M) and GPipe fill-drain (all M
forwards, then all M backwards) as the fallback. Stage backwards
recompute their forward from the saved stage input (remat), the same
trade the SPMD 1F1B schedule makes.

MPMD makes two things free that are structurally hard in SPMD mode:
ragged stages (layer counts need not divide the stage count — the
shared `partition_layers` helper assigns the remainder to the last
stage) and per-stage compilation (each stage jits only its own
sub-stack).

Verification is the r9 tracing plane: stage loops run under one trace
id, forward/backward compute spans and channel wait/write/read spans
land in each process's flight recorder, and
`util.tracing.task_timeline()` renders the cross-process Perfetto
timeline where overlap (and the bubble fraction, `bubble_fraction()`)
is directly visible.
"""
from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch.experimental.channel import (Channel, ChannelClosed,
                                          ChannelTimeout, _ring_depth)
from ray_tpu_torch.experimental.dag_channels import AbortFlag, LoopWatchdog
from ray_tpu_torch.experimental.wire_channel import WireChannel, _my_ip
from ray_tpu_torch.parallel.pipeline import (n_layers_of, partition_layers,
                                             slice_stage)


def _serve_many(_instance, specs: list) -> list:
    """__rtpu_apply__ body: bind several wire-channel servers in one
    actor round trip; returns their addresses in spec order."""
    from ray_tpu_torch.experimental.wire_channel import serve_channel
    return [serve_channel(name, cap, nr, depth, label).addr
            for (name, cap, nr, depth, label) in specs]


def _host_info(_instance) -> str:
    return _my_ip()


def _to_device(tree, dev):
    """Every tensor or ndarray leaf of `tree` on `dev` (other leaves as
    they are)."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map

    def move(v):
        if isinstance(v, np.ndarray):
            return torch.as_tensor(v).to(dev)
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        return v
    return tree_map(move, tree)


def stage_grads(stage_fn, consts, p, x, out_fn, cot=None):
    """One stage backward with the forward recomputed: (out, param grads
    as p's tree, x grad or None). `out_fn(stage_fn(p, x, *consts))` is
    differentiated, with `cot` as its cotangent when given (a non-last
    stage: out_fn is the identity) or as a scalar loss (the last stage,
    whose forward, loss and backward are this one pass)."""
    import torch
    from torch.utils._pytree import tree_flatten, tree_unflatten
    leaves, spec = tree_flatten(p)
    with torch.enable_grad():
        ps = [q.detach().requires_grad_(q.is_floating_point())
              for q in leaves]
        xin = x.detach().requires_grad_(x.is_floating_point())
        out = out_fn(stage_fn(tree_unflatten(ps, spec), xin, *consts))
        want = [q for q in ps if q.requires_grad]
        if xin.requires_grad:
            want.append(xin)
        got = list(torch.autograd.grad(out, want, cot, allow_unused=True))
    dx = got.pop() if xin.requires_grad else None
    it = iter(got)
    dp = [(next(it) if q.requires_grad else None) for q in ps]
    dp = [torch.zeros_like(q) if d is None else d for q, d in zip(ps, dp)]
    return out.detach(), tree_unflatten(dp, spec), dx


def _stage_loop(_instance, stage: int, n_stages: int, stage_params,
                stage_fn, loss_fn, consts, schedule: str, M: int,
                steps: int, in_ch, tgt_ch, out_ch, gin_ch, gout_ch,
                loss_ch, abort, update_fn, lr: float, trace_root: int,
                device=None):
    """Runs INSIDE a stage worker (one long-lived call): the whole
    training run for this stage — per step, a 1F1B/GPipe microbatch
    schedule over the neighbor channels, then the local optimizer
    update on this stage's params. Returns the final stage params, as
    CPU tensors."""
    from collections import deque

    import torch
    from torch.utils._pytree import tree_map

    from ray_tpu_torch.ops.dispatch import resolve_device

    if trace_root and _tp.enabled():
        _tp.set_current(trace_root, 0)
    last = stage == n_stages - 1
    dev = resolve_device(device)

    reader = in_ch.reader(0)
    tgt_reader = tgt_ch.reader(0) if tgt_ch is not None else None
    writer = out_ch.writer() if out_ch is not None else None
    gin = gin_ch.reader(0) if gin_ch is not None else None
    gout = gout_ch.writer() if gout_ch is not None else None
    loss_w = loss_ch.writer() if loss_ch is not None else None

    def bounded(fn, *a):
        while True:
            try:
                return fn(*a, timeout=1.0)
            except ChannelTimeout:
                if abort is not None and abort.is_set():
                    raise ChannelClosed("aborted") from None

    consts = tuple(_to_device(tuple(consts), dev))

    def fwd(p, x):
        with torch.no_grad():
            return stage_fn(p, x, *consts)

    def grads_of(p, x, out_fn, cot=None):
        return stage_grads(stage_fn, consts, p, x, out_fn, cot)

    params = _to_device(stage_params, dev)
    try:
        for step in range(steps):
            grads = tree_map(torch.zeros_like, params)
            loss_acc = 0.0
            saved: deque = deque()
            # 1F1B: stage s injects S-1-s warmup forwards, then
            # alternates 1F1B, then drains — its stash stays O(S-s).
            # GPipe: all M forwards first (stash O(M)).
            W = M if schedule == "gpipe" else min(M, n_stages - 1 - stage)

            def fwd_one():
                x = _to_device(bounded(reader.read), dev)
                if last:
                    # the last stage's forward is fused into its
                    # backward (one pass computes both); here it only
                    # stashes the pair
                    t = _to_device(bounded(tgt_reader.read), dev)
                    saved.append((x, t))
                    return
                with _tp.span("stage", f"fwd:s{stage}",
                              extra={"step": step}):
                    y = fwd(params, x)
                    if y.is_cuda:
                        torch.cuda.synchronize(y.device)
                saved.append(x)
                bounded(writer.write, y)

            def bwd_one():
                nonlocal grads, loss_acc
                if last:
                    x, t = saved.popleft()
                    with _tp.span("stage", f"bwd:s{stage}",
                                  extra={"step": step}):
                        loss_m, dp, dx = grads_of(
                            params, x, lambda y: loss_fn(y, t))
                        loss_acc += float(loss_m)
                else:
                    cot = _to_device(bounded(gin.read), dev)
                    x = saved.popleft()
                    with _tp.span("stage", f"bwd:s{stage}",
                                  extra={"step": step}):
                        _, dp, dx = grads_of(params, x, lambda y: y, cot)
                        if cot.is_cuda:
                            torch.cuda.synchronize(cot.device)
                grads = tree_map(lambda g, d: g + d, grads, dp)
                if gout is not None:
                    bounded(gout.write, dx)

            for _ in range(W):
                fwd_one()
            for _ in range(M - W):
                fwd_one()
                bwd_one()
            for _ in range(W):
                bwd_one()

            mean_grads = tree_map(lambda g: g / M, grads)
            with _tp.span("stage", f"update:s{stage}"):
                if update_fn is not None:
                    params = update_fn(params, mean_grads, step)
                else:
                    with torch.no_grad():
                        params = tree_map(lambda p, g: p - lr * g,
                                          params, mean_grads)
            if last:
                bounded(loss_w.write,
                        {"step": step, "loss": loss_acc / M})
        return tree_map(lambda p: p.detach().cpu()
                        if isinstance(p, torch.Tensor) else p, params)
    finally:
        # the loop's trace context must not outlive it — later tasks
        # on this worker would stamp spans into the pipeline's trace
        _tp.clear_current()
        for ep in (writer, gout, loss_w):
            if ep is not None:
                try:
                    ep.close(timeout=0.5)
                except BaseException:
                    pass
                try:
                    ep.release()
                except BaseException:
                    pass
        for ep in (reader, tgt_reader, gin):
            if ep is not None:
                try:
                    ep.release()
                except BaseException:
                    pass


def _host(v):
    """A driver-side batch as it is fed: a CPU tensor stays a tensor
    (bf16 included), anything else becomes numpy."""
    import sys

    import numpy as np
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return np.asarray(v)


def _contiguous(v):
    import numpy as np
    if isinstance(v, np.ndarray):
        return np.ascontiguousarray(v)
    return v.contiguous()


class MPMDPipeline:
    """Compiled MPMD pipeline over explicit stage actors.

    One actor per stage (each a separate process — in pod mode, rank 0
    of that stage's worker group). `start()` compiles the static stage
    graph: allocates one channel per edge (transport-selected), binds
    wire servers inside the writer processes, and installs the
    persistent stage loops through the ``__rtpu_apply__`` escape hatch
    — the same machinery as ChannelCompiledDAG, specialized to the
    bidirectional stage topology a one-node-per-actor DAG cannot
    express (forward and backward flows share each actor)."""

    def __init__(self, stage_actors: List[Any], stage_params: List[Any],
                 *, stage_fn, loss_fn, consts: tuple = (),
                 num_microbatches: int = 4, schedule: str = "1f1b",
                 steps: int = 1, transport: str = "shm",
                 ring_depth: Optional[int] = None,
                 capacity: int = 4 << 20, update_fn=None,
                 lr: float = 1e-2, device=None):
        if len(stage_actors) < 2:
            raise ValueError("an MPMD pipeline needs >= 2 stages")
        if len(stage_actors) != len(stage_params):
            raise ValueError("one params slice per stage actor")
        if schedule not in ("1f1b", "gpipe"):
            raise ValueError("schedule must be 1f1b|gpipe")
        if transport not in ("shm", "wire", "auto"):
            raise ValueError("transport must be shm|wire|auto")
        self._actors = list(stage_actors)
        self._params = list(stage_params)
        self._stage_fn = stage_fn
        self._loss_fn = loss_fn
        self._consts = tuple(consts)
        self._M = int(num_microbatches)
        self._schedule = schedule
        self._steps = int(steps)
        self._transport = transport
        self._depth = _ring_depth(ring_depth)
        self._capacity = int(capacity)
        self._update_fn = update_fn
        self._lr = lr
        # where each stage runs (None: its card); a string, so the
        # driver passes it without touching torch's device objects
        self._device = None if device is None else str(device)
        self._loop_refs: List[Any] = []
        self._param_refs: List[Any] = []
        self._channels: List[Any] = []
        self._abort: Optional[AbortFlag] = None
        self._torn_down = False
        self._watch: Optional[LoopWatchdog] = None
        self._trace_root = 0

    # ------------------------------------------------------ compilation
    def _apply(self, actor, fn, *args):
        from ray_tpu_torch.actor import ActorMethod
        return ActorMethod(actor, "__rtpu_apply__", {}).remote(
            cloudpickle.dumps(fn), *args)

    def start(self) -> None:
        S = len(self._actors)
        transport = self._transport
        if transport == "auto":
            ips = ray_tpu_torch.get(
                [self._apply(a, _host_info) for a in self._actors],
                timeout=60)
            transport = ("shm" if len({*ips, _my_ip()}) <= 1
                         else "wire")
        from ray_tpu_torch._private.specs import SESSION_TAG

        # edge list: (writer, label) — writer None = driver process
        shm = transport == "shm"
        pending: Dict[int, list] = {}    # actor idx -> wire specs

        def make(writer_idx: Optional[int], label: str):
            if shm or writer_idx is None:
                if shm:
                    ch = Channel.create(capacity=self._capacity,
                                        n_readers=1, depth=self._depth,
                                        label=label)
                else:
                    from ray_tpu_torch.experimental.wire_channel import (
                        serve_channel)
                    ch = serve_channel(capacity=self._capacity,
                                       n_readers=1, depth=self._depth,
                                       label=label)
                self._channels.append(ch)
                return ch
            name = f"rtt_{SESSION_TAG}_wch_{uuid.uuid4().hex[:12]}"
            spec = (name, self._capacity, 1, self._depth, label)
            pending.setdefault(writer_idx, []).append(spec)
            return spec                  # placeholder: resolved below

        data_ch = make(None, "data")
        tgt_ch = make(None, "tgt")
        act = [make(s, f"act{s}") for s in range(S - 1)]
        grad = [make(s + 1, f"grad{s}") for s in range(S - 1)]
        loss_ch = make(S - 1, "loss")

        if pending:
            # one server-binding round trip per stage actor
            refs = {idx: self._apply(self._actors[idx], _serve_many,
                                     specs)
                    for idx, specs in pending.items()}
            resolved: Dict[str, WireChannel] = {}
            for idx, specs in pending.items():
                addrs = ray_tpu_torch.get(refs[idx], timeout=60)
                for spec, addr in zip(specs, addrs):
                    name, cap, nr, depth, label = spec
                    ch = WireChannel(name, cap, nr, depth, addr, label)
                    resolved[name] = ch
                    self._channels.append(ch)

            def fix(ch):
                return resolved[ch[0]] if isinstance(ch, tuple) else ch
            act = [fix(c) for c in act]
            grad = [fix(c) for c in grad]
            loss_ch = fix(loss_ch)

        self._abort = AbortFlag.create()
        self._watch = LoopWatchdog(self._loop_refs, self._abort,
                                   "pipeline stage")
        self._trace_root = _tp.new_id() if _tp.enabled() else 0

        # each stage's params travel through the object store (tensors
        # out of band), not inside the call's frame
        self._param_refs = [ray_tpu_torch.put(p) for p in self._params]
        for s, actor in enumerate(self._actors):
            last = s == S - 1
            self._loop_refs.append(self._apply(
                actor, _stage_loop, s, S, self._param_refs[s],
                self._stage_fn, self._loss_fn, self._consts,
                self._schedule, self._M, self._steps,
                data_ch if s == 0 else act[s - 1],     # in_ch
                tgt_ch if last else None,              # tgt_ch
                None if last else act[s],              # out_ch (acts)
                None if last else grad[s],             # gin_ch
                grad[s - 1] if s > 0 else None,        # gout_ch
                loss_ch if last else None,
                self._abort, self._update_fn, self._lr,
                self._trace_root, self._device))

        self._data_w = data_ch.writer()
        self._tgt_w = tgt_ch.writer()
        self._loss_r = loss_ch.reader(0)

    def _op(self, op, timeout: Optional[float], what: str):
        """Bounded-slice channel op over the shared dead-stage
        watchdog (dag_channels.LoopWatchdog): a stage dying mid-run
        surfaces HERE instead of hanging the driver, and the abort
        flag unwedges every surviving stage loop."""
        return self._watch.op(op, timeout, what)

    # -------------------------------------------------------- stepping
    def run_step(self, step: int, x, targets,
                 timeout: Optional[float] = 300.0) -> float:
        """Feed one global batch as M microbatches and return the
        step's mean microbatch loss. The driver only streams inputs
        and reads the loss — activations never cross this process."""
        x, targets = _host(x), _host(targets)
        M = self._M
        if x.shape[0] % M:
            raise ValueError(
                f"batch {x.shape[0]} not divisible into {M} "
                f"microbatches")
        bs = x.shape[0] // M
        with _tp.span("driver", f"pipeline.step:{step}",
                      ctx=(self._trace_root, 0)
                      if self._trace_root else None,
                      root=True):
            for m in range(M):
                mb = _contiguous(x[m * bs:(m + 1) * bs])
                tb = _contiguous(targets[m * bs:(m + 1) * bs])
                self._op(lambda t, v=mb: self._data_w.write(
                    v, timeout=t), timeout, "feeding microbatch")
                self._op(lambda t, v=tb: self._tgt_w.write(
                    v, timeout=t), timeout, "feeding targets")
            rep = self._op(lambda t: self._loss_r.read(t), timeout,
                           "reading step loss")
        return float(rep["loss"])

    def finish(self, timeout: float = 300.0) -> List[Any]:
        """Collect every stage's final params (trees of CPU tensors,
        ragged across stages) once all steps have been fed."""
        out = ray_tpu_torch.get(self._loop_refs, timeout=timeout)
        return out

    # -------------------------------------------------------- teardown
    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        for w in (getattr(self, "_data_w", None),
                  getattr(self, "_tgt_w", None)):
            if w is not None:
                try:
                    w.close(timeout=0.5)
                except BaseException:
                    pass
        if self._abort is not None:
            try:
                self._abort.set()
            except BaseException:
                pass
        if self._loop_refs:
            try:
                ray_tpu_torch.wait(self._loop_refs,
                             num_returns=len(self._loop_refs),
                             timeout=5.0)
            except BaseException:
                pass
        for w in (getattr(self, "_data_w", None),
                  getattr(self, "_tgt_w", None)):
            if w is not None:
                try:
                    w.release()
                except BaseException:
                    pass
        r = getattr(self, "_loss_r", None)
        if r is not None:
            try:
                r.release()
            except BaseException:
                pass
        for ch in self._channels:
            try:
                ch.destroy()
            except BaseException:
                pass
        if self._abort is not None:
            try:
                self._abort.destroy()
            except BaseException:
                pass
        self._param_refs = []

    def __del__(self):
        try:
            self.teardown()
        except BaseException:
            pass


# ---------------------------------------------------------- trainer glue
def fit_pipeline(trainer) -> "Result":
    """TorchTrainer's pipeline_stages= mode: one WorkerGroup per stage,
    layer stack partitioned by the shared helper, MPMDPipeline driving
    the schedule. Returns a normal train Result whose artifacts carry
    the reassembled layer-major params (CPU tensors). The stages run on
    their cards with `ScalingConfig(use_gpu=True)` (two stages share one
    card with `resources_per_worker={"GPU": 0.5}`), on the CPU without."""
    from ray_tpu_torch.train.config import Result
    from ray_tpu_torch.train.worker_group import WorkerGroup

    cfg = trainer._pipeline_config
    S = trainer._pipeline_stages
    if cfg is None:
        raise ValueError(
            "pipeline_stages > 1 requires pipeline_config=")
    for field in ("init_params", "stage_fn", "loss_fn", "batch_fn"):
        if getattr(cfg, field) is None:
            raise ValueError(f"PipelineConfig.{field} is required")

    parts = partition_layers(n_layers_of(cfg.init_params), S)
    stage_params = [slice_stage(cfg.init_params, start, count)
                    for start, count in parts]

    groups = []
    try:
        for s in range(S):
            g = WorkerGroup(cfg.workers_per_stage,
                            trainer._scaling.worker_resources(),
                            trainer._scaling.placement_strategy,
                            name=f"pipeline_stage_{s}")
            g.start()
            groups.append(g)
        # rank 0 of each stage group is that stage's channel endpoint;
        # intra-stage SPMD (workers_per_stage > 1 forming a mesh over a
        # process group) layers on later without changing the channel
        # topology.
        actors = [g.workers[0] for g in groups]
        pipe = MPMDPipeline(
            actors, stage_params, stage_fn=cfg.stage_fn,
            loss_fn=cfg.loss_fn, consts=cfg.consts,
            num_microbatches=cfg.num_microbatches,
            schedule=cfg.schedule, steps=cfg.steps,
            transport=cfg.transport, ring_depth=cfg.ring_depth,
            capacity=cfg.channel_capacity_bytes,
            update_fn=cfg.update_fn, lr=cfg.lr,
            device="cuda" if trainer._scaling.use_gpu else "cpu")
        pipe.start()
        history: list = []
        error: Optional[BaseException] = None
        final_params = None
        trace_procs = None
        try:
            for step in range(cfg.steps):
                x, targets = cfg.batch_fn(step)
                loss = pipe.run_step(step, x, targets)
                history.append({"step": step, "loss": loss})
            stage_out = pipe.finish()
            final_params = _layer_major(stage_out)
            # collect the cross-process timeline BEFORE the stage
            # workers are killed with their flight recorders — the
            # Result carries what task_timeline() would no longer see
            if _tp.enabled():
                try:
                    from ray_tpu_torch._private import context as _ctx
                    trace_procs = _ctx.get_ctx().state_op(
                        "trace_dump").get("processes", [])
                except Exception:
                    trace_procs = None
        except Exception as e:      # noqa: BLE001
            error = e
        finally:
            pipe.teardown()
        last = dict(history[-1]) if history else {}
        artifacts: Dict[str, Any] = {}
        if final_params is not None:
            artifacts["params"] = final_params
        if trace_procs is not None:
            artifacts["trace_processes"] = trace_procs
            bf = bubble_fraction(trace_procs)
            if bf == bf:               # not NaN
                last["bubble_fraction"] = bf
        return Result(metrics=last, checkpoint=None, path="",
                      metrics_history=history, error=error,
                      artifacts=artifacts or None)
    finally:
        for g in groups:
            g.shutdown()


def _layer_major(stage_out: List[Any]) -> Any:
    """Every stage's final params joined back into one layer-major tree:
    lists of layers are concatenated, stacked leaves joined on dim 0."""
    import torch
    from torch.utils._pytree import tree_map
    if isinstance(stage_out[0], list):
        return [layer for part in stage_out for layer in part]
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *stage_out)


# ------------------------------------------------------- trace analysis
def _stage_spans(processes, kinds=("stage",), prefixes=("fwd:", "bwd:")):
    for proc in processes:
        off = int(proc.get("offset_ns", 0))
        for ev in proc.get("events", ()):
            _, _, _, kind, name, t0, t1, _ = ev
            if kind in kinds and name.startswith(prefixes):
                yield proc, name, t0 - off, t1 - off


def bubble_fraction(processes, window=None) -> float:
    """Per-stage idle fraction from trace_dump output: for every
    process with stage compute spans, 1 - busy/wall over its own span
    window, averaged across stages. The number ENVELOPE.md's pipeline
    rows report; 1F1B's theoretical floor is (S-1)/(M+S-1). `window`
    (t0_ns, t1_ns on the collector's aligned clock) restricts the
    computation to one measured run — the bench uses it to keep
    earlier runs' spans in the shared rings out of the figure."""
    per_proc = []
    by_proc: Dict[int, list] = {}
    for proc, _, t0, t1 in _stage_spans(processes):
        if window is not None and not (window[0] <= t0
                                       and t1 <= window[1]):
            continue
        by_proc.setdefault(id(proc), []).append((t0, t1))
    for spans in by_proc.values():
        lo = min(t0 for t0, _ in spans)
        hi = max(t1 for _, t1 in spans)
        busy = sum(t1 - t0 for t0, t1 in spans)
        if hi > lo:
            per_proc.append(1.0 - busy / (hi - lo))
    if not per_proc:
        return float("nan")
    return round(sum(per_proc) / len(per_proc), 4)


def overlap_pairs(processes) -> int:
    """Count (transfer span, other-process compute span) pairs that
    overlap in time — the acceptance signal that stage N's channel
    traffic runs CONCURRENTLY with stage N±1's compute instead of
    serializing. Clocks are the collector-aligned offsets trace_dump
    already provides (same-host processes share CLOCK_MONOTONIC)."""
    compute = list(_stage_spans(processes))
    transfers = []
    for proc in processes:
        off = int(proc.get("offset_ns", 0))
        for ev in proc.get("events", ()):
            _, _, _, kind, name, t0, t1, _ = ev
            if kind == "channel" and name.startswith(
                    ("ch.write:", "ch.read:", "ch.wait:")):
                transfers.append((proc, t0 - off, t1 - off))
    count = 0
    for tp_, tt0, tt1 in transfers:
        for cp, _, ct0, ct1 in compute:
            if cp is tp_:
                continue               # different processes only
            if tt0 < ct1 and ct0 < tt1:
                count += 1
                break
    return count
