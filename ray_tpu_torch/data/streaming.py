"""Per-operator streaming execution: stages with their own resources,
concurrency, and backpressure.

Parity: reference data/_internal/execution/streaming_executor.py +
resource_manager.py + backpressure_policy/ — re-shaped for ray_tpu_torch.
The default executor (executor.py) fuses the whole op chain into one
task per read partition: optimal when every op is cheap and uniform.
When an op declares its own resources (`map_batches(..., num_cpus=4)`,
`concurrency=2`, or a per-op `ActorPoolStrategy`), the plan splits
into physical *stages* at each declared boundary; blocks flow between
stages as object refs (workers fetch them directly — the driver never
materializes intermediate blocks), each stage keeps its own bounded
in-flight window, and a stage may only run ahead of its consumer by a
bounded backlog — so a fast reader cannot flood the object store while
a slow GPU-heavy stage drains (the reference's
OutputBudgetBackpressurePolicy, expressed as queue bounds).

Scheduling order is downstream-first (reference streaming_executor
picks the operator closest to the output), and output order is
deterministic: every stage consumes and emits in submission order.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional

from ray_tpu_torch.data.block import Block, block_num_rows
from ray_tpu_torch.data.executor import apply_ops

Op = Any


@dataclass
class StageSpec:
    """Physical requirements of one pipeline stage."""
    num_cpus: float = 1.0
    concurrency: int = 4          # max in-flight tasks for this stage
    compute: Any = None           # ActorPoolStrategy -> stateful pool


def plan_stages(ops: List[Op], specs: List[Optional[StageSpec]],
                stage0_compute=None):
    """Split the op chain into (ops, spec) stages. An op with an
    explicit spec starts a new stage; spec-less ops fuse into the
    current stage (reference fusion rule: same-resource ops fuse).
    `stage0_compute` carries the dataset-level ActorPoolStrategy so
    stateful callable-class transforms fused into stage 0 still run on
    a persistent pool (one instance per pool worker, not per task)."""
    stages: List[tuple] = [([], StageSpec(compute=stage0_compute))]
    for op, spec in zip(ops, specs):
        if spec is not None:
            stages.append(([op], spec))
        else:
            stages[-1][0].append(op)
    return stages


def _run_stage(inp, ops: List[Op]) -> List[Block]:
    """One stage task: input is a ReadTask (stage 0) or the resolved
    block list from an upstream stage's object ref."""
    it = inp() if callable(inp) else iter(inp)
    return [b for b in apply_ops(it, ops) if block_num_rows(b)]


class _StageWorker:
    """Pool actor for stages with compute=ActorPoolStrategy: keeps
    callable-class transform instances alive across inputs."""

    def __init__(self):
        self._instances: dict = {}

    def run_stage(self, inp, ops: List[Op]) -> List[Block]:
        it = inp() if callable(inp) else iter(inp)
        return [b for b in apply_ops(it, ops, self._instances)
                if block_num_rows(b)]


class _StageState:
    def __init__(self, idx: int, ops: List[Op], spec: StageSpec):
        self.idx = idx
        self.ops = ops
        self.spec = spec
        self.pending: deque = deque()    # undispatched inputs
        self.inflight: deque = deque()   # (out_ref, in_ref, actor, t0)
        self.done: deque = deque()       # completed out_refs, in order
        self.input_done = False
        self.actors: list = []
        self.free_actors: deque = deque()
        self.stats = {"tasks": 0, "task_s": 0.0, "blocks_out": 0}

    def drained(self) -> bool:
        return (self.input_done and not self.pending
                and not self.inflight and not self.done)


class ExecutionStats:
    """Per-stage task counts + cumulative task seconds of the last
    streaming execution (reference Dataset.stats()).

    `task_s` is wall time IN FLIGHT (dispatch -> completion), so it
    includes queue and worker-spawn time, not just execution;
    `blocks_out` is counted only for the terminal stage (intermediate
    blocks flow worker-to-worker as refs and are never materialized on
    the driver)."""

    def __init__(self, stages: List[_StageState], wall_s: float):
        self.wall_s = wall_s
        self.stages = [
            {"stage": i,
             "ops": [op[0] for op in st.ops] or ["read"],
             "num_cpus": st.spec.num_cpus,
             "concurrency": st.spec.concurrency,
             "actor_pool": bool(st.spec.compute),
             **st.stats}
            for i, st in enumerate(stages)]

    def __repr__(self) -> str:
        lines = [f"ExecutionStats(wall={self.wall_s:.2f}s)"]
        for s in self.stages:
            kind = "pool" if s["actor_pool"] else "tasks"
            lines.append(
                f"  stage {s['stage']} {'+'.join(s['ops'])} [{kind} "
                f"x{s['concurrency']}, cpus={s['num_cpus']}]: "
                f"{s['tasks']} tasks, {s['task_s']:.2f} task-s, "
                f"{s['blocks_out']} blocks")
        return "\n".join(lines)


def execute_streaming(read_tasks: List[Any], ops: List[Op],
                      specs: List[Optional[StageSpec]],
                      max_backlog: int = 8,
                      stage0_compute=None,
                      stats_sink: Optional[list] = None,
                      ) -> Iterator[Block]:
    """Yield output blocks of the staged pipeline, in partition order."""
    import ray_tpu_torch
    plan = plan_stages(ops, specs, stage0_compute)
    if not read_tasks:
        return
    if not ray_tpu_torch.is_initialized():
        # local fallback: run stages sequentially in-process; one shared
        # instances dict so callable-class state persists across
        # partitions (like a 1-worker pool)
        instances: dict = {}
        blocks: Any = None
        for i, (stage_ops, _spec) in enumerate(plan):
            if i == 0:
                out: List[Block] = []
                for t in read_tasks:
                    it = t()
                    out.extend(b for b in apply_ops(it, stage_ops,
                                                    instances)
                               if block_num_rows(b))
            else:
                out = [b for b in apply_ops(iter(blocks), stage_ops,
                                            instances)
                       if block_num_rows(b)]
            blocks = out
        yield from blocks
        return

    t_start = time.time()
    stages = [_StageState(i, stage_ops, spec)
              for i, (stage_ops, spec) in enumerate(plan)]
    stages[0].pending.extend(read_tasks)
    stages[0].input_done = True

    task_fns = {}
    for st in stages:
        if st.spec.compute is not None:
            Actor = ray_tpu_torch.remote(
                num_cpus=st.spec.num_cpus)(_StageWorker)
            st.actors = [Actor.remote()
                         for _ in range(st.spec.compute.size)]
            st.free_actors.extend(st.actors)
        else:
            task_fns[st.idx] = ray_tpu_torch.remote(
                num_cpus=st.spec.num_cpus)(_run_stage)

    try:
        while True:
            progressed = False
            # harvest head-of-line completions (order-preserving)
            for st in stages:
                while st.inflight:
                    ready, _ = ray_tpu_torch.wait([st.inflight[0][0]],
                                                  num_returns=1, timeout=0)
                    if not ready:
                        break
                    out_ref, _in_ref, actor, t0 = st.inflight.popleft()
                    st.stats["task_s"] += time.time() - t0
                    if actor is not None:
                        st.free_actors.append(actor)
                    st.done.append(out_ref)
                    progressed = True
            # propagate downstream, bounded so backpressure chains up
            for i in range(len(stages) - 1):
                st, nxt = stages[i], stages[i + 1]
                cap = nxt.spec.concurrency * 2
                while st.done and (len(nxt.pending)
                                   + len(nxt.inflight)) < cap:
                    nxt.pending.append(st.done.popleft())
                if (st.input_done and not st.pending
                        and not st.inflight and not st.done):
                    nxt.input_done = True
            # dispatch, downstream-first
            for st in reversed(stages):
                while (st.pending
                       and len(st.inflight) < st.spec.concurrency
                       and (len(st.done) + len(st.inflight))
                       < max_backlog
                       and (st.spec.compute is None
                            or st.free_actors)):
                    inp = st.pending.popleft()
                    if st.spec.compute is not None:
                        actor = st.free_actors.popleft()
                        ref = actor.run_stage.remote(inp, st.ops)
                    else:
                        actor = None
                        ref = task_fns[st.idx].remote(inp, st.ops)
                    st.inflight.append((ref, inp, actor, time.time()))
                    st.stats["tasks"] += 1
                    progressed = True
            # emit finished output
            last = stages[-1]
            while last.done:
                for b in ray_tpu_torch.get(last.done.popleft()):
                    last.stats["blocks_out"] += 1
                    yield b
                progressed = True
            if last.drained():
                break
            if not progressed:
                heads = [st.inflight[0][0] for st in stages
                         if st.inflight]
                if heads:
                    ray_tpu_torch.wait(heads, num_returns=1)
    finally:
        for st in stages:
            for a in st.actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
        if stats_sink is not None:
            stats_sink.append(
                ExecutionStats(stages, time.time() - t_start))
