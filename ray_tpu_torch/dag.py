"""Compiled DAGs: pre-wired actor-task graphs executed as one unit.

Port of `ray_tpu/dag.py`.

Parity: reference python/ray/dag (DAGNode.bind / InputNode /
MultiOutputNode, dag.experimental_compile -> CompiledDAG:664,
execute:2118). Re-shaped for this stack: compilation validates the
graph, computes a topological schedule, and `execute()` submits EVERY
hop's actor task up front with upstream RESULT REFS wired as arguments
— workers resolve refs themselves, so consecutive hops never block on
a driver round-trip and consecutive `execute()` calls pipeline through
the actors (the property the reference gets from its persistent
per-actor exec loops; our per-actor ordered call queues provide it).

Usage::

    with InputNode() as inp:
        x = worker_a.preprocess.bind(inp)
        y = worker_b.infer.bind(x)
    dag = y.experimental_compile()
    ref = dag.execute(batch)          # one ObjectRef out
    out = ray_tpu_torch.get(ref)
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch

_CURRENT_INPUT: List["InputNode"] = []


class DAGNode:
    """Base graph node; `bind` on actor methods creates ClassMethodNode."""

    def __init__(self, upstream: List["DAGNode"]):
        self.upstream = upstream

    def experimental_compile(self, *, enable_shm_channels: bool = False,
                             buffer_size_bytes: int = 1 << 20,
                             channel_transport: str = "shm",
                             channel_ring_depth: "Optional[int]" = None):
        """Compile the graph. With enable_shm_channels=True the DAG runs
        on mutable channels: each actor gets a persistent exec loop
        reading its inputs from fixed ring slots and writing its output
        to one — per-execute cost drops to one channel write + one read
        on the driver, zero task submissions (reference CompiledDAG +
        shared_memory_channel.py). Channel mode dedicates each actor to
        the DAG until teardown().

        channel_transport picks the edge transport (r13): "shm"
        (default; mapped-shm rings, all endpoints on the driver's
        host), "wire" (direct writer->reader connections carrying
        tensors over the Envelope raw zero-copy path — works across
        hosts), or "auto" (wire only for edges whose endpoints report
        different host IPs). channel_ring_depth overrides
        RAY_TPU_CHANNEL_RING_DEPTH (slots buffered per channel; >= 2
        enables transfer/compute overlap)."""
        if enable_shm_channels:
            from ray_tpu_torch.experimental.dag_channels import (
                ChannelCompiledDAG)
            return ChannelCompiledDAG(self, buffer_size_bytes,
                                      transport=channel_transport,
                                      ring_depth=channel_ring_depth)
        return CompiledDAG(self)

    # convenience: execute without explicit compile (reference
    # dag.execute on an uncompiled DAG)
    def execute(self, *args):
        return self.experimental_compile().execute(*args)


class InputNode(DAGNode):
    """The DAG's runtime input placeholder (context manager, reference
    dag/input_node.py)."""

    def __init__(self):
        super().__init__([])

    def __enter__(self) -> "InputNode":
        _CURRENT_INPUT.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT_INPUT.pop()


class ClassMethodNode(DAGNode):
    def __init__(self, actor, method_name: str, args: Tuple,
                 kwargs: Dict):
        ups = [a for a in list(args) + list(kwargs.values())
               if isinstance(a, DAGNode)]
        super().__init__(ups)
        self.actor = actor
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__(list(outputs))
        self.outputs = list(outputs)


# --------------------------------------------------- collective nodes
def _dag_allreduce(actor_self, group_name: str, world: int, rank: int,
                   op: str, value):
    """Runs inside each participant actor via __rtpu_apply__: joins the
    DAG's named collective group on first use, then allreduces this
    participant's shard (reference torch_tensor_nccl_channel collective
    nodes; host/CPU reduction here — card collectives belong to
    torch.distributed inside one process group)."""
    from ray_tpu_torch.util import collective
    if group_name not in collective._GROUPS:
        collective.init_collective_group(world, rank,
                                         group_name=group_name)
    return collective.allreduce(value, op=op, group_name=group_name)


class _CollectiveGroup:
    """One collective op instance shared by its per-actor output nodes."""

    def __init__(self, inputs: List["ClassMethodNode"], op: str):
        import uuid
        actors = [n.actor for n in inputs]
        if len({id(a) for a in actors}) != len(actors):
            raise ValueError(
                "collective participants must be distinct actors (one "
                "rank per process; a shared actor would deadlock its "
                "ordered call queue)")
        self.inputs = list(inputs)
        self.op = op
        self.name = f"_dag_cc_{uuid.uuid4().hex[:8]}"


class CollectiveOutputNode(DAGNode):
    """Participant `index`'s reduced output. Depends on ALL shards: the
    scheduler must produce every participant's input before any reduced
    output is consumable."""

    def __init__(self, group: _CollectiveGroup, index: int):
        super().__init__(list(group.inputs))
        self.group = group
        self.index = index


def allreduce_bind(nodes: List["ClassMethodNode"],
                   op: str = "sum") -> List["CollectiveOutputNode"]:
    """Bind an allreduce across per-actor DAG nodes: returns one output
    node per participant carrying the reduced value on that actor
    (reference ray.experimental.collective.allreduce.bind). Ops: sum,
    prod, min, max, mean."""
    if not nodes:
        raise ValueError("allreduce_bind needs at least one node")
    for n in nodes:
        if not isinstance(n, ClassMethodNode):
            raise TypeError(
                "allreduce_bind participants must be actor method "
                f"nodes, got {type(n).__name__}")
    group = _CollectiveGroup(list(nodes), op)
    return [CollectiveOutputNode(group, i) for i in range(len(nodes))]


class _BoundMethod:
    def __init__(self, actor, name: str):
        self._actor = actor
        self._name = name

    def bind(self, *args, **kwargs) -> ClassMethodNode:
        return ClassMethodNode(self._actor, self._name, args, kwargs)


def bind_method(actor, method_name: str) -> _BoundMethod:
    """`actor.method.bind(...)` sugar lives on ActorMethod (see
    actor.py); this is the functional spelling."""
    return _BoundMethod(actor, method_name)


class CompiledDAG:
    """Validated + scheduled DAG, reusable across executes."""

    def __init__(self, output: DAGNode):
        self._output = output
        self._order = self._toposort(output)
        self._input = self._find_input()
        self._lock = threading.Lock()
        self._used_groups: Dict[str, _CollectiveGroup] = {}
        self.num_executions = 0
        # every participant of a collective must be reachable from the
        # output: a partially-consumed allreduce would rendezvous with
        # world=N but submit <N ranks — a guaranteed hang, caught here
        # at compile time instead
        reach: Dict[int, int] = {}
        groups: Dict[int, _CollectiveGroup] = {}
        for n in self._order:
            if isinstance(n, CollectiveOutputNode):
                reach[id(n.group)] = reach.get(id(n.group), 0) + 1
                groups[id(n.group)] = n.group
        for gid, count in reach.items():
            world = len(groups[gid].inputs)
            if count != world:
                raise ValueError(
                    f"collective group has {world} participants but "
                    f"only {count} of its output nodes are consumed by "
                    f"this DAG; bind all of them (e.g. via "
                    f"MultiOutputNode) or the allreduce rendezvous "
                    f"can never complete")

    def _toposort(self, root: DAGNode) -> List[DAGNode]:
        order: List[DAGNode] = []
        seen: Dict[int, int] = {}        # id -> 0 visiting / 1 done

        def visit(node: DAGNode) -> None:
            state = seen.get(id(node))
            if state == 1:
                return
            if state == 0:
                raise ValueError("cycle detected in DAG")
            seen[id(node)] = 0
            for up in node.upstream:
                visit(up)
            seen[id(node)] = 1
            order.append(node)

        visit(root)
        return order

    def _find_input(self) -> Optional[InputNode]:
        inputs = [n for n in self._order if isinstance(n, InputNode)]
        if len(inputs) > 1:
            raise ValueError("a DAG has at most one InputNode")
        return inputs[0] if inputs else None

    def execute(self, *args):
        """Submit the whole graph; returns the output ObjectRef (or a
        list for MultiOutputNode). Upstream results flow as refs the
        workers resolve — no driver hop between stages."""
        if self._input is not None and len(args) != 1:
            raise TypeError(
                f"DAG takes exactly 1 input, got {len(args)}")
        with self._lock:                  # per-actor ordering across hops
            values: Dict[int, Any] = {}
            if self._input is not None:
                values[id(self._input)] = args[0]
            for node in self._order:
                if isinstance(node, InputNode):
                    continue
                if isinstance(node, MultiOutputNode):
                    values[id(node)] = [values[id(o)]
                                        for o in node.outputs]
                    continue
                if isinstance(node, CollectiveOutputNode):
                    self._dispatch_collective(node.group, values)
                    continue
                resolve = (lambda v: values[id(v)]
                           if isinstance(v, DAGNode) else v)
                call_args = tuple(resolve(a) for a in node.args)
                call_kwargs = {k: resolve(v)
                               for k, v in node.kwargs.items()}
                method = getattr(node.actor, node.method_name)
                values[id(node)] = method.remote(*call_args,
                                                 **call_kwargs)
            self.num_executions += 1
            return values[id(self._output)]

    def _dispatch_collective(self, group: _CollectiveGroup,
                             values: Dict[int, Any]) -> None:
        """Submit every participant's allreduce call (once per group per
        execute); per-actor ordered queues give all ranks the same
        round sequence."""
        if any(id(n) in values for n in self._collective_outputs(group)):
            return                        # already dispatched this round
        import cloudpickle

        from ray_tpu_torch.actor import ActorMethod
        fn = cloudpickle.dumps(_dag_allreduce)
        world = len(group.inputs)
        for out in self._collective_outputs(group):
            up = group.inputs[out.index]
            method = ActorMethod(up.actor, "__rtpu_apply__", {})
            values[id(out)] = method.remote(
                fn, group.name, world, out.index, group.op,
                values[id(up)])
        self._used_groups[group.name] = group

    def _collective_outputs(self, group: _CollectiveGroup):
        return [n for n in self._order
                if isinstance(n, CollectiveOutputNode)
                and n.group is group]

    def teardown(self) -> None:
        """Kill the collective coordinators this DAG created (reference
        tears down its exec loops; plain ref-wired actors keep serving
        normal calls)."""
        for name in list(self._used_groups):
            self._used_groups.pop(name, None)
            try:
                coord = ray_tpu_torch.get_actor(f"_rtpu_collective::{name}")
                ray_tpu_torch.kill(coord)
            except Exception:
                pass
