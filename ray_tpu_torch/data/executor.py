"""Streaming executor: pull blocks through the op chain with bounded
in-flight work.

Parity: reference data/_internal/execution/streaming_executor.py:48 —
re-shaped for ray_tpu_torch: instead of an operator-graph thread juggling
actor pools, each ReadTask (+ its whole op chain) becomes ONE remote
task; the driver keeps a bounded window of them in flight and yields
blocks in task order. Backpressure falls out of the window bound: no
more than `max_in_flight` read partitions are ever materialized beyond
what the consumer has taken. Falls back to a local thread when the
runtime is not initialized (pure-local datasets in tests/tools).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, List, Optional, Tuple

from ray_tpu_torch.data.block import (Block, block_concat, block_num_rows,
                                      block_slice, normalize_batch_output)
from ray_tpu_torch.data.datasource import ReadTask

# op tuples: ("map_batches", fn, batch_size) | ("map", fn) |
#            ("filter", fn) | ("flat_map", fn)
Op = Tuple[Any, ...]


def apply_ops(blocks: Iterator[Block], ops: List[Op],
              instances: Optional[dict] = None) -> Iterator[Block]:
    """`instances` caches constructed callable-class transforms keyed by
    op position — pass a persistent dict (actor-pool workers do) so
    stateful transforms survive across partitions."""
    for i, op in enumerate(ops):
        kind = op[0]
        if kind == "map_batches":
            fn = _resolve_fn(op, i, instances)
            blocks = _apply_map_batches(blocks, fn, op[2])
        elif kind == "map":
            blocks = _apply_map(blocks, op[1])
        elif kind == "filter":
            blocks = _apply_filter(blocks, op[1])
        elif kind == "flat_map":
            blocks = _apply_flat_map(blocks, op[1])
        else:  # pragma: no cover - guarded at Dataset level
            raise ValueError(f"unknown op {kind}")
    return blocks


class ClassSpec:
    """Callable-class transform captured BY VALUE (cloudpickle) at
    map_batches() time, so classes defined in driver-only modules (test
    files, notebooks) construct fine inside workers that cannot import
    those modules."""

    def __init__(self, cls: type):
        from ray_tpu_torch._private.pickle_utils import dumps_by_value
        self.data = dumps_by_value(cls)
        self.qualname = cls.__qualname__

    def load(self) -> type:
        import cloudpickle
        return cloudpickle.loads(self.data)


def _resolve_fn(op: Op, idx: int, instances: Optional[dict]):
    """map_batches fn may be a (by-value captured) callable class:
    construct once per worker when an instance cache is provided."""
    fn = op[1]
    if not isinstance(fn, ClassSpec):
        return fn
    ctor_args = op[3] if len(op) > 3 else ()
    ctor_kwargs = op[4] if len(op) > 4 else {}

    def construct():
        return fn.load()(*ctor_args, **ctor_kwargs)

    if instances is None:
        return construct()
    key = (idx, fn.qualname)
    if key not in instances:
        instances[key] = construct()
    return instances[key]


def _apply_map_batches(blocks, fn, batch_size) -> Iterator[Block]:
    if batch_size is None:
        for b in blocks:
            if block_num_rows(b):
                yield normalize_batch_output(fn(b))
        return
    from ray_tpu_torch.data.block import rebatch_blocks
    for batch in rebatch_blocks(blocks, batch_size):
        yield normalize_batch_output(fn(batch))


def _apply_map(blocks, fn) -> Iterator[Block]:
    from ray_tpu_torch.data.block import block_from_rows, block_to_rows
    for b in blocks:
        rows = [fn(r) for r in block_to_rows(b)]
        if rows:
            yield block_from_rows(rows)


def _apply_filter(blocks, fn) -> Iterator[Block]:
    import numpy as np

    from ray_tpu_torch.data.block import block_take, block_to_rows
    for b in blocks:
        keep = np.asarray([bool(fn(r)) for r in block_to_rows(b)])
        if keep.any():
            yield block_take(b, np.nonzero(keep)[0])


def _apply_flat_map(blocks, fn) -> Iterator[Block]:
    from ray_tpu_torch.data.block import block_from_rows, block_to_rows
    for b in blocks:
        rows = []
        for r in block_to_rows(b):
            rows.extend(fn(r))
        if rows:
            yield block_from_rows(rows)


def _run_partition(task: ReadTask, ops: List[Op]) -> List[Block]:
    """Executed inside a ray_tpu_torch worker: read + transform one
    partition."""
    return [b for b in apply_ops(task(), ops) if block_num_rows(b)]


def stream_blocks(tasks: List[ReadTask], ops: List[Op],
                  max_in_flight: int = 4,
                  locality: Optional[str] = None) -> Iterator[Block]:
    """Yield blocks across all partitions, in partition order."""
    if not tasks:
        return
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        yield from _stream_local(tasks, ops)
        return

    remote_fn = ray_tpu_torch.remote(num_cpus=1)(_run_partition)
    opts = {}
    if locality:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        opts["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
            node_id=locality, soft=True)
        remote_fn = remote_fn.options(**opts)

    window: List[Any] = []
    next_submit = 0
    while next_submit < len(tasks) or window:
        while next_submit < len(tasks) and len(window) < max_in_flight:
            window.append(remote_fn.remote(tasks[next_submit], ops))
            next_submit += 1
        blocks = ray_tpu_torch.get(window.pop(0))
        for b in blocks:
            yield b


class _PoolWorker:
    """Long-lived actor that runs partition pipelines, keeping callable-
    class transform instances alive across partitions (reference
    data/_internal/execution/operators/actor_pool_map_operator.py)."""

    def __init__(self):
        self._instances: dict = {}

    def run_partition(self, task: ReadTask, ops: List[Op]) -> List[Block]:
        return [b for b in apply_ops(task(), ops, self._instances)
                if block_num_rows(b)]


def stream_blocks_actor_pool(tasks: List[ReadTask], ops: List[Op],
                             pool_size: int) -> Iterator[Block]:
    """Yield blocks in partition order, dispatching partitions to a pool
    of stateful actors (util.actor_pool handles ordered results +
    pool-width parallelism). Falls back to one local instance cache when
    the runtime is not initialized."""
    if not tasks:
        return
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        instances: dict = {}
        for t in tasks:
            for b in apply_ops(t(), ops, instances):
                if block_num_rows(b):
                    yield b
        return

    from ray_tpu_torch.util.actor_pool import ActorPool
    Actor = ray_tpu_torch.remote(num_cpus=1)(_PoolWorker)
    actors = [Actor.remote() for _ in range(pool_size)]
    try:
        pool = ActorPool(actors)
        for blocks in pool.map(
                lambda a, t: a.run_partition.remote(t, ops), tasks):
            for b in blocks:
                yield b
    finally:
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


def _stream_local(tasks: List[ReadTask], ops: List[Op]) -> Iterator[Block]:
    """Single background thread reads ahead one partition. The producer
    polls a closed flag on every put so an abandoned consumer (generator
    GC'd mid-stream) retires the thread instead of stranding it."""
    q: "queue.Queue" = queue.Queue(maxsize=2)
    SENTINEL = object()
    closed = threading.Event()

    from ray_tpu_torch.data._util import put_unless_closed

    def _put(item) -> bool:
        return put_unless_closed(q, item, closed)

    def producer():
        try:
            for t in tasks:
                for b in apply_ops(t(), ops):
                    if block_num_rows(b):
                        if not _put(b):
                            return
            _put(SENTINEL)
        except BaseException as e:  # surface in consumer
            _put(e)

    th = threading.Thread(target=producer, daemon=True,
                          name="data-producer")
    th.start()
    try:
        while True:
            item = q.get()
            if item is SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        closed.set()
