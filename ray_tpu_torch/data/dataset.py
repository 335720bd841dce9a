"""Dataset: lazy, streaming, shardable data pipelines.

Parity: reference python/ray/data/dataset.py:141 (Dataset, map_batches
:391, iter_batches, split, take, count) and read_api.py constructors —
re-designed for the training loop: columnar numpy blocks, remote
per-partition execution with a bounded streaming window
(executor.stream_blocks), and batches handed to the step as tensors on
its device with double-buffered host→device prefetch
(`DataIterator.iter_torch_batches`, torch_iter.py). A copy of
`ray_tpu/data/dataset.py` with that iterator in place of
`iter_jax_batches`.
"""
from __future__ import annotations

import itertools
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Union)

import numpy as np

from ray_tpu_torch.data import datasource as ds
from ray_tpu_torch.data.block import (Block, block_concat, block_num_rows,
                                      block_slice, block_take, block_to_rows)
from ray_tpu_torch.data.executor import Op, apply_ops, stream_blocks


def _irange(n: int):
    import builtins
    return builtins.range(n)


class _FusedTask:
    """Picklable read-task body with an op chain baked in (union/zip
    pipeline breakers)."""

    def __init__(self, task: ds.ReadTask, ops: List[Op]):
        self._task = task
        self._ops = ops

    def __call__(self):
        from ray_tpu_torch.data.executor import apply_ops
        return apply_ops(self._task(), self._ops)


class DataIterator:
    """One epoch-iterable view of a Dataset (reference
    data/iterator.py DataIterator). Created by `Dataset.iterator()` or
    handed to train workers by `get_dataset_shard`."""

    def __init__(self, dataset: "Dataset"):
        self._ds = dataset
        self.last_wait_s = 0.0   # input-pipeline stall accounting

    def iter_batches(self, **kw) -> Iterator[Dict[str, np.ndarray]]:
        return self._ds.iter_batches(**kw)

    def iter_torch_batches(self, **kw):
        from ray_tpu_torch.data.torch_iter import iter_torch_batches
        return iter_torch_batches(self._ds, **kw)

    def materialize(self) -> "Dataset":
        return self._ds.materialize()


class ActorPoolStrategy:
    """compute= strategy for map_batches: run the partition pipeline on a
    pool of long-lived actors so callable-class transforms keep state
    (model weights, tokenizers) across partitions. Reference
    data/_internal/compute.py ActorPoolStrategy /
    actor_pool_map_operator.py."""

    def __init__(self, size: Optional[int] = None, *,
                 min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        if size is None:
            size = max_size if max_size is not None else (
                min_size if min_size is not None else 2)
        if size < 1:
            raise ValueError("pool size must be >= 1")
        self.size = int(size)


class Dataset:
    """Lazy pipeline: read tasks + op chain, executed streaming."""

    def __init__(self, read_tasks: List[ds.ReadTask],
                 ops: Optional[List[Op]] = None,
                 max_in_flight: int = 4,
                 compute: Optional[ActorPoolStrategy] = None,
                 op_specs: Optional[list] = None):
        self._tasks = read_tasks
        self._ops: List[Op] = list(ops or [])
        self._max_in_flight = max_in_flight
        self._compute = compute
        # per-op StageSpec (or None = fuse) — parallel to _ops
        self._op_specs: list = (list(op_specs) if op_specs is not None
                                else [None] * len(self._ops))
        self._stats_sink: list = []

    # ------------------------------------------------------ transforms
    def map_batches(self, fn: Union[Callable[[Block], Dict[str, Any]], type],
                    *, batch_size: Optional[int] = None,
                    compute: Optional[ActorPoolStrategy] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    num_cpus: Optional[float] = None,
                    concurrency: Optional[int] = None,
                    ) -> "Dataset":
        """Transform batches. `fn` may be a callable class (stateful —
        constructed once per worker); pass compute=ActorPoolStrategy(n)
        to run the pipeline on a pool of n long-lived actors.

        Passing `num_cpus` and/or `concurrency` gives this op its OWN
        physical stage (per-operator streaming execution: separate
        resources, in-flight window, and backpressure — reference
        streaming_executor); `compute` then scopes the actor pool to
        just this stage instead of the whole pipeline."""
        if isinstance(fn, type):
            from ray_tpu_torch.data.executor import ClassSpec
            if compute is None:
                compute = ActorPoolStrategy(2)
            fn = ClassSpec(fn)
        op = ("map_batches", fn, batch_size, fn_constructor_args,
              fn_constructor_kwargs or {})
        if num_cpus is not None or concurrency is not None:
            from ray_tpu_torch.data.streaming import StageSpec
            spec = StageSpec(
                num_cpus=num_cpus if num_cpus is not None else 1.0,
                concurrency=concurrency if concurrency is not None else 4,
                compute=compute)
            return self._with_op(op, spec)
        out = self._with_op(op)
        if compute is not None:
            out._compute = compute
        return out

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return self._with_op(("map", fn))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        return self._with_op(("filter", fn))

    def flat_map(self, fn: Callable[[Dict], Sequence[Dict]]) -> "Dataset":
        return self._with_op(("flat_map", fn))

    def _with_op(self, op: Op, spec=None) -> "Dataset":
        return Dataset(self._tasks, self._ops + [op], self._max_in_flight,
                       self._compute, op_specs=self._op_specs + [spec])

    # ------------------------------------------- shuffle-backed relations
    def groupby(self, key: Union[str, List[str]],
                *, num_partitions: Optional[int] = None):
        """Group rows by key column(s) via a hash exchange; aggregate or
        map_groups on the result (reference dataset.py groupby)."""
        from ray_tpu_torch.data.grouped_data import GroupedData
        return GroupedData(self, key, num_partitions)

    def aggregate(self, *aggs) -> Dict[str, Any]:
        """Whole-dataset aggregation -> one dict (reference
        Dataset.aggregate)."""
        from ray_tpu_torch.data.aggregate import aggregate_global
        return aggregate_global(self.iter_blocks(), aggs)

    def sum(self, on: str):
        from ray_tpu_torch.data import aggregate as A
        return self.aggregate(A.Sum(on))[f"sum({on})"]

    def min(self, on: str):
        from ray_tpu_torch.data import aggregate as A
        return self.aggregate(A.Min(on))[f"min({on})"]

    def max(self, on: str):
        from ray_tpu_torch.data import aggregate as A
        return self.aggregate(A.Max(on))[f"max({on})"]

    def mean(self, on: str):
        from ray_tpu_torch.data import aggregate as A
        return self.aggregate(A.Mean(on))[f"mean({on})"]

    def std(self, on: str, ddof: int = 1):
        from ray_tpu_torch.data import aggregate as A
        return self.aggregate(A.Std(on, ddof=ddof))[f"std({on})"]

    def unique(self, on: str) -> List[Any]:
        """Distinct values of a column (reference Dataset.unique)."""
        rows = self.groupby(on).count().take_all()
        return [r[on] for r in rows]

    def sort(self, key: str, *, descending: bool = False,
             num_partitions: Optional[int] = None) -> "Dataset":
        """Global sort by one column: sample range boundaries, range-
        exchange, sort each output partition (reference Dataset.sort /
        _internal/planner/exchange/sort_task_spec.py)."""
        from ray_tpu_torch.data import shuffle as sh
        num_out = num_partitions or max(1, min(self.num_partitions(), 8))
        bounds = sh.sort_boundaries(self._tasks, self._ops, key, num_out)
        if not len(bounds):
            num_out = 1
        tasks = sh.exchange(
            self._tasks, self._ops,
            sh._map_range, (key, bounds, descending, num_out),
            sh.make_reduce_sort(key, descending), num_out)
        return Dataset(tasks)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_partitions: Optional[int] = None) -> "Dataset":
        """Global random shuffle: rows are hash-scattered to random
        partitions, then permuted within each (reference
        Dataset.random_shuffle)."""
        from ray_tpu_torch.data import shuffle as sh
        num_out = num_partitions or max(1, self.num_partitions())
        tasks = sh.exchange(
            self._tasks, self._ops,
            sh._map_random, (seed, num_out),
            sh.make_reduce_permute(seed), num_out)
        return Dataset(tasks)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise join of two row-aligned datasets (reference
        Dataset.zip); duplicate column names from `other` get a _1
        suffix."""
        left, right = self, other

        def _zipped():
            from ray_tpu_torch.data.block import rebatch_blocks
            CHUNK = 4096
            lit = rebatch_blocks(left.iter_blocks(), CHUNK)
            rit = rebatch_blocks(right.iter_blocks(), CHUNK)
            lbuf: Block = {}
            rbuf: Block = {}
            while True:
                if not block_num_rows(lbuf):
                    lbuf = next(lit, {})
                if not block_num_rows(rbuf):
                    rbuf = next(rit, {})
                ln, rn = block_num_rows(lbuf), block_num_rows(rbuf)
                if not ln or not rn:
                    if ln != rn:
                        raise ValueError(
                            "zip(): datasets have different row counts")
                    return
                n = min(ln, rn)
                out = dict(block_slice(lbuf, 0, n))
                for k, v in block_slice(rbuf, 0, n).items():
                    out[k if k not in out else f"{k}_1"] = v
                yield out
                lbuf = block_slice(lbuf, n, ln)
                rbuf = block_slice(rbuf, n, rn)

        return Dataset([ds.ReadTask(_zipped, "zip")])

    def union(self, *others: "Dataset") -> "Dataset":
        """Row-concatenate datasets (reference Dataset.union). Each
        input's op chain is fused into its read tasks so the combined
        dataset has a single empty chain."""
        tasks: List[ds.ReadTask] = []
        for d in (self, *others):
            tasks.extend(d._fused_tasks())
        return Dataset(tasks)

    def _fused_tasks(self) -> List[ds.ReadTask]:
        """Read tasks with this dataset's op chain baked in."""
        if not self._ops:
            return list(self._tasks)
        ops = list(self._ops)
        return [ds.ReadTask(_FusedTask(t, ops), f"fused[{t.name}]")
                for t in self._tasks]

    # --------------------------------------------------------- sharding
    def split(self, n: int, *, locality_hints=None) -> List["Dataset"]:
        """Round-robin the read partitions into n sub-datasets (the
        per-train-worker shard primitive; reference streaming_split).
        Partitions, not rows, are the split unit — use enough input
        files/blocks (override_num_blocks) for even shards."""
        if n <= 0:
            raise ValueError("n must be positive")
        if len(self._tasks) < n:
            raise ValueError(
                f"cannot split {len(self._tasks)} partitions into {n} "
                f"shards; re-read with override_num_blocks>={n}")
        return [Dataset(self._tasks[i::n], list(self._ops),
                        self._max_in_flight, self._compute,
                        op_specs=self._op_specs)
                for i in _irange(n)]

    def repartition(self, n: int) -> "Dataset":
        """Materialize and re-block into exactly n row-range partitions
        (driver-resident; use for small datasets or to enable split(n)
        when the input had fewer files than workers)."""
        blocks = list(self.iter_blocks())
        merged = block_concat(blocks)
        total = block_num_rows(merged)
        if total == 0:
            raise ValueError("cannot repartition an empty dataset")
        bounds = np.linspace(0, total, n + 1, dtype=int)
        tasks = []
        for i in _irange(n):
            chunk = block_slice(merged, int(bounds[i]), int(bounds[i + 1]))
            tasks.append(ds.ReadTask(lambda c=chunk: iter([c]),
                                     f"repartition[{i}]"))
        return Dataset(tasks)

    def iterator(self) -> DataIterator:
        return DataIterator(self)

    # ------------------------------------------------------ consumption
    def iter_blocks(self) -> Iterator[Block]:
        if any(s is not None for s in self._op_specs):
            from ray_tpu_torch.data.streaming import execute_streaming
            return execute_streaming(self._tasks, self._ops,
                                     self._op_specs,
                                     stage0_compute=self._compute,
                                     stats_sink=self._stats_sink)
        if self._compute is not None:
            from ray_tpu_torch.data.executor import stream_blocks_actor_pool
            return stream_blocks_actor_pool(
                self._tasks, self._ops, pool_size=self._compute.size)
        return stream_blocks(self._tasks, self._ops,
                             max_in_flight=self._max_in_flight)

    def stats(self):
        """Per-stage execution stats of the last streaming (per-op
        staged) iteration, or None (reference Dataset.stats())."""
        return self._stats_sink[-1] if self._stats_sink else None

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for b in self.iter_blocks():
            yield from block_to_rows(b)

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False,
                     local_shuffle_buffer_size: int = 0,
                     seed: Optional[int] = None,
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Stream fixed-size row batches; optional streaming shuffle via
        a reservoir buffer (reference iter_batches
        local_shuffle_buffer_size semantics)."""
        from ray_tpu_torch.data.block import rebatch_blocks
        blocks = self.iter_blocks()
        if local_shuffle_buffer_size:
            blocks = _shuffle_blocks(blocks, local_shuffle_buffer_size,
                                     seed)
        yield from rebatch_blocks(blocks, batch_size, drop_last=drop_last)

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        return list(itertools.islice(self.iter_rows(), n))

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def schema(self) -> Dict[str, str]:
        for b in self.iter_blocks():
            return {k: str(v.dtype) for k, v in b.items()}
        return {}

    def materialize(self) -> "Dataset":
        """Execute now; the result is a Dataset over in-memory blocks."""
        blocks = list(self.iter_blocks())
        # one task per materialized block keeps split() usable
        tasks = []
        for i, blk in enumerate(blocks):
            tasks.append(ds.ReadTask(
                lambda b=blk: iter([b]), f"materialized[{i}]"))
        return Dataset(tasks)

    # ----------------------------------------------------------- output
    def write_jsonl(self, path: str) -> List[str]:
        return ds.write_jsonl(self.iter_blocks(), path)

    def write_parquet(self, path: str) -> List[str]:
        return ds.write_parquet(self.iter_blocks(), path)

    def write_csv(self, path: str) -> List[str]:
        return ds.write_csv(self.iter_blocks(), path)

    def write_tfrecords(self, path: str) -> List[str]:
        return ds.write_tfrecords(self.iter_blocks(), path)

    # ------------------------------------------------------------ misc
    def num_partitions(self) -> int:
        return len(self._tasks)

    def __repr__(self) -> str:
        ops = " -> ".join(o[0] for o in self._ops) or "read"
        return (f"Dataset(partitions={len(self._tasks)}, plan={ops})")


def _shuffle_blocks(blocks: Iterator[Block], buffer_rows: int,
                    seed: Optional[int]) -> Iterator[Block]:
    """Streaming shuffle: fill a row buffer, emit random halves."""
    rng = np.random.default_rng(seed)
    buf: List[Block] = []
    have = 0
    for b in blocks:
        buf.append(b)
        have += block_num_rows(b)
        if have >= buffer_rows:
            merged = block_concat(buf)
            perm = rng.permutation(have)
            emit = have // 2          # keep half buffered for mixing
            yield block_take(merged, perm[:emit])
            buf = [block_take(merged, perm[emit:])]
            have -= emit
    if have:
        merged = block_concat(buf)
        yield block_take(merged, rng.permutation(have))


# ------------------------------------------------------------ read API
def range(n: int, *, override_num_blocks: int = 8) -> Dataset:  # noqa: A001
    return Dataset(ds.range_tasks(n, override_num_blocks))


def from_items(items: List[Any], *, override_num_blocks: int = 8) -> Dataset:
    return Dataset(ds.items_tasks(items, override_num_blocks))


def read_json(paths, *, rows_per_block: int = 4096) -> Dataset:
    return Dataset(ds.jsonl_tasks(paths, rows_per_block))


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 rows_per_block: int = 65536) -> Dataset:
    return Dataset(ds.parquet_tasks(paths, columns, rows_per_block))


def read_csv(paths, *, rows_per_block: int = 65536) -> Dataset:
    return Dataset(ds.csv_tasks(paths, rows_per_block))


def read_text(paths, *, rows_per_block: int = 65536) -> Dataset:
    return Dataset(ds.text_tasks(paths, rows_per_block))


def read_binary_files(paths, *, include_paths: bool = True) -> Dataset:
    return Dataset(ds.binary_tasks(paths, include_paths))


def read_images(paths, *, size=None, mode: str = "RGB",
                include_paths: bool = False) -> Dataset:
    return Dataset(ds.image_tasks(paths, size, mode, include_paths))


def read_tfrecords(paths, *, rows_per_block: int = 4096) -> Dataset:
    return Dataset(ds.tfrecord_tasks(paths, rows_per_block))


def from_numpy(arrays: Dict[str, np.ndarray], *,
               override_num_blocks: int = 8) -> Dataset:
    import builtins
    n = len(next(iter(arrays.values())))
    num = max(1, min(override_num_blocks, n))
    bounds = np.linspace(0, n, num + 1, dtype=int)
    tasks = []
    for i in builtins.range(num):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        chunk = {k: v[lo:hi] for k, v in arrays.items()}
        tasks.append(ds.ReadTask(lambda c=chunk: iter([c]),
                                 f"numpy[{lo}:{hi}]"))
    return Dataset(tasks)
