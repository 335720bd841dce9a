"""Distributed shuffle exchange for ray_tpu_torch.data.

Parity: reference python/ray/data/_internal/planner/exchange/
(ShuffleTaskSpec, sort_task_spec.py, push-based map/reduce shuffle) —
re-designed for the task API here: a map task runs one input partition
through its fused op chain and splits the rows into ``num_out`` shards
(``num_returns=num_out`` so each shard is an independently transferable
object); a reduce task takes the j-th shard of every map task as
top-level ref args and combines them. Runs in-process when the runtime
is not initialized (pure-local datasets).

Hashing is deterministic across worker processes (CRC32 / integer
mixing, never Python's per-process-salted ``hash``) so every map task
routes equal keys to the same reduce partition.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.data.block import (Block, block_concat, block_num_rows,
                                      block_take)
from ray_tpu_torch.data.datasource import ReadTask


def _hash_column(arr: np.ndarray, num_out: int) -> np.ndarray:
    """Deterministic per-row bucket assignment for one key column."""
    arr = np.asarray(arr)
    if arr.dtype.kind in "iub":
        v = arr.astype(np.uint64, copy=False)
        # Fibonacci/Knuth multiplicative mix so consecutive ints spread
        v = (v * np.uint64(0x9E3779B97F4A7C15))
        v ^= v >> np.uint64(29)
        return (v % np.uint64(num_out)).astype(np.int64)
    if arr.dtype.kind == "f":
        # +0.0 normalizes -0.0 so the equal keys share a bit pattern
        v = (arr.astype(np.float64) + 0.0).view(np.uint64)
        v = (v * np.uint64(0x9E3779B97F4A7C15))
        v ^= v >> np.uint64(29)
        return (v % np.uint64(num_out)).astype(np.int64)
    out = np.empty(len(arr), dtype=np.int64)
    for i, v in enumerate(arr):
        b = v.encode() if isinstance(v, str) else repr(v).encode()
        out[i] = zlib.crc32(b) % num_out
    return out


def hash_buckets(block: Block, keys: Sequence[str],
                 num_out: int) -> np.ndarray:
    """Bucket index per row from the combined key columns."""
    n = block_num_rows(block)
    combined = np.zeros(n, dtype=np.int64)
    for k in keys:
        h = _hash_column(block[k], 1 << 30)
        combined = (combined * 1315423911 + h) % (1 << 62)
    return (combined % num_out).astype(np.int64)


def split_by_bucket(blocks: List[Block], bucket_of: np.ndarray,
                    num_out: int) -> List[Block]:
    merged = block_concat(blocks)
    return [block_take(merged, np.nonzero(bucket_of == j)[0])
            for j in range(num_out)]


# ------------------------------------------------------------- exchange
def _map_hash(task: ReadTask, ops: list, idx: int,
              keys: Sequence[str], num_out: int) -> List[Block]:
    from ray_tpu_torch.data.executor import apply_ops
    blocks = [b for b in apply_ops(task(), ops) if block_num_rows(b)]
    if not blocks:
        return [{} for _ in range(num_out)]
    merged = block_concat(blocks)
    return split_by_bucket([merged], hash_buckets(merged, keys, num_out),
                           num_out)


def _map_range(task: ReadTask, ops: list, idx: int, key: str,
               boundaries: np.ndarray, descending: bool,
               num_out: int) -> List[Block]:
    from ray_tpu_torch.data.executor import apply_ops
    blocks = [b for b in apply_ops(task(), ops) if block_num_rows(b)]
    if not blocks:
        return [{} for _ in range(num_out)]
    merged = block_concat(blocks)
    vals = merged[key]
    idx = np.searchsorted(boundaries, vals, side="right")
    if descending:
        idx = (num_out - 1) - idx
    return split_by_bucket([merged], idx.astype(np.int64), num_out)


def _map_random(task: ReadTask, ops: list, idx: int,
                seed: Optional[int], num_out: int) -> List[Block]:
    from ray_tpu_torch.data.executor import apply_ops
    blocks = [b for b in apply_ops(task(), ops) if block_num_rows(b)]
    if not blocks:
        return [{} for _ in range(num_out)]
    merged = block_concat(blocks)
    n = block_num_rows(merged)
    # decorrelate partitions by INDEX (task names are not unique);
    # seeded runs stay deterministic
    rng = np.random.default_rng(None if seed is None else [seed, idx])
    return split_by_bucket([merged], rng.integers(0, num_out, size=n),
                           num_out)


def make_reduce_permute(seed: Optional[int]):
    def _reduce(j: int, *shards: Block) -> List[Block]:
        merged = block_concat([s for s in shards if block_num_rows(s)])
        n = block_num_rows(merged)
        if not n:
            return []
        rng = np.random.default_rng(None if seed is None else [seed, j])
        return [block_take(merged, rng.permutation(n))]
    return _reduce


def _sample_keys(task: ReadTask, ops: list, key: str,
                 max_samples: int) -> np.ndarray:
    from ray_tpu_torch.data.executor import apply_ops
    blocks = [b for b in apply_ops(task(), ops) if block_num_rows(b)]
    if not blocks:
        return np.empty(0)
    vals = np.concatenate([np.asarray(b[key]) for b in blocks])
    if len(vals) > max_samples:
        step = len(vals) // max_samples
        vals = vals[::step][:max_samples]
    return vals


def exchange(tasks: List[ReadTask], ops: list,
             map_fn: Callable[..., List[Block]], map_args: tuple,
             reduce_fn: Callable[..., List[Block]], num_out: int,
             ) -> List[ReadTask]:
    """Generic 2-stage exchange. Returns ReadTasks for the reduced
    partitions (driver holds refs; each reduce output streams on
    demand)."""
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        shard_lists = [map_fn(t, ops, i, *map_args)
                       for i, t in enumerate(tasks)]
        out = []
        for j in range(num_out):
            shards = [s[j] for s in shard_lists]
            blocks = reduce_fn(j, *shards)
            out.append(ReadTask(lambda bs=blocks: iter(bs),
                                f"exchange[{j}]"))
        return out

    if num_out == 1:
        # num_returns=1 would store the whole List[Block] as the one
        # return object; unwrap to the single shard instead
        rmap = ray_tpu_torch.remote(num_cpus=1)(_MapSingle(map_fn))
    else:
        rmap = ray_tpu_torch.remote(num_cpus=1, num_returns=num_out)(map_fn)
    rreduce = ray_tpu_torch.remote(num_cpus=1)(reduce_fn)
    shard_refs = [rmap.remote(t, ops, i, *map_args)
                  for i, t in enumerate(tasks)]
    if num_out == 1:
        shard_refs = [[r] for r in shard_refs]
    out = []
    for j in range(num_out):
        ref = rreduce.remote(j, *[s[j] for s in shard_refs])
        out.append(ReadTask(_RefRead(ref), f"exchange[{j}]"))
    return out


class _MapSingle:
    """Unwraps a map_fn's 1-element shard list for num_out == 1."""

    def __init__(self, map_fn):
        self._fn = map_fn

    def __call__(self, task, ops, idx, *args):
        return self._fn(task, ops, idx, *args)[0]


class _RefRead:
    """ReadTask body that resolves a reduce-output ref at stream time
    (inside whichever process consumes the partition)."""

    def __init__(self, ref):
        self._ref = ref

    def __call__(self):
        import ray_tpu_torch
        blocks = ray_tpu_torch.get(self._ref)
        return iter(blocks)


# ------------------------------------------------------------- reducers
def reduce_concat(j: int, *shards: Block) -> List[Block]:
    merged = block_concat([s for s in shards if block_num_rows(s)])
    return [merged] if block_num_rows(merged) else []


def make_reduce_aggregate(keys, aggs):
    from ray_tpu_torch.data.aggregate import aggregate_partition

    def _reduce(j: int, *shards: Block) -> List[Block]:
        merged = block_concat([s for s in shards if block_num_rows(s)])
        out = aggregate_partition(merged, keys, aggs)
        return [out] if block_num_rows(out) else []
    return _reduce


def make_reduce_map_groups(keys, fn):
    from ray_tpu_torch.data.aggregate import map_groups_partition

    def _reduce(j: int, *shards: Block) -> List[Block]:
        merged = block_concat([s for s in shards if block_num_rows(s)])
        return map_groups_partition(merged, keys, fn)
    return _reduce


def make_reduce_sort(key: str, descending: bool):
    def _reduce(j: int, *shards: Block) -> List[Block]:
        merged = block_concat([s for s in shards if block_num_rows(s)])
        if not block_num_rows(merged):
            return []
        order = np.argsort(merged[key], kind="stable")
        if descending:
            order = order[::-1]
        return [block_take(merged, order)]
    return _reduce


def sort_boundaries(tasks: List[ReadTask], ops: list, key: str,
                    num_out: int, max_samples_per_part: int = 256,
                    ) -> np.ndarray:
    """Stage 0 of sort: sample keys, pick num_out-1 range cut points
    (reference sort_task_spec.py SortKey sample_boundaries)."""
    import ray_tpu_torch
    if ray_tpu_torch.is_initialized():
        rs = ray_tpu_torch.remote(num_cpus=1)(_sample_keys)
        samples = ray_tpu_torch.get(
            [rs.remote(t, ops, key, max_samples_per_part) for t in tasks])
    else:
        samples = [_sample_keys(t, ops, key, max_samples_per_part)
                   for t in tasks]
    allv = np.concatenate([s for s in samples if len(s)]) if any(
        len(s) for s in samples) else np.empty(0)
    if not len(allv):
        return np.empty(0)
    qs = np.linspace(0, 1, num_out + 1)[1:-1]
    return np.quantile(np.sort(allv), qs, method="nearest") if \
        allv.dtype.kind in "iuf" else _object_quantiles(allv, num_out)


def _object_quantiles(vals: np.ndarray, num_out: int) -> np.ndarray:
    svals = np.sort(vals)
    idx = [int(len(svals) * (j + 1) / num_out) for j in range(num_out - 1)]
    return svals[np.clip(idx, 0, len(svals) - 1)]
