"""Grouped and global aggregation for ray_tpu_torch.data.

Parity: reference python/ray/data/aggregate.py (AggregateFn, Count, Sum,
Min, Max, Mean, Std) and grouped_data.py — re-designed columnar: after a
hash exchange co-locates each key's rows in one partition (shuffle.py),
aggregation is vectorized with sort + ``np.*.reduceat`` over group
boundaries instead of the reference's per-row accumulate loop.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.data.block import Block, block_concat, block_num_rows


class AggregateFn:
    """One aggregation over an (optional) input column.

    Subclasses define the vectorized segment reduction
    (``reduce_segments``) used on sorted-by-key partitions, plus
    ``merge``/``finalize`` so global (ungrouped) aggregation can combine
    per-partition partials.
    """

    def __init__(self, on: Optional[str] = None,
                 alias_name: Optional[str] = None):
        self.on = on
        self._alias = alias_name

    @property
    def name(self) -> str:
        if self._alias:
            return self._alias
        tag = self.__class__.__name__.lower()
        return f"{tag}({self.on or ''})"

    def _col(self, block: Block) -> np.ndarray:
        if self.on is None:
            raise ValueError(f"{self.__class__.__name__} needs on=<column>")
        if self.on not in block:
            raise KeyError(f"aggregate column {self.on!r} not in block "
                           f"(have {list(block)})")
        return np.asarray(block[self.on], dtype=np.float64)

    # --- vectorized path: values sorted by key, starts = group offsets
    def reduce_segments(self, block: Block,
                        starts: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # --- partial path (global aggregates across partitions)
    def partial(self, block: Block) -> Any:
        raise NotImplementedError

    def merge(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def finalize(self, acc: Any) -> Any:
        return acc


class Count(AggregateFn):
    """Row count (reference aggregate.py Count)."""

    def __init__(self, alias_name: Optional[str] = None):
        super().__init__(on=None, alias_name=alias_name)

    @property
    def name(self) -> str:
        return self._alias or "count()"

    def reduce_segments(self, block, starts):
        n = block_num_rows(block)
        ends = np.append(starts[1:], n)
        return (ends - starts).astype(np.int64)

    def partial(self, block):
        return block_num_rows(block)

    def merge(self, a, b):
        return a + b


class Sum(AggregateFn):
    def reduce_segments(self, block, starts):
        return np.add.reduceat(self._col(block), starts)

    def partial(self, block):
        return float(self._col(block).sum())

    def merge(self, a, b):
        return a + b


class Min(AggregateFn):
    def reduce_segments(self, block, starts):
        return np.minimum.reduceat(self._col(block), starts)

    def partial(self, block):
        return float(self._col(block).min())

    def merge(self, a, b):
        return min(a, b)


class Max(AggregateFn):
    def reduce_segments(self, block, starts):
        return np.maximum.reduceat(self._col(block), starts)

    def partial(self, block):
        return float(self._col(block).max())

    def merge(self, a, b):
        return max(a, b)


class Mean(AggregateFn):
    def reduce_segments(self, block, starts):
        vals = self._col(block)
        ends = np.append(starts[1:], len(vals))
        return np.add.reduceat(vals, starts) / (ends - starts)

    def partial(self, block):
        v = self._col(block)
        return (float(v.sum()), len(v))

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def finalize(self, acc):
        return acc[0] / acc[1] if acc[1] else float("nan")


class Std(AggregateFn):
    """Sample standard deviation (ddof=1 default, like the reference)."""

    def __init__(self, on: Optional[str] = None, ddof: int = 1,
                 alias_name: Optional[str] = None):
        super().__init__(on=on, alias_name=alias_name)
        self.ddof = ddof

    def reduce_segments(self, block, starts):
        # shifted two-pass: subtract each segment's mean before squaring
        # (naive sum-of-squares loses all precision when |mean| >> std)
        vals = self._col(block)
        ends = np.append(starts[1:], len(vals))
        n = (ends - starts).astype(np.float64)
        mean = np.add.reduceat(vals, starts) / n
        dev = vals - np.repeat(mean, (ends - starts))
        m2 = np.add.reduceat(dev * dev, starts)
        var = m2 / np.maximum(n - self.ddof, 1e-12)
        var = np.where(n > self.ddof, np.maximum(var, 0.0), np.nan)
        return np.sqrt(var)

    def partial(self, block):
        v = self._col(block)
        m = float(v.mean())
        return (len(v), m, float(((v - m) ** 2).sum()))

    def merge(self, a, b):
        # Chan et al. parallel variance merge of (n, mean, M2) partials
        na, ma, m2a = a
        nb, mb, m2b = b
        n = na + nb
        d = mb - ma
        return (n, ma + d * nb / n, m2a + m2b + d * d * na * nb / n)

    def finalize(self, acc):
        n, _, m2 = acc
        if n <= self.ddof:
            return float("nan")
        return float(np.sqrt(max(m2 / (n - self.ddof), 0.0)))


class AbsMax(AggregateFn):
    def reduce_segments(self, block, starts):
        return np.maximum.reduceat(np.abs(self._col(block)), starts)

    def partial(self, block):
        return float(np.abs(self._col(block)).max())

    def merge(self, a, b):
        return max(a, b)


# --------------------------------------------------------------- engine
def sort_block_by_keys(block: Block,
                       keys: Sequence[str]) -> Tuple[Block, np.ndarray]:
    """Stable-sort a block by key column(s); return (sorted_block,
    group_start_offsets)."""
    n = block_num_rows(block)
    if n == 0:
        return block, np.empty(0, dtype=np.int64)
    cols = [np.asarray(block[k]) for k in keys]
    order = np.lexsort(tuple(reversed(cols)))
    sorted_block = {k: v[order] for k, v in block.items()}
    skeys = [c[order] for c in cols]
    change = np.zeros(n, dtype=bool)
    change[0] = True
    for c in skeys:
        change[1:] |= c[1:] != c[:-1]
    return sorted_block, np.nonzero(change)[0]


def aggregate_partition(block: Block, keys: Sequence[str],
                        aggs: Sequence[AggregateFn]) -> Block:
    """All rows for any given key must already be in `block` (post
    hash-exchange). Returns one row per distinct key."""
    if block_num_rows(block) == 0:
        return {}
    sblock, starts = sort_block_by_keys(block, keys)
    out: Block = {k: sblock[k][starts] for k in keys}
    for agg in aggs:
        out[agg.name] = np.asarray(agg.reduce_segments(sblock, starts))
    return out


def aggregate_global(blocks: Any,
                     aggs: Sequence[AggregateFn]) -> Dict[str, Any]:
    """Ungrouped aggregation over a full dataset (Dataset.aggregate)."""
    accs: List[Any] = [None] * len(aggs)
    for b in blocks:
        if not block_num_rows(b):
            continue
        for i, agg in enumerate(aggs):
            p = agg.partial(b)
            accs[i] = p if accs[i] is None else agg.merge(accs[i], p)
    return {agg.name: (None if accs[i] is None else agg.finalize(accs[i]))
            for i, agg in enumerate(aggs)}


def map_groups_partition(block: Block, keys: Sequence[str],
                         fn: Callable[[Block], Any]) -> List[Block]:
    """Run `fn` once per key-group (rows of that group as a Block)."""
    from ray_tpu_torch.data.block import block_slice, normalize_batch_output
    if block_num_rows(block) == 0:
        return []
    sblock, starts = sort_block_by_keys(block, keys)
    n = block_num_rows(sblock)
    ends = np.append(starts[1:], n)
    out = []
    for lo, hi in zip(starts, ends):
        res = fn(block_slice(sblock, int(lo), int(hi)))
        if res is not None:
            blk = normalize_batch_output(res)
            if block_num_rows(blk):
                out.append(blk)
    return out
