"""GroupedData: the result of ``Dataset.groupby``.

Parity: reference python/ray/data/grouped_data.py (GroupedData.aggregate,
count/sum/min/max/mean/std, map_groups) — implemented as a hash exchange
(shuffle.py) that co-locates each key's rows in one reduce partition,
then vectorized per-partition aggregation (aggregate.py).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

from ray_tpu_torch.data import aggregate as agg_mod
from ray_tpu_torch.data import shuffle as sh


def _as_keys(key: Union[str, Sequence[str]]) -> List[str]:
    return [key] if isinstance(key, str) else list(key)


class GroupedData:
    def __init__(self, dataset, key: Union[str, Sequence[str]],
                 num_partitions: Optional[int] = None):
        self._ds = dataset
        self._keys = _as_keys(key)
        self._num_parts = num_partitions

    def _exchange(self, reduce_fn) -> "Any":
        from ray_tpu_torch.data.dataset import Dataset
        ds = self._ds
        num_out = self._num_parts or max(1, min(ds.num_partitions(), 8))
        tasks = sh.exchange(
            ds._tasks, ds._ops,
            sh._map_hash, (self._keys, num_out),
            reduce_fn, num_out)
        return Dataset(tasks)

    def aggregate(self, *aggs: agg_mod.AggregateFn):
        """One output row per distinct key with a column per aggregate."""
        if not aggs:
            raise ValueError("aggregate() needs at least one AggregateFn")
        return self._exchange(
            sh.make_reduce_aggregate(self._keys, list(aggs)))

    def map_groups(self, fn: Callable) -> "Any":
        """Run `fn(group_block) -> dict-of-columns` once per key group."""
        return self._exchange(sh.make_reduce_map_groups(self._keys, fn))

    # convenience aggregates (reference grouped_data.py:244-400)
    def count(self):
        return self.aggregate(agg_mod.Count())

    def sum(self, on: str):
        return self.aggregate(agg_mod.Sum(on))

    def min(self, on: str):
        return self.aggregate(agg_mod.Min(on))

    def max(self, on: str):
        return self.aggregate(agg_mod.Max(on))

    def mean(self, on: str):
        return self.aggregate(agg_mod.Mean(on))

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(agg_mod.Std(on, ddof=ddof))
