"""Columnar block primitives for ray_tpu_torch.data.

A Block is a dict[str, np.ndarray] whose arrays share their first
dimension (the row count). This is the replacement for the
reference's pyarrow Block (reference python/ray/data/block.py): token
pipelines want contiguous numpy that `torch.from_numpy` takes without
a format hop, and pyarrow remains available at the datasource edge for
parquet IO.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]


def block_num_rows(block: Block) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_from_rows(rows: List[Dict[str, Any]]) -> Block:
    """Rows (list of dicts) -> columnar block.

    Rows may have heterogeneous key sets (optional JSONL fields are the
    norm): columns are the UNION of keys, absent values become None (the
    column is then object-dtyped), mirroring the reference's null-filling
    pyarrow conversion."""
    if not rows:
        return {}
    keys: List[str] = []
    seen = set()
    for r in rows:
        for k in r:
            if k not in seen:
                seen.add(k)
                keys.append(k)
    cols: Dict[str, list] = {
        k: [r.get(k) for r in rows] for k in keys}
    return {k: _to_array(v) for k, v in cols.items()}


def _to_array(values: list) -> np.ndarray:
    def _object_array():
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out

    if any(v is None for v in values):   # nullable column
        return _object_array()
    first = values[0]
    if isinstance(first, np.ndarray):
        try:
            return np.stack(values)
        except ValueError:          # ragged: keep as object array
            return _object_array()
    arr = np.asarray(values)
    if arr.dtype.kind in ("U", "S"):
        arr = arr.astype(object)
    return arr


def block_to_rows(block: Block) -> Iterable[Dict[str, Any]]:
    n = block_num_rows(block)
    keys = list(block)
    for i in range(n):
        yield {k: block[k][i] for k in keys}


def block_slice(block: Block, start: int, stop: int) -> Block:
    return {k: v[start:stop] for k, v in block.items()}


def block_take(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def block_concat(blocks: List[Block]) -> Block:
    """Concatenate blocks row-wise. Key sets may differ between blocks
    (a nullable column can be absent from a whole chunk): columns are
    the union, absent stretches are None-filled object columns —
    consistent with block_from_rows' row-level semantics."""
    blocks = [b for b in blocks if block_num_rows(b)]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return blocks[0]
    keys: List[str] = []
    seen = set()
    for b in blocks:
        for k in b:
            if k not in seen:
                seen.add(k)
                keys.append(k)

    def col(b: Block, k: str) -> np.ndarray:
        if k in b:
            return b[k]
        filler = np.empty(block_num_rows(b), dtype=object)
        filler[:] = None
        return filler

    def obj_rows(c: np.ndarray) -> np.ndarray:
        """(n, ...) array -> (n,) object array of row sub-arrays, so a
        multi-dim column can concat with a None-filled stretch."""
        if c.dtype == object and c.ndim == 1:
            return c
        out = np.empty(len(c), dtype=object)
        for i in range(len(c)):
            out[i] = c[i]
        return out

    out: Block = {}
    for k in keys:
        cols = [col(b, k) for b in blocks]
        if any(c.dtype == object or c.ndim != cols[0].ndim
               for c in cols):
            cols = [obj_rows(c) for c in cols]
        out[k] = np.concatenate(cols)
    return out


def rebatch_blocks(blocks: Iterable[Block], batch_size: int,
                   drop_last: bool = False) -> Iterable[Block]:
    """Re-chunk a block stream into fixed-size row batches (the shared
    engine behind Dataset.iter_batches and map_batches(batch_size=...))."""
    buf: List[Block] = []
    have = 0
    for b in blocks:
        n = block_num_rows(b)
        if not n:
            continue
        buf.append(b)
        have += n
        while have >= batch_size:
            merged = block_concat(buf)
            yield block_slice(merged, 0, batch_size)
            rest = block_slice(merged, batch_size, have)
            have = block_num_rows(rest)
            buf = [rest] if have else []
    if have and not drop_last:
        yield block_concat(buf)


def validate_block(block: Block) -> None:
    lengths = {k: len(v) for k, v in block.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(f"ragged block: column lengths {lengths}")


def normalize_batch_output(out: Any) -> Block:
    """map_batches user fns may return dict of arrays/lists."""
    if not isinstance(out, dict):
        raise TypeError(
            f"map_batches fn must return a dict of columns, got "
            f"{type(out).__name__}")
    block = {k: (v if isinstance(v, np.ndarray) else _to_array(list(v)))
             for k, v in out.items()}
    validate_block(block)
    return block


class BlockMetadata:
    """Size/row accounting carried with each block (reference
    data/block.py BlockMetadata, trimmed to what the executor uses)."""

    __slots__ = ("num_rows", "size_bytes", "input_files")

    def __init__(self, num_rows: int, size_bytes: int,
                 input_files: Optional[List[str]] = None):
        self.num_rows = num_rows
        self.size_bytes = size_bytes
        self.input_files = input_files or []

    @staticmethod
    def of(block: Block,
           input_files: Optional[List[str]] = None) -> "BlockMetadata":
        size = sum(v.nbytes if isinstance(v, np.ndarray) else 0
                   for v in block.values())
        return BlockMetadata(block_num_rows(block), size, input_files)
