"""Datasources: file/range/items readers producing ReadTasks.

Parity: reference python/ray/data/_internal/datasource/ (parquet, json,
csv readers) + read_api.py — re-shaped for the columnar numpy Block.
Each ReadTask is a picklable zero-arg callable returning an iterator of
Blocks, so the streaming executor can run it inside a ray_tpu_torch task on
any worker.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, block_from_rows, block_slice

ReadFn = Callable[[], Iterator[Block]]


class ReadTask:
    """One unit of parallel read work."""

    def __init__(self, fn: ReadFn, name: str,
                 input_files: Optional[List[str]] = None):
        self._fn = fn
        self.name = name
        self.input_files = input_files or []

    def __call__(self) -> Iterator[Block]:
        return self._fn()

    def __repr__(self) -> str:
        return f"ReadTask({self.name})"


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


# --------------------------------------------------------------- range
def range_tasks(n: int, num_blocks: int) -> List[ReadTask]:
    num_blocks = max(1, min(num_blocks, n) if n else 1)
    sizes = [n // num_blocks + (1 if i < n % num_blocks else 0)
             for i in range(num_blocks)]
    tasks, start = [], 0
    for i, sz in enumerate(sizes):
        lo, hi = start, start + sz
        start = hi

        def fn(lo=lo, hi=hi) -> Iterator[Block]:
            yield {"id": np.arange(lo, hi, dtype=np.int64)}

        tasks.append(ReadTask(fn, f"range[{lo}:{hi}]"))
    return tasks


# --------------------------------------------------------------- items
def items_tasks(items: List[Any], num_blocks: int) -> List[ReadTask]:
    n = len(items)
    num_blocks = max(1, min(num_blocks, n) if n else 1)
    sizes = [n // num_blocks + (1 if i < n % num_blocks else 0)
             for i in range(num_blocks)]
    tasks, start = [], 0
    for sz in sizes:
        chunk = items[start:start + sz]
        start += sz

        def fn(chunk=chunk) -> Iterator[Block]:
            rows = [r if isinstance(r, dict) else {"item": r}
                    for r in chunk]
            yield block_from_rows(rows)

        tasks.append(ReadTask(fn, f"items[{sz}]"))
    return tasks


# --------------------------------------------------------------- jsonl
def jsonl_tasks(paths, rows_per_block: int = 4096) -> List[ReadTask]:
    files = _expand_paths(paths)

    def read_one(path: str) -> Iterator[Block]:
        rows: List[Dict[str, Any]] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rows.append(json.loads(line))
                if len(rows) >= rows_per_block:
                    yield block_from_rows(rows)
                    rows = []
        if rows:
            yield block_from_rows(rows)

    return [ReadTask(lambda p=p: read_one(p), f"jsonl[{os.path.basename(p)}]",
                     [p]) for p in files]


# ------------------------------------------------------------- parquet
def parquet_tasks(paths, columns: Optional[List[str]] = None,
                  rows_per_block: int = 65536) -> List[ReadTask]:
    files = _expand_paths(paths)

    def read_one(path: str) -> Iterator[Block]:
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(path)
        for batch in pf.iter_batches(batch_size=rows_per_block,
                                     columns=columns):
            block: Block = {}
            for name, col in zip(batch.schema.names, batch.columns):
                arr = col.to_numpy(zero_copy_only=False)
                if arr.dtype.kind in ("U", "S"):
                    arr = arr.astype(object)
                block[name] = arr
            yield block

    return [ReadTask(lambda p=p: read_one(p),
                     f"parquet[{os.path.basename(p)}]", [p])
            for p in files]


# ----------------------------------------------------------------- csv
def csv_tasks(paths, rows_per_block: int = 65536) -> List[ReadTask]:
    files = _expand_paths(paths)

    def read_one(path: str) -> Iterator[Block]:
        import pyarrow.csv as pacsv
        table = pacsv.read_csv(path)
        n = table.num_rows
        cols = {name: table.column(name).to_numpy(zero_copy_only=False)
                for name in table.schema.names}
        block = {k: (v.astype(object) if v.dtype.kind in ("U", "S") else v)
                 for k, v in cols.items()}
        for lo in range(0, n, rows_per_block):
            yield block_slice(block, lo, min(lo + rows_per_block, n))

    return [ReadTask(lambda p=p: read_one(p),
                     f"csv[{os.path.basename(p)}]", [p]) for p in files]


# ----------------------------------------------------------- write side
def write_jsonl(blocks: Iterator[Block], path: str) -> List[str]:
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "part-00000.jsonl")
    from ray_tpu_torch.data.block import block_to_rows
    with open(out, "w", encoding="utf-8") as f:
        for block in blocks:
            for row in block_to_rows(block):
                f.write(json.dumps({k: _json_safe(v)
                                    for k, v in row.items()}) + "\n")
    return [out]


def write_parquet(blocks: Iterator[Block], path: str) -> List[str]:
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "part-00000.parquet")
    tables = []
    for block in blocks:
        tables.append(pa.table(
            {k: pa.array(list(v)) for k, v in block.items()}))
    if tables:
        pq.write_table(pa.concat_tables(tables), out)
    return [out]


def _json_safe(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


# ------------------------------------------------------------- text/bin
def text_tasks(paths, rows_per_block: int = 65536) -> List[ReadTask]:
    """One row per line, column 'text' (reference read_text)."""
    files = _expand_paths(paths)

    def read_one(path: str) -> Iterator[Block]:
        rows: List[Dict[str, Any]] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                rows.append({"text": line.rstrip("\n")})
                if len(rows) >= rows_per_block:
                    yield block_from_rows(rows)
                    rows = []
        if rows:
            yield block_from_rows(rows)

    return [ReadTask(lambda p=p: read_one(p),
                     f"text[{os.path.basename(p)}]", [p]) for p in files]


def binary_tasks(paths, include_paths: bool = True) -> List[ReadTask]:
    """One row per file: {'bytes': ..., 'path': ...} (reference
    read_binary_files)."""
    files = _expand_paths(paths)

    def read_one(path: str) -> Iterator[Block]:
        with open(path, "rb") as f:
            data = f.read()
        row: Dict[str, Any] = {"bytes": data}
        if include_paths:
            row["path"] = path
        yield block_from_rows([row])

    return [ReadTask(lambda p=p: read_one(p),
                     f"binary[{os.path.basename(p)}]", [p])
            for p in files]


def image_tasks(paths, size=None, mode: str = "RGB",
                include_paths: bool = False) -> List[ReadTask]:
    """Decode images via PIL into uint8 arrays, column 'image'
    ((H,W,C) per row; with `size=(h,w)` all rows share one shape so the
    column is a dense (N,H,W,C) batch). Reference read_images."""
    files = _expand_paths(paths)

    def read_one(path: str) -> Iterator[Block]:
        from PIL import Image
        img = Image.open(path)
        if mode:
            img = img.convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        row: Dict[str, Any] = {"image": np.asarray(img)}
        if include_paths:
            row["path"] = path
        yield block_from_rows([row])

    return [ReadTask(lambda p=p: read_one(p),
                     f"image[{os.path.basename(p)}]", [p])
            for p in files]


# ------------------------------------------------------------ tfrecords
# Pure-python tf.train.Example wire codec: the TFRecord container is
# [uint64 len][crc32c(len)][payload][crc32c(payload)] and the payload is
# an Example proto — Example{1: Features{1: map<string, Feature>}},
# Feature = oneof BytesList(1){bytes 1} / FloatList(2){packed float 1} /
# Int64List(3){packed varint 1}. No tensorflow/protobuf dependency.
# Parity: reference data/_internal/datasource/tfrecords_datasource.py.

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78          # Castagnoli, reflected
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    try:
        from ray_tpu_torch import native
        if native.available():          # ~1.5 GB/s vs ~7 MB/s in Python
            return native.masked_crc32c(data)
    except Exception:
        pass
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _read_varint(buf, pos):
    shift = val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _iter_proto_fields(buf):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _parse_feature(buf) -> list:
    import struct
    for fnum, _wt, val in _iter_proto_fields(buf):
        if fnum == 1:      # BytesList
            return [v for f, _, v in _iter_proto_fields(val) if f == 1]
        if fnum == 2:      # FloatList (packed or repeated)
            out: list = []
            for f, wt2, v in _iter_proto_fields(val):
                if f != 1:
                    continue
                if wt2 == 2:
                    out.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:
                    out.append(struct.unpack("<f", v)[0])
            return [float(x) for x in out]
        if fnum == 3:      # Int64List (packed or repeated varint)
            out = []
            for f, wt2, v in _iter_proto_fields(val):
                if f != 1:
                    continue
                vals = []
                if wt2 == 2:
                    p = 0
                    while p < len(v):
                        x, p = _read_varint(v, p)
                        vals.append(x)
                else:
                    vals.append(v)
                for x in vals:
                    out.append(x - (1 << 64) if x >= (1 << 63) else x)
            return out
    return []


def _parse_example(buf) -> Dict[str, Any]:
    feats: Dict[str, Any] = {}
    for fnum, _wt, val in _iter_proto_fields(buf):
        if fnum != 1:
            continue                       # Features
        for f2, _w2, entry in _iter_proto_fields(val):
            if f2 != 1:
                continue                   # map entry
            key, feature = None, b""
            for f3, _w3, v3 in _iter_proto_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    feature = v3
            if key is not None:
                vals = _parse_feature(feature)
                feats[key] = vals[0] if len(vals) == 1 else np.asarray(
                    vals) if vals and not isinstance(vals[0], bytes) \
                    else vals
    return feats


def tfrecord_tasks(paths, rows_per_block: int = 4096) -> List[ReadTask]:
    files = _expand_paths(paths)

    def read_one(path: str) -> Iterator[Block]:
        import struct
        rows: List[Dict[str, Any]] = []
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                (length,) = struct.unpack("<Q", header)
                f.read(4)                  # length crc (not verified)
                payload = f.read(length)
                if len(payload) < length:
                    raise ValueError(
                        f"corrupted TFRecord {path!r}: record claims "
                        f"{length} bytes, file has {len(payload)}")
                f.read(4)                  # payload crc
                rows.append(_parse_example(payload))
                if len(rows) >= rows_per_block:
                    yield block_from_rows(rows)
                    rows = []
        if rows:
            yield block_from_rows(rows)

    return [ReadTask(lambda p=p: read_one(p),
                     f"tfrecord[{os.path.basename(p)}]", [p])
            for p in files]


def _enc_varint(val: int) -> bytes:
    if val < 0:
        val += 1 << 64
    out = bytearray()
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(fnum: int, payload: bytes) -> bytes:
    return _enc_varint((fnum << 3) | 2) + _enc_varint(len(payload)) \
        + payload


def _enc_feature(value) -> bytes:
    import struct
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if not isinstance(value, (list, tuple)):
        value = [value]
    if all(isinstance(v, (bytes, str)) for v in value):
        payload = b"".join(
            _enc_field(1, v.encode("utf-8") if isinstance(v, str) else v)
            for v in value)
        return _enc_field(1, payload)      # BytesList
    if all(isinstance(v, (int, np.integer)) for v in value):
        packed = b"".join(_enc_varint(int(v)) for v in value)
        return _enc_field(3, _enc_field(1, packed))   # Int64List
    packed = struct.pack(f"<{len(value)}f", *[float(v) for v in value])
    return _enc_field(2, _enc_field(1, packed))       # FloatList


def write_tfrecords(blocks: Iterator[Block], path: str) -> List[str]:
    """Write rows as tf.train.Example TFRecords (valid masked-crc32c
    framing: readable by TF's TFRecordDataset and by tfrecord_tasks)."""
    import struct

    from ray_tpu_torch.data.block import block_to_rows
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "part-00000.tfrecords")
    with open(out, "wb") as f:
        for block in blocks:
            for row in block_to_rows(block):
                entries = b""
                for k, v in row.items():
                    entry = _enc_field(1, k.encode("utf-8")) \
                        + _enc_field(2, _enc_feature(v))
                    entries += _enc_field(1, entry)
                example = _enc_field(1, entries)
                header = struct.pack("<Q", len(example))
                f.write(header)
                f.write(struct.pack("<I", _masked_crc(header)))
                f.write(example)
                f.write(struct.pack("<I", _masked_crc(example)))
    return [out]


def write_csv(blocks: Iterator[Block], path: str) -> List[str]:
    import csv

    from ray_tpu_torch.data.block import block_to_rows
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "part-00000.csv")
    writer = None
    with open(out, "w", newline="", encoding="utf-8") as f:
        for block in blocks:
            for row in block_to_rows(block):
                if writer is None:
                    writer = csv.DictWriter(f, fieldnames=list(row))
                    writer.writeheader()
                writer.writerow({k: _json_safe(v) for k, v in row.items()})
    return [out]
