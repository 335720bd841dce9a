"""Host→device batch feeding: tensors on the step's device, with prefetch.

Port of `ray_tpu/data/jax_iter.py` (the Train ingestion edge, reference
data/iterator.py iter_torch_batches): numpy batches stream off the
Dataset on a producer thread while the NEXT batch's host→device copy
overlaps the current step — a two-deep pipeline, so input never
serializes with compute unless the pipeline genuinely underruns
(tracked in `stats`).

On the card each host batch is pinned, then copied with
`non_blocking=True` on a side stream. The consumer's stream waits on
that copy's event before the batch is handed out, and each device
tensor is recorded on the consumer's stream, so the caching allocator
does not hand its memory to another tensor while the step still reads
it. A pinned buffer is kept until its copy is known to be done. On the
CPU a batch is `torch.from_numpy` with the dtype applied.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, Optional, Union

import numpy as np


class _Prefetcher:
    """Bounded background producer of host batches.

    `close()` unblocks and retires the producer thread when the consumer
    abandons the iterator early (the common `zip(range(steps), it)` loop)
    — without it the thread would sit in q.put forever, pinning batches."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], depth: int):
        import queue
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._sentinel = object()
        self._closed = threading.Event()
        self.wait_s = 0.0

        def run():
            try:
                for item in it:
                    if not self._put(item):
                        return
                self._put(self._sentinel)
            except BaseException as e:
                self._put(e)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="data-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        from ray_tpu_torch.data._util import put_unless_closed
        return put_unless_closed(self._q, item, self._closed)

    def close(self) -> None:
        self._closed.set()

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            self.wait_s += time.perf_counter() - t0
            if item is self._sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype or its name ("int32",
    "bfloat16", "torch.int32")."""
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype).removeprefix("torch."), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"not a torch dtype: {dtype!r}")
    return out


def iter_torch_batches(dataset, *, batch_size: int,
                       device=None,
                       dtypes: Optional[Dict[str, Union[str, object]]] = None,
                       drop_last: bool = True,
                       local_shuffle_buffer_size: int = 0,
                       seed: Optional[int] = None,
                       prefetch_depth: int = 2,
                       stats: Optional[dict] = None):
    """Yield dict[str, torch.Tensor] batches on `device`.

    `device`: None is the current CUDA device (raises where there is
    none); the CPU runs only when named. `dtypes` maps a column to a
    torch dtype or its name, applied on the host before the copy.
    `stats` receives `num_batches` and `input_wait_s` (seconds the
    consumer waited for the producer) when the iterator ends or is
    abandoned.
    """
    import torch

    from ray_tpu_torch.ops.dispatch import resolve_device

    dev = resolve_device(device)
    casts = {k: _torch_dtype(v) for k, v in (dtypes or {}).items()}
    host_iter = dataset.iter_batches(
        batch_size=batch_size, drop_last=drop_last,
        local_shuffle_buffer_size=local_shuffle_buffer_size, seed=seed)
    pf = _Prefetcher(host_iter, prefetch_depth)

    def host(batch: Dict[str, np.ndarray]) -> Dict[str, "torch.Tensor"]:
        out = {}
        for k, v in batch.items():
            v = np.ascontiguousarray(v)
            if not v.flags.writeable:       # e.g. a block mapped from shm
                v = v.copy()
            t = torch.from_numpy(v)
            out[k] = t.to(casts[k]) if k in casts else t
        return out

    if dev.type == "cuda":
        copy_stream = torch.cuda.Stream(dev)

        def put(batch):
            """Start the batch's copy on the side stream: (device
            tensors, the copy's event, the pinned buffers)."""
            pinned = {k: t.pin_memory() for k, t in host(batch).items()}
            with torch.cuda.stream(copy_stream):
                moved = {k: t.to(dev, non_blocking=True)
                         for k, t in pinned.items()}
                done = torch.cuda.Event()
                done.record(copy_stream)
            return moved, done, pinned

        def hand_out(staged):
            moved, done, _ = staged
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in moved.values():
                t.record_stream(consumer)
            return moved

        def retire(staged):
            staged[1].synchronize()     # its pinned buffers may go now
    else:
        def put(batch):
            return host(batch)

        def hand_out(staged):
            return staged

        def retire(staged):
            pass

    pending = None
    n = 0
    try:
        for batch in pf:
            nxt = put(batch)        # start the copy of the next batch
            if pending is not None:
                yield hand_out(pending)
                n += 1
                retire(pending)
            pending = nxt
        if pending is not None:
            yield hand_out(pending)
            n += 1
    finally:
        # runs on normal exhaustion AND GeneratorExit when the consumer
        # abandons the loop early — either way the producer must die.
        pf.close()
        if pending is not None:
            retire(pending)
        if stats is not None:
            stats["num_batches"] = n
            stats["input_wait_s"] = pf.wait_s
