"""multiprocessing.Pool API over ray_tpu_torch actors.

The counterpart of `ray_tpu/util/multiprocessing.py`, on the port's
runtime.

Parity: reference python/ray/util/multiprocessing/pool.py — drop-in
`Pool` whose processes are cluster actors, so existing
multiprocessing code scales past one host unchanged::

    from ray_tpu_torch.util.multiprocessing import Pool
    with Pool(processes=4, initializer=setup) as p:
        results = p.map(work, items)

Supports map/starmap/imap/imap_unordered/apply and their _async
variants, chunking, initializers, and context-manager lifecycle.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private.pickle_utils import dumps_by_value


class _PoolWorker:
    def __init__(self, initializer_bytes: Optional[bytes],
                 initargs: tuple):
        if initializer_bytes is not None:
            cloudpickle.loads(initializer_bytes)(*initargs)

    def run_chunk(self, fn_bytes: bytes, chunk: list, star: bool) -> list:
        fn = cloudpickle.loads(fn_bytes)
        if star:
            return [fn(*args) for args in chunk]
        return [fn(x) for x in chunk]

    def run_one(self, fn_bytes: bytes, args: tuple, kwargs: dict):
        return cloudpickle.loads(fn_bytes)(*args, **kwargs)


class AsyncResult:
    """multiprocessing.pool.AsyncResult-shaped handle."""

    def __init__(self, refs: List[Any], combine: Callable[[list], Any],
                 callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None):
        self._refs = refs
        self._combine = combine
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()

        def waiter():
            try:
                self._value = combine(
                    [ray_tpu_torch.get(r) for r in refs])
                if callback is not None:
                    callback(self._value)
            except BaseException as e:  # noqa: BLE001
                self._error = e
                if error_callback is not None:
                    error_callback(e)
            finally:
                self._done.set()

        threading.Thread(target=waiter, daemon=True,
                         name="pool-async-result").start()

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        return self._error is None

    def wait(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("result not ready within timeout")
        if self._error is not None:
            raise self._error
        return self._value


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (),
                 ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        if processes is None:
            processes = max(
                1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._size = processes
        init_bytes = (dumps_by_value(initializer)
                      if initializer is not None else None)
        Actor = ray_tpu_torch.remote(**(ray_remote_args or {"num_cpus": 1}))(
            _PoolWorker)
        self._actors = [Actor.remote(init_bytes, tuple(initargs))
                        for _ in range(processes)]
        self._closed = False

    # ------------------------------------------------------------- map
    def _chunks(self, iterable: Iterable,
                chunksize: Optional[int]) -> List[list]:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._size * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], len(items)

    def _map_refs(self, fn, iterable, chunksize, star: bool):
        self._check_open()
        chunks, _n = self._chunks(iterable, chunksize)
        fn_bytes = dumps_by_value(fn)
        # round-robin: chunk k -> actor k % size (ordered actor queues
        # pipeline the backlog per actor)
        return [
            self._actors[i % self._size].run_chunk.remote(fn_bytes, c,
                                                          star)
            for i, c in enumerate(chunks)]

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> list:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None, callback=None,
                  error_callback=None) -> AsyncResult:
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        return AsyncResult(refs,
                           lambda parts: list(
                               itertools.chain.from_iterable(parts)),
                           callback, error_callback)

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> list:
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn, iterable, chunksize=None, callback=None,
                      error_callback=None) -> AsyncResult:
        refs = self._map_refs(fn, iterable, chunksize, star=True)
        return AsyncResult(refs,
                           lambda parts: list(
                               itertools.chain.from_iterable(parts)),
                           callback, error_callback)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        for r in refs:
            yield from ray_tpu_torch.get(r)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for r in ready:
                yield from ray_tpu_torch.get(r)

    # ----------------------------------------------------------- apply
    def apply(self, fn: Callable, args: tuple = (),
              kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: Optional[dict] = None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check_open()
        ref = self._actors[0].run_one.remote(
            dumps_by_value(fn), tuple(args), dict(kwds or {}))
        return AsyncResult([ref], lambda parts: parts[0], callback,
                           error_callback)

    # ------------------------------------------------------- lifecycle
    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except BaseException:
                pass
        self._actors = []

    def join(self) -> None:
        """Wait for in-flight work (close+join returns results like the
        stdlib contract), then release the actors."""
        if not self._closed:
            raise ValueError("Pool is still running")
        for a in self._actors:
            try:
                # ordered actor queues: a no-op completes only after
                # every previously submitted chunk
                ray_tpu_torch.get(a.run_one.remote(
                    cloudpickle.dumps(lambda: None), (), {}))
            except BaseException:
                pass
        self.terminate()

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
