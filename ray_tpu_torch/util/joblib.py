"""joblib parallel backend on ray_tpu_torch tasks.

The counterpart of `ray_tpu/util/joblib.py`; joblib is imported only
inside `register_ray`, so the module loads where joblib is missing.

Parity: reference python/ray/util/joblib/ (register_ray + the
ray backend) — after `register_ray()`, scikit-learn / joblib code runs
its batches as cluster tasks::

    from ray_tpu_torch.util.joblib import register_ray
    import joblib
    register_ray()
    with joblib.parallel_backend("ray_tpu_torch"):
        results = joblib.Parallel()(joblib.delayed(f)(x) for x in xs)
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private.pickle_utils import dumps_by_value


class _JoblibFuture:
    """joblib expects apply_async to return something with get()."""

    def __init__(self, ref, callback: Optional[Callable]):
        self._ref = ref
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()

        def waiter():
            try:
                self._result = ray_tpu_torch.get(ref)
                if callback is not None:
                    callback(self._result)
            except BaseException as e:  # noqa: BLE001
                self._error = e
            finally:
                self._done.set()

        threading.Thread(target=waiter, daemon=True,
                         name="joblib-future").start()

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("joblib task not done within timeout")
        if self._error is not None:
            raise self._error
        return self._result


def _run_batch(batch_bytes: bytes):
    return cloudpickle.loads(batch_bytes)()


def register_ray() -> None:
    """Register the 'ray_tpu_torch' joblib parallel backend."""
    from joblib.parallel import (ParallelBackendBase,
                                 register_parallel_backend)

    class RayTpuBackend(ParallelBackendBase):
        supports_timeout = True
        # joblib >= 1.3 probes this to decide nesting behavior
        uses_threads = False
        supports_sharedmem = False

        def configure(self, n_jobs: int = 1, parallel=None,
                      **backend_args) -> int:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init(ignore_reinit_error=True)
            self.parallel = parallel
            self._remote = ray_tpu_torch.remote(num_cpus=1)(_run_batch)
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs: int) -> int:
            if n_jobs == 1 or n_jobs is None:
                return 1
            cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1)) \
                if ray_tpu_torch.is_initialized() else 1
            return cpus if n_jobs < 0 else min(n_jobs, max(cpus, 1))

        def apply_async(self, func, callback=None) -> _JoblibFuture:
            # func is joblib's BatchedCalls (library code); the USER
            # functions hide inside func.items — their modules must
            # ship by value for driver-only code
            inner = [call[0] for call in getattr(func, "items", [])]
            ref = self._remote.remote(
                dumps_by_value(func, roots=tuple(inner)))
            return _JoblibFuture(ref, callback)

        def abort_everything(self, ensure_ready: bool = True) -> None:
            pass

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
