"""Per-worker training session: the `ray_tpu_torch.train.report()` machinery.

A copy of `ray_tpu/train/session.py`; `get_dataset_shard` hands back the
port's `DataIterator`.

Parity: reference train/_internal/session.py (_TrainSession:111, result
queue hand-off :204-213, report:403,667). The user loop runs in a
daemon thread inside the worker actor; `report()` enqueues (metrics,
checkpoint_dir) and blocks until the driver consumes it, giving the
same backpressure semantics as the reference.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import threading
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session: Optional["_TrainSession"] = None


@dataclasses.dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    trial_name: str = "train"
    experiment_name: str = "train"

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_experiment_name(self) -> str:
        return self.experiment_name


class _TrainSession:
    def __init__(self, fn: Callable, config: Dict[str, Any],
                 context: TrainContext,
                 restore_checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 ckpt_every: int = 0):
        self.context = context
        self.restore_checkpoint = restore_checkpoint
        self.dataset_shards = dataset_shards or {}
        self._fn = fn
        self._config = config
        self._results: "queue.Queue" = queue.Queue(maxsize=1)
        self._consumed = threading.Semaphore(0)
        self._done = False
        self._error: Optional[BaseException] = None
        # Elastic checkpoint cadence (r14): the loop asks
        # should_checkpoint(step) and saves on ElasticConfig's
        # every-n-steps schedule plus whenever the trainer requested a
        # flush (preemption drain, pre-grow reshape).
        self.ckpt_every = int(ckpt_every)
        self._ckpt_requested = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def _run(self):
        global _session
        _session = self
        try:
            if self._fn.__code__.co_argcount == 0:
                self._fn()
            else:
                self._fn(self._config)
        except BaseException as e:  # surfaced to the driver
            self._error = e
        finally:
            self._done = True
            self._results.put(None)  # wake consumer

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        if checkpoint is not None:
            self._ckpt_requested.clear()   # flush satisfied
        self._results.put((metrics, checkpoint))
        self._consumed.acquire()  # block until driver drains (parity)

    def request_checkpoint(self) -> None:
        """Driver-side flush request (drain notice / pre-grow): the
        next should_checkpoint() returns True until a report carries a
        checkpoint."""
        self._ckpt_requested.set()

    def should_checkpoint(self, step: Optional[int] = None) -> bool:
        if self._ckpt_requested.is_set():
            return True
        n = self.ckpt_every
        return bool(n and step is not None and (int(step) + 1) % n == 0)

    def next_result(self, timeout: Optional[float] = None):
        """Driver side: (metrics, checkpoint) | None when finished."""
        item = self._results.get(timeout=timeout)
        if item is None:
            if self._error is not None:
                raise self._error
            return None
        self._consumed.release()
        return item

    @property
    def finished(self) -> bool:
        return self._done


# ------------------------------------------------------------- user API
def get_context() -> TrainContext:
    if _session is None:
        # Outside a training session (unit tests, local debugging):
        # single-worker world.
        return TrainContext(0, 1, 0, 1, 0)
    return _session.context


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (+ optional checkpoint) to the trainer
    (reference session.py report:667)."""
    if _session is None:
        return  # no-op outside a session, like the reference's local mode
    _session.report(metrics, checkpoint)


def should_checkpoint(step: Optional[int] = None) -> bool:
    """Elastic checkpoint cadence (r14): True on the ElasticConfig
    every-n-steps schedule (step counts from 0; fires at n-1, 2n-1, …)
    and whenever the trainer requested a flush (preemption drain,
    pre-grow reshape). SPMD loops should key the save on the step so
    every rank reaches the save collective together — the flush request
    lands on all ranks but is only exact at step granularity. Always
    False outside a session."""
    if _session is None:
        return False
    return _session.should_checkpoint(step)


def get_checkpoint() -> Optional[Checkpoint]:
    """Checkpoint to resume from (set on group restart)."""
    if _session is None:
        return None
    return _session.restore_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed to TorchTrainer(datasets=)
    as a DataIterator (reference train.get_dataset_shard)."""
    if _session is None or name not in _session.dataset_shards:
        raise KeyError(
            f"no dataset shard {name!r}: pass datasets={{{name!r}: ds}} "
            f"to TorchTrainer")
    shard = _session.dataset_shards[name]
    from ray_tpu_torch.data.dataset import DataIterator, Dataset
    if isinstance(shard, Dataset):
        return DataIterator(shard)
    return shard


def make_temp_checkpoint_dir() -> str:
    return tempfile.mkdtemp(prefix="rtt_ckpt_")
