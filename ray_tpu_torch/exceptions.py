"""Exception hierarchy for ray_tpu_torch.

Parity map (reference: python/ray/exceptions.py): RayError -> RayTpuError,
RayTaskError -> TaskError, RayActorError -> ActorError, GetTimeoutError kept,
ObjectLostError kept, WorkerCrashedError -> WorkerDiedError.
"""
from __future__ import annotations

import traceback as _tb


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch errors."""


class TaskError(RayTpuError):
    """A task raised an exception during remote execution.

    Raised at the `get()` site of the caller, mirroring the reference's
    owner-side error propagation (core_worker task retries exhausted ->
    error object stored; see reference src/ray/core_worker/task_manager.cc).
    """

    def __init__(self, cause: BaseException | None, traceback_str: str = "",
                 task_name: str = ""):
        self.cause = cause
        self.traceback_str = traceback_str
        self.task_name = task_name
        super().__init__(str(self))

    def __str__(self) -> str:
        head = f"Task {self.task_name!r} failed" if self.task_name else "Task failed"
        if self.traceback_str:
            return f"{head}:\n{self.traceback_str}"
        return f"{head}: {self.cause!r}"


class ActorError(RayTpuError):
    """An actor died before or during execution of a submitted method."""

    def __init__(self, actor_id: str = "", message: str = ""):
        self.actor_id = actor_id
        super().__init__(message or f"Actor {actor_id} died")


class ActorDiedError(ActorError):
    pass


class ActorUnavailableError(ActorError):
    pass


class WorkerDiedError(RayTpuError):
    """The worker process executing a task died (crash/OOM/kill)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get()` timed out."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before/while running."""

    def __init__(self, task_id: str = ""):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")


class ObjectLostError(RayTpuError):
    """Object is unreachable (evicted and not reconstructable)."""


class RuntimeNotInitializedError(RayTpuError):
    def __init__(self):
        super().__init__(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first.")


class PlacementGroupUnschedulableError(RayTpuError):
    """Placement group cannot fit on the cluster."""


def format_exception(exc: BaseException) -> str:
    return "".join(_tb.format_exception(type(exc), exc, exc.__traceback__))
