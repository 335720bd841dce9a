"""Durable workflows: step-checkpointed task graphs.

The counterpart of `ray_tpu/workflow/__init__.py`, on the port's
runtime; its default storage is `~/ray_tpu_torch_workflows`.

Parity: reference python/ray/workflow (workflow_executor.py — each step
persists its result; a resumed workflow replays completed steps from
storage instead of re-executing them; workflow_state.py — per-step
metadata + retry/catch options; api.py list_all/get_metadata).
Re-shaped for this stack:

- `@workflow.step` wraps a function; inside a running workflow each
  invocation is one durable unit. Step identity = call order + function
  name + a content hash of the arguments: a replayed step must match
  the stored content key, otherwise it is re-executed (and everything
  downstream re-keys off the fresh result), so editing/reordering a
  branch between run and resume cannot silently replay wrong results.
- Per-step options (reference workflow.options): `max_retries` rides
  the task layer (worker death / system failures); `retry_exceptions`
  additionally retries application exceptions; `timeout` bounds one
  attempt (the timed-out task is cancelled, the attempt counts against
  retries); `catch_exceptions` returns `(result, None)` /
  `(None, exc)` instead of raising.
- `workflow.run(entry_fn, *args, workflow_id=..., storage=...)`
  executes the entry function; every step result is pickled under
  `<storage>/<workflow_id>/steps/` with metadata (attempts, duration)
  and an append-only `events.jsonl` (started/completed/replayed/
  invalidated/failed per step).
- `workflow.resume(workflow_id, storage=...)` re-runs the entry
  function (persisted at first run); completed steps return their
  stored results without executing, so the workflow continues from the
  first incomplete step. `list_workflows()` + `get_metadata()` expose
  status (RUNNING/SUCCEEDED/FAILED) and per-step records.

Steps execute as ray_tpu_torch tasks (isolation + retries ride the task
layer). Non-step code in the entry function re-runs on resume — keep
side effects inside steps, exactly as the reference demands.
"""
from __future__ import annotations

import contextvars
import functools
import hashlib
import json
import os
import pickle
import time
from typing import Any, Callable, Optional, Union

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError, TaskError

_DEFAULT_STORAGE = os.path.expanduser("~/ray_tpu_torch_workflows")

_ctx: contextvars.ContextVar[Optional["_WorkflowContext"]] = (
    contextvars.ContextVar("rtt_workflow_ctx", default=None))


class WorkflowNotFoundError(Exception):
    pass


class StepTimeoutError(Exception):
    """A step attempt exceeded its `timeout` option."""


def _digest(obj) -> bytes:
    """Canonical digest: containers are hashed structurally (sets
    element-order-independently — raw pickle bytes of a set vary with
    PYTHONHASHSEED across processes), leaves via cloudpickle."""
    if isinstance(obj, dict):
        # insertion order is deterministic for the same code path
        return b"d" + b"".join(_digest(k) + _digest(v)
                               for k, v in obj.items())
    if isinstance(obj, (set, frozenset)):
        return b"s" + b"".join(sorted(_digest(x) for x in obj))
    if isinstance(obj, (list, tuple)):
        return b"l" + b"".join(_digest(x) for x in obj)
    return hashlib.sha256(cloudpickle.dumps(obj)).digest()


def _content_key(name: str, args, kwargs) -> Optional[str]:
    """Stable digest of a step invocation. None when the args don't
    pickle deterministically enough to hash (then identity falls back
    to call order + name, the pre-round-5 contract)."""
    try:
        payload = _digest((name, list(args), kwargs))
    except Exception:
        return None
    return hashlib.sha256(payload).hexdigest()[:16]


class _WorkflowContext:
    def __init__(self, workflow_id: str, storage: str):
        self.workflow_id = workflow_id
        self.dir = os.path.join(storage, workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)
        self.call_index = 0
        self.num_replayed = 0
        self.num_executed = 0
        self.num_invalidated = 0

    def step_path(self, name: str) -> str:
        idx = self.call_index
        self.call_index += 1
        return os.path.join(self.steps_dir, f"{idx:05d}_{name}.pkl")

    def event(self, step: str, kind: str, **extra) -> None:
        row = {"ts": time.time(), "step": step, "event": kind, **extra}
        with open(os.path.join(self.dir, "events.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def set_status(self, status: str) -> None:
        tmp = os.path.join(self.dir, "status.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"status": status, "ts": time.time()}, f)
        os.replace(tmp, os.path.join(self.dir, "status.json"))


class WorkflowStep:
    """A durable unit. Called inside workflow.run: executes as a task
    and persists; outside a workflow: plain call."""

    def __init__(self, fn: Callable, name: Optional[str] = None,
                 max_retries: int = 3,
                 retry_exceptions: Union[bool, tuple] = False,
                 timeout: Optional[float] = None,
                 catch_exceptions: bool = False):
        self._fn = fn
        self.name = name or fn.__name__
        self.max_retries = max_retries
        if isinstance(retry_exceptions, type):  # bare exception class
            retry_exceptions = (retry_exceptions,)
        self.retry_exceptions = retry_exceptions
        self.timeout = timeout
        self.catch_exceptions = catch_exceptions
        self._remote = ray_tpu_torch.remote(max_retries=max_retries)(fn)
        functools.update_wrapper(self, fn)

    def options(self, **overrides) -> "WorkflowStep":
        """Reference step.options(): a copy with per-call overrides."""
        merged = dict(name=self.name, max_retries=self.max_retries,
                      retry_exceptions=self.retry_exceptions,
                      timeout=self.timeout,
                      catch_exceptions=self.catch_exceptions)
        merged.update(overrides)
        return WorkflowStep(self._fn, **merged)

    def _retryable(self, exc: Exception) -> bool:
        if isinstance(exc, StepTimeoutError):
            return True          # timeouts always count against retries
        # app exceptions surface wrapped in TaskError; match the cause
        if isinstance(exc, TaskError) and exc.cause is not None:
            exc = exc.cause
        if self.retry_exceptions is True:
            return True
        if self.retry_exceptions:
            return isinstance(exc, tuple(self.retry_exceptions))
        return False

    def _execute_once(self, args, kwargs):
        ref = self._remote.remote(*args, **kwargs)
        try:
            return ray_tpu_torch.get(ref, timeout=self.timeout)
        except GetTimeoutError:
            try:
                ray_tpu_torch.cancel(ref, force=True)
            except Exception:
                pass
            raise StepTimeoutError(
                f"step {self.name!r} exceeded {self.timeout}s") from None

    def __call__(self, *args, **kwargs):
        ctx = _ctx.get()
        if ctx is None:
            return self._fn(*args, **kwargs)
        path = ctx.step_path(self.name)
        key = _content_key(self.name, args, kwargs)
        base = os.path.basename(path)
        # a checkpoint at this position under a *different* step name
        # (branch renamed/removed between runs) is stale: drop it so it
        # neither replays wrongly nor lingers in status/metadata
        import glob as _glob
        for other in _glob.glob(os.path.join(
                ctx.steps_dir, base.split("_", 1)[0] + "_*.pkl")):
            if os.path.basename(other) != base:
                os.remove(other)
                ctx.num_invalidated += 1
                ctx.event(self.name, "invalidated",
                          stale=os.path.basename(other))
        if os.path.exists(path):
            with open(path, "rb") as f:
                rec = pickle.load(f)
            stored_key = rec.get("key")
            if key is None or stored_key is None or stored_key == key:
                ctx.num_replayed += 1
                ctx.event(self.name, "replayed", path=base)
                if "error" in rec:   # durable caught failure
                    if self.catch_exceptions:
                        return (None, rec["error"])
                    raise rec["error"]
                result = rec["result"]
                if self.catch_exceptions:
                    return (result, None)
                return result
            # The call at this position no longer matches what was
            # checkpointed (branch edited/reordered): re-execute.
            ctx.num_invalidated += 1
            ctx.event(self.name, "invalidated",
                      stored_key=stored_key, new_key=key)

        attempts = 0
        start = time.time()
        ctx.event(self.name, "started")
        while True:
            attempts += 1
            try:
                result = self._execute_once(args, kwargs)
                break
            except Exception as e:
                if self._retryable(e) and attempts <= self.max_retries:
                    ctx.event(self.name, "retrying", attempt=attempts,
                              error=repr(e))
                    continue
                ctx.event(self.name, "failed", attempt=attempts,
                          error=repr(e))
                if self.catch_exceptions:
                    if isinstance(e, TaskError) and e.cause is not None:
                        e = e.cause
                    # the caught failure is itself durable: resume must
                    # not silently re-run the step's side effects
                    try:
                        tmp = path + ".tmp"
                        with open(tmp, "wb") as f:
                            pickle.dump({"error": e, "key": key,
                                         "meta": {"attempts": attempts}},
                                        f)
                        os.replace(tmp, path)
                    except Exception:
                        pass  # unpicklable exception: re-run on resume
                    return (None, e)
                raise
        meta = {"attempts": attempts, "start_ts": start,
                "duration_s": time.time() - start}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"result": result, "key": key, "meta": meta}, f)
        os.replace(tmp, path)            # atomic: crash-safe commit
        ctx.num_executed += 1
        ctx.event(self.name, "completed", **meta)
        if self.catch_exceptions:
            return (result, None)
        return result


def step(fn: Optional[Callable] = None, *, name: Optional[str] = None,
         max_retries: int = 3,
         retry_exceptions: Union[bool, tuple] = False,
         timeout: Optional[float] = None,
         catch_exceptions: bool = False):
    """`@workflow.step` / `@workflow.step(name=..., max_retries=...,
    retry_exceptions=..., timeout=..., catch_exceptions=...)`."""
    if fn is not None:
        return WorkflowStep(fn)
    return lambda f: WorkflowStep(
        f, name=name, max_retries=max_retries,
        retry_exceptions=retry_exceptions, timeout=timeout,
        catch_exceptions=catch_exceptions)


def run(entry_fn: Callable, *args, workflow_id: str,
        storage: Optional[str] = None, **kwargs) -> Any:
    """Execute a workflow to completion; durable against re-runs."""
    storage = storage or _DEFAULT_STORAGE
    ctx = _WorkflowContext(workflow_id, storage)
    # persist the entry point + args so resume() can replay it
    entry_path = os.path.join(ctx.dir, "entry.pkl")
    if not os.path.exists(entry_path):
        with open(entry_path, "wb") as f:
            cloudpickle.dump({"fn": entry_fn, "args": args,
                              "kwargs": kwargs}, f)
    global _LAST_STATS
    ctx.set_status("RUNNING")
    token = _ctx.set(ctx)
    try:
        result = entry_fn(*args, **kwargs)
    except BaseException:
        ctx.set_status("FAILED")
        raise
    finally:
        _ctx.reset(token)
        _LAST_STATS = {"replayed": ctx.num_replayed,
                       "executed": ctx.num_executed,
                       "invalidated": ctx.num_invalidated}
    rpath = os.path.join(ctx.dir, "result.pkl")
    try:
        with open(rpath + ".tmp", "wb") as f:
            pickle.dump({"result": result}, f)
        os.replace(rpath + ".tmp", rpath)
    except Exception:
        ctx.set_status("FAILED")
        raise
    ctx.set_status("SUCCEEDED")
    return result


def resume(workflow_id: str, storage: Optional[str] = None) -> Any:
    """Re-run a workflow: finished steps replay from storage; a stored
    final result short-circuits entirely."""
    storage = storage or _DEFAULT_STORAGE
    wdir = os.path.join(storage, workflow_id)
    result_path = os.path.join(wdir, "result.pkl")
    if os.path.exists(result_path):
        try:
            with open(result_path, "rb") as f:
                return pickle.load(f)["result"]
        except Exception:
            os.remove(result_path)   # truncated by a crash: replay
    entry_path = os.path.join(wdir, "entry.pkl")
    if not os.path.exists(entry_path):
        raise WorkflowNotFoundError(
            f"no workflow {workflow_id!r} under {storage}")
    with open(entry_path, "rb") as f:
        entry = cloudpickle.load(f)
    return run(entry["fn"], *entry["args"], workflow_id=workflow_id,
               storage=storage, **entry["kwargs"])


def get_status(workflow_id: str,
               storage: Optional[str] = None) -> dict:
    storage = storage or _DEFAULT_STORAGE
    wdir = os.path.join(storage, workflow_id)
    if not os.path.isdir(wdir):
        raise WorkflowNotFoundError(workflow_id)
    steps = sorted(os.listdir(os.path.join(wdir, "steps")))
    steps = [s for s in steps if s.endswith(".pkl")]
    status = "RUNNING"
    spath = os.path.join(wdir, "status.json")
    if os.path.exists(spath):
        with open(spath) as f:
            status = json.load(f)["status"]
    return {
        "workflow_id": workflow_id,
        "status": status,
        "finished": os.path.exists(os.path.join(wdir, "result.pkl")),
        "steps_completed": len(steps),
        "steps": steps,
    }


def get_metadata(workflow_id: str,
                 storage: Optional[str] = None) -> dict:
    """Workflow-level status + per-step records (attempts, duration)
    + the event log. Parity: reference workflow.get_metadata."""
    storage = storage or _DEFAULT_STORAGE
    info = get_status(workflow_id, storage)
    wdir = os.path.join(storage, workflow_id)
    step_meta = {}
    for fname in info["steps"]:
        with open(os.path.join(wdir, "steps", fname), "rb") as f:
            rec = pickle.load(f)
        step_meta[fname] = {"key": rec.get("key"), **rec.get("meta", {})}
    events = []
    epath = os.path.join(wdir, "events.jsonl")
    if os.path.exists(epath):
        with open(epath) as f:
            events = [json.loads(line) for line in f if line.strip()]
    info["step_metadata"] = step_meta
    info["events"] = events
    return info


def list_workflows(storage: Optional[str] = None) -> list:
    """All workflow ids under storage with their status.
    Parity: reference workflow.list_all()."""
    storage = storage or _DEFAULT_STORAGE
    if not os.path.isdir(storage):
        return []
    out = []
    for wid in sorted(os.listdir(storage)):
        if os.path.isdir(os.path.join(storage, wid, "steps")):
            out.append((wid, get_status(wid, storage)["status"]))
    return out


_LAST_STATS: dict = {}


def last_run_stats() -> dict:
    """Replay/execute counters of the most recent run/resume in this
    process (observability + tests)."""
    return dict(_LAST_STATS)
