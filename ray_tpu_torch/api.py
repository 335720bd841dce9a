"""Public task API: ``@remote`` functions, ``get``/``put``/``wait``.

Parity: reference python/ray/remote_function.py (RemoteFunction._remote:266)
and python/ray/_private/worker.py (get:2619, put:2787, wait). Options are
validated here in one place, mirroring _private/ray_option_utils.py.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Union

import cloudpickle

from ray_tpu_torch._private import context as _context
from ray_tpu_torch._private.refs import ObjectRef
from ray_tpu_torch._private.specs import (TaskSpec, extract_ref_args, function_id,
                                    new_task_id)

_VALID_TASK_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "num_returns", "max_retries",
    "resources", "name", "scheduling_strategy", "runtime_env",
    "placement_group", "placement_group_bundle_index", "memory",
    "_node_id",
}


_SUPPORTED_RUNTIME_ENV_KEYS = {"env_vars", "working_dir", "pip",
                               "py_modules", "uv", "conda",
                               "container", "image_uri"}


def validate_runtime_env(renv: Optional[dict]) -> Optional[dict]:
    """Reject runtime_env keys this stack does not implement — options
    must never be silently ignored (r1 verdict principle). Supported:
    env_vars (dict[str,str]), working_dir (local path: worker chdir +
    sys.path), pip (per-host cached venv), py_modules (local packages
    shipped through the cluster KV). Reference surface:
    _private/runtime_env/ plugin set."""
    if renv is None:
        return None
    if not isinstance(renv, dict):
        raise TypeError(f"runtime_env must be a dict, got "
                        f"{type(renv).__name__}")
    unsupported = set(renv) - _SUPPORTED_RUNTIME_ENV_KEYS
    if unsupported:
        raise ValueError(
            f"unsupported runtime_env key(s) {sorted(unsupported)}; "
            f"this runtime implements {sorted(_SUPPORTED_RUNTIME_ENV_KEYS)}")
    env_vars = renv.get("env_vars")
    if env_vars is not None and not (
            isinstance(env_vars, dict)
            and all(isinstance(k, str) and isinstance(v, str)
                    for k, v in env_vars.items())):
        raise TypeError("runtime_env['env_vars'] must be dict[str, str]")
    wd = renv.get("working_dir")
    if wd is not None:
        import os
        if not os.path.isdir(wd):
            raise ValueError(
                f"runtime_env['working_dir'] {wd!r} is not a directory "
                f"(remote URIs are not supported in this runtime)")
    if renv.get("pip") is not None:
        from ray_tpu_torch._private.runtime_env import normalize_pip
        renv = dict(renv)
        renv["pip"] = normalize_pip(renv["pip"])
    return renv


def prepare_runtime_env(renv: Optional[dict]) -> Optional[dict]:
    """Submission-time step: ship py_modules content into the cluster
    KV so workers on any host can materialize them (reference
    runtime_env/py_modules.py upload-to-GCS)."""
    if not renv or not renv.get("py_modules"):
        return renv
    from ray_tpu_torch._private.runtime_env import upload_py_modules
    ctx = _context.get_ctx()
    return upload_py_modules(
        renv, lambda k, v: ctx.kv_op("put", k, v))


def build_resources(opts: dict, default_cpus: float = 1.0) -> dict:
    res = dict(opts.get("resources") or {})
    if "num_cpus" in opts and opts["num_cpus"] is not None:
        res["CPU"] = float(opts["num_cpus"])
    else:
        res.setdefault("CPU", default_cpus)
    if opts.get("num_tpus"):
        res["TPU"] = float(opts["num_tpus"])
    if opts.get("num_gpus"):
        # the head node's GPU resource counts the CUDA devices
        # (runtime.detect_num_gpus)
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    return res


def _apply_scheduling(spec, opts: dict) -> None:
    strategy = opts.get("scheduling_strategy")
    spec.scheduling_strategy = strategy
    pg = opts.get("placement_group")
    bundle = opts.get("placement_group_bundle_index", -1)
    if strategy is not None and type(strategy).__name__ == \
            "PlacementGroupSchedulingStrategy":
        pg = strategy.placement_group
        bundle = strategy.placement_group_bundle_index
    if strategy is not None and type(strategy).__name__ == \
            "NodeAffinitySchedulingStrategy":
        spec.node_id = strategy.node_id
        spec.affinity_soft = bool(getattr(strategy, "soft", False))
    if strategy is not None and type(strategy).__name__ == \
            "NodeLabelSchedulingStrategy":
        spec.label_constraints = strategy.normalized()
    if pg is not None:
        spec.placement_group_id = getattr(pg, "id", pg)
        spec.placement_group_bundle_index = (
            -1 if bundle is None else bundle)
    if opts.get("_node_id"):
        spec.node_id = opts["_node_id"]


class RemoteFunction:
    def __init__(self, fn, options: Optional[dict] = None):
        if not callable(fn):
            raise TypeError("@remote must wrap a callable")
        # update_wrapper FIRST: it copies fn.__dict__ into self, and a
        # callable-instance target would otherwise clobber our _fn/_opts
        # with its own same-named attributes
        try:
            functools.update_wrapper(self, fn, updated=())
        except AttributeError:
            pass
        self._fn = fn
        self._opts = dict(options or {})
        bad = set(self._opts) - _VALID_TASK_OPTIONS
        if bad:
            raise ValueError(f"invalid @remote option(s): {sorted(bad)}")
        validate_runtime_env(self._opts.get("runtime_env"))
        self._pickled: Optional[bytes] = None
        self._func_id: Optional[str] = None
        self._registered_in: set[int] = set()
        self._prepared_renv: Optional[tuple] = None   # (ctx_id, env)

    def _runtime_env(self) -> Optional[dict]:
        """Validated + uploaded runtime env, prepared ONCE per handle
        PER RUNTIME — re-zipping py_modules on every .remote() call
        would collapse submission throughput, but the KV upload only
        lives as long as one cluster (same per-runtime keying as
        function registration)."""
        ctx = _context.get_ctx()
        ctx_id = getattr(ctx, "ctx_epoch", id(ctx))
        if self._prepared_renv is None or \
                self._prepared_renv[0] != ctx_id:
            self._prepared_renv = (ctx_id, prepare_runtime_env(
                validate_runtime_env(self._opts.get("runtime_env")))
                or {})
        return self._prepared_renv[1] or None

    def _ensure_pickled(self):
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._fn)
            self._func_id = function_id(self._pickled)
        return self._func_id, self._pickled

    def options(self, **opts) -> "RemoteFunction":
        merged = {**self._opts, **opts}
        rf = RemoteFunction(self._fn, merged)
        rf._pickled, rf._func_id = self._pickled, self._func_id
        return rf

    def remote(self, *args, **kwargs):
        ctx = _context.get_ctx()
        func_id, pickled = self._ensure_pickled()
        opts = self._opts
        num_returns = int(opts.get("num_returns", 1))
        task_id = new_task_id()
        promoted: list = []     # held until the submit pins them
        s_args, s_kwargs, pinned = extract_ref_args(args, kwargs, promoted)
        spec = TaskSpec(
            task_id=task_id,
            func_id=func_id,
            args=s_args,
            kwargs=s_kwargs,
            num_returns=num_returns,
            return_ids=[f"{task_id}r{i}" for i in range(num_returns)],
            resources=build_resources(opts),
            max_retries=int(opts.get("max_retries", 3)),
            name=opts.get("name") or getattr(self._fn, "__qualname__",
                                             "task"),
            runtime_env=self._runtime_env(),
            pinned_refs=pinned,
        )
        _apply_scheduling(spec, opts)
        for oid in spec.return_ids:
            ctx.addref(oid)
        if ctx.is_driver:
            ctx.register_function(func_id, pickled)
            ctx.submit_task(spec)
        else:
            ctx.submit_task(spec, func_bytes=pickled)
        refs = [ObjectRef(oid) for oid in spec.return_ids]
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self.__name__!r} cannot be called directly; "
            f"use {self.__name__}.remote().")


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=..., ...)`` for
    functions and classes (reference python/ray/__init__.py remote)."""
    from ray_tpu_torch.actor import ActorClass

    def make(target, opts):
        if isinstance(target, type):
            return ActorClass(target, opts)
        return RemoteFunction(target, opts)

    if len(args) == 1 and not kwargs and (callable(args[0])):
        return make(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only")
    return lambda target: make(target, kwargs)


def method(**opts):
    """Per-method actor options: ``@ray_tpu_torch.method(num_returns=2)``
    (reference python/ray/actor.py method decorator)."""
    def deco(fn):
        fn.__rtpu_method_opts__ = opts
        return fn
    return deco


def _flatten_refs(object_refs) -> tuple[list[str], bool]:
    if isinstance(object_refs, ObjectRef):
        return [object_refs.object_id], True
    ids = []
    for r in object_refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(
                f"get()/wait() accept ObjectRefs, got {type(r).__name__}")
        ids.append(r.object_id)
    return ids, False


def get(object_refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    # channel-mode compiled DAG results carry their own transport;
    # timeout=None blocks indefinitely, same as every other get path
    if hasattr(object_refs, "_dag") and hasattr(object_refs, "get"):
        return object_refs.get(timeout=timeout)
    ctx = _context.get_ctx()
    ids, single = _flatten_refs(object_refs)
    values = ctx.get_objects(ids, timeout)
    return values[0] if single else values


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return _context.get_ctx().put(value)


def wait(object_refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(object_refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    ids, _ = _flatten_refs(object_refs)
    if num_returns > len(ids):
        raise ValueError("num_returns exceeds number of refs")
    by_id = {r.object_id: r for r in object_refs}
    ready_ids, not_ready_ids = _context.get_ctx().wait(
        ids, num_returns, timeout)
    return ([by_id[i] for i in ready_ids],
            [by_id[i] for i in not_ready_ids])


def broadcast(ref: ObjectRef, *, fanout: Optional[int] = None,
              timeout: Optional[float] = None) -> dict:
    """Distribute `ref`'s object to every alive node in a fanout tree
    (``RAY_TPU_BCAST_FANOUT``, default 4): the source serves at most
    `fanout` transfers and each completed puller immediately serves its
    subtree, so a weight broadcast costs the producer O(fanout) instead
    of O(nodes). Blocks until every node holds a copy (or `timeout`);
    returns the tree stats (nodes, depth, failed, seconds). Objects
    already resident everywhere return immediately."""
    if not isinstance(ref, ObjectRef):
        raise TypeError("broadcast() expects an ObjectRef, got "
                        f"{type(ref).__name__}")
    ctx = _context.get_ctx()
    if hasattr(ctx, "broadcast_object"):
        return ctx.broadcast_object(ref.object_id, fanout=fanout,
                                    timeout=timeout)
    # workers / remote drivers reach the coordinator over the wire;
    # head-side exceptions come back as an error dict (job snapshots
    # always carry "object_id") — re-raise so both paths share one
    # contract
    out = ctx.state_op("broadcast_object", object_id=ref.object_id,
                       fanout=fanout, timeout=timeout)
    if isinstance(out, dict) and "error" in out and "object_id" not in out:
        if out.get("error_type") == "TimeoutError":
            raise TimeoutError(out["error"])
        raise RuntimeError(out["error"])
    return out


def kill(actor, *, no_restart: bool = True) -> None:
    from ray_tpu_torch.actor import ActorHandle
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    _context.get_ctx().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    _context.get_ctx().cancel_task(ref.object_id, force)


def get_actor(name: str, namespace: str = "default"):
    return _context.get_ctx().get_actor_handle(name, namespace)


def cluster_resources() -> dict:
    return _context.get_ctx().state_op("cluster_resources")


def available_resources() -> dict:
    return _context.get_ctx().state_op("available_resources")
