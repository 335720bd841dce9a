"""Actor API: ``@remote`` classes, handles, method proxies.

Parity: reference python/ray/actor.py (ActorClass._remote, ActorHandle,
ActorMethod).

Ordering guarantee (tested in tests/test_direct_actor.py): calls
submitted through one handle execute in submission order. They arrive
over a single TCP stream and execute on a width-1 pool by default,
matching the reference's sequential actor scheduling queue
(src/ray/core_worker/transport/sequential_actor_submit_queue.cc). The
guarantee holds on BOTH transports and across transitions between
them:

- head-routed (classic): caller -> head -> hosting node -> worker,
  one queue per actor head-side while it is pending/restarting;
- direct (r18, ``RAY_TPU_DIRECT_ACTOR``): the caller resolves the
  actor's endpoint once, caches it per process (survives handle
  re-pickling — the cache keys on actor id, not handle identity), and
  streams calls peer-to-peer to the hosting node, replies inline;
- across an actor restart (``max_restarts>0``) and across a
  direct->head fallback redirect: NACKed calls re-enter the head's
  per-actor queue in submission order, and the handle stays
  head-routed until every earlier call reached a terminal state, so
  a later direct call can never overtake an earlier fallback call.
"""
from __future__ import annotations

import inspect
from typing import Any, Optional

import cloudpickle

from ray_tpu_torch._private import context as _context
from ray_tpu_torch._private.refs import ObjectRef
from ray_tpu_torch._private.specs import (ActorSpec, ActorTaskSpec,
                                    extract_ref_args, function_id,
                                    new_actor_id, new_task_id)
from ray_tpu_torch.api import (_apply_scheduling, build_resources,
                         prepare_runtime_env, validate_runtime_env)

_VALID_ACTOR_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "resources", "name", "namespace",
    "lifetime", "max_restarts", "max_task_retries", "max_concurrency",
    "scheduling_strategy", "runtime_env", "placement_group",
    "placement_group_bundle_index", "memory", "get_if_exists", "_node_id",
}


def _method_meta(cls: type) -> dict[str, dict]:
    meta = {}
    for name, member in inspect.getmembers(
            cls, predicate=lambda m: inspect.isfunction(m)
            or inspect.ismethod(m)):
        if name.startswith("__") and name != "__call__":
            continue
        meta[name] = dict(getattr(member, "__rtpu_method_opts__", {}))
    return meta


class ActorClass:
    def __init__(self, cls: type, options: Optional[dict] = None):
        self._cls = cls
        self._opts = dict(options or {})
        bad = set(self._opts) - _VALID_ACTOR_OPTIONS
        if bad:
            raise ValueError(f"invalid actor option(s): {sorted(bad)}")
        validate_runtime_env(self._opts.get("runtime_env"))
        self._pickled: Optional[bytes] = None
        self._class_id: Optional[str] = None
        self._prepared_renv: Optional[tuple] = None   # (ctx_id, env)

    def _runtime_env(self) -> Optional[dict]:
        """Prepared once per ActorClass per runtime (see
        RemoteFunction._runtime_env)."""
        ctx = _context.get_ctx()
        ctx_id = getattr(ctx, "ctx_epoch", id(ctx))
        if self._prepared_renv is None or \
                self._prepared_renv[0] != ctx_id:
            self._prepared_renv = (ctx_id, prepare_runtime_env(
                validate_runtime_env(self._opts.get("runtime_env")))
                or {})
        return self._prepared_renv[1] or None

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote().")

    def options(self, **opts) -> "ActorClass":
        ac = ActorClass(self._cls, {**self._opts, **opts})
        ac._pickled, ac._class_id = self._pickled, self._class_id
        return ac

    def _ensure_pickled(self):
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._cls)
            self._class_id = function_id(self._pickled)
        return self._class_id, self._pickled

    def remote(self, *args, **kwargs) -> "ActorHandle":
        ctx = _context.get_ctx()
        class_id, pickled = self._ensure_pickled()
        opts = self._opts
        if opts.get("get_if_exists") and opts.get("name"):
            try:
                return ctx.get_actor_handle(
                    opts["name"], opts.get("namespace", "default"))
            except ValueError:
                pass
        promoted: list = []     # held until the submit pins them
        s_args, s_kwargs, pinned = extract_ref_args(args, kwargs, promoted)
        spec = ActorSpec(
            actor_id=new_actor_id(),
            class_id=class_id,
            init_args=s_args,
            init_kwargs=s_kwargs,
            # Actors default to 0 CPUs while alive (the reference's actor
            # scheduling default: 1 CPU to place creation, 0 held after),
            # else a handful of idle actors starves the node.
            resources=build_resources(opts, default_cpus=0.0),
            max_restarts=int(opts.get("max_restarts", 0)),
            max_task_retries=int(opts.get("max_task_retries", 0)),
            max_concurrency=int(opts.get("max_concurrency", 1)),
            name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            lifetime=opts.get("lifetime"),
            runtime_env=self._runtime_env(),
            pinned_refs=pinned,
        )
        _apply_scheduling(spec, opts)
        if ctx.is_driver:
            ctx.register_function(class_id, pickled)
            ctx.create_actor(spec)
        else:
            ctx.create_actor(spec, class_bytes=pickled)
        return ActorHandle(spec.actor_id, _method_meta(self._cls),
                           spec.max_task_retries,
                           class_name=self._cls.__name__)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, opts: dict):
        self._handle = handle
        self._name = name
        self._opts = dict(opts)

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(self._handle, self._name,
                           {**self._opts, **opts})

    def remote(self, *args, **kwargs):
        ctx = _context.get_ctx()
        num_returns = int(self._opts.get("num_returns", 1))
        task_id = new_task_id()
        promoted: list = []     # held until the submit pins them
        s_args, s_kwargs, pinned = extract_ref_args(args, kwargs, promoted)
        spec = ActorTaskSpec(
            task_id=task_id,
            actor_id=self._handle._actor_id,
            method_name=self._name,
            args=s_args,
            kwargs=s_kwargs,
            num_returns=num_returns,
            return_ids=[f"{task_id}r{i}" for i in range(num_returns)],
            max_retries=self._handle._max_task_retries,
            name=f"{self._handle._class_name}.{self._name}",
            pinned_refs=pinned,
        )
        # return-id borrows are registered INSIDE submit_actor_task
        # (r18): the head-routed paths addref eagerly exactly as
        # before, while a direct call's borrows ride its coalesced
        # ACTOR_INFLIGHT_DELTA add — no eager per-call head frame.
        ctx.submit_actor_task(self._handle._actor_id, spec)
        refs = [ObjectRef(oid) for oid in spec.return_ids]
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Build a DAG node from this method (reference dag bind API);
        compose with InputNode and experimental_compile (ray_tpu_torch.dag)."""
        from ray_tpu_torch.dag import ClassMethodNode
        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Actor method {self._name!r} must be invoked "
                        f"with .remote()")


class ActorHandle:
    def __init__(self, actor_id: str, method_meta: dict[str, dict],
                 max_task_retries: int = 0, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._method_meta = method_meta
        self._max_task_retries = max_task_retries
        self._class_name = class_name

    @classmethod
    def _from_class(cls, actor_id: str, klass: type,
                    max_task_retries: int = 0) -> "ActorHandle":
        return cls(actor_id, _method_meta(klass), max_task_retries,
                   class_name=klass.__name__)

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self.__dict__.get("_method_meta", {})
        if meta and name not in meta:
            raise AttributeError(
                f"Actor {self._class_name!r} has no method {name!r}")
        return ActorMethod(self, name, meta.get(name, {}))

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id})"

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id, self._method_meta,
                                  self._max_task_retries, self._class_name))

    def __hash__(self) -> int:
        return hash(self._actor_id)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ActorHandle)
                and other._actor_id == self._actor_id)


def _rebuild_handle(actor_id, method_meta, max_task_retries, class_name):
    return ActorHandle(actor_id, method_meta, max_task_retries, class_name)
