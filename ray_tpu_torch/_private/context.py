"""Process-global runtime context.

Every process participating in a ray_tpu_torch cluster — the driver or a spawned
worker — installs exactly one ``BaseContext`` implementation here. The public
API (``ray_tpu_torch.get/put/remote/...``) routes through it, so user code behaves
identically whether it runs in the driver or inside a remote task/actor
(mirroring the reference where both driver and workers embed the same core
worker library, reference src/ray/core_worker/core_worker.h:271).
"""
from __future__ import annotations

from typing import Any, Optional

from ray_tpu_torch.exceptions import RuntimeNotInitializedError

_ctx: Optional["BaseContext"] = None


class BaseContext:
    """Interface both the driver runtime and worker context implement."""

    is_driver: bool = False

    # object plane
    def put(self, value: Any) -> "ObjectRef": raise NotImplementedError
    def get_objects(self, object_ids: list[str],
                    timeout: Optional[float]) -> list[Any]:
        raise NotImplementedError
    def wait(self, object_ids: list[str], num_returns: int,
             timeout: Optional[float]) -> tuple[list[str], list[str]]:
        raise NotImplementedError
    def addref(self, object_id: str) -> None: pass
    def decref(self, object_id: str) -> None: pass

    def decref_batch(self, object_ids: list[str]) -> None:
        """Release N refs at once. Contexts with a wire hop override
        this with a single DECREF_BATCH frame; the default just loops."""
        for oid in object_ids:
            self.decref(oid)

    # task plane
    def submit_task(self, spec) -> list[str]: raise NotImplementedError
    def create_actor(self, spec) -> str: raise NotImplementedError
    def submit_actor_task(self, actor_id: str, spec) -> list[str]:
        raise NotImplementedError
    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        raise NotImplementedError
    def cancel_task(self, object_id: str, force: bool = False) -> None:
        raise NotImplementedError

    # control plane
    def kv_op(self, op: str, key: str, value: Any = None,
              namespace: str = "default") -> Any:
        raise NotImplementedError
    def get_actor_handle(self, name: str, namespace: str = "default"):
        raise NotImplementedError
    def state_op(self, op: str, **kwargs) -> Any:
        raise NotImplementedError

    def node_resources(self) -> dict:
        raise NotImplementedError


_ctx_epoch = 0


def set_ctx(ctx: Optional[BaseContext]) -> None:
    global _ctx, _ctx_epoch
    if ctx is not None and not hasattr(ctx, "ctx_epoch"):
        # monotonic context identity: id() of a new Runtime can collide
        # with a freed one's address, so per-runtime caches (prepared
        # runtime envs, function registration) key on this instead
        _ctx_epoch += 1
        ctx.ctx_epoch = _ctx_epoch
    _ctx = ctx
    if ctx is not None:
        # decrefs deferred while no context was installed (shutdown /
        # re-init gap) drain now instead of leaking the owner count
        from ray_tpu_torch._private import refs as _refs
        _refs._flush_wake.set()


def get_ctx() -> BaseContext:
    if _ctx is None:
        raise RuntimeNotInitializedError()
    return _ctx


def maybe_ctx() -> Optional[BaseContext]:
    return _ctx


def is_initialized() -> bool:
    return _ctx is not None
