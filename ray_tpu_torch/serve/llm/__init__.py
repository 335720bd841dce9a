"""LLM serving on the port: continuous batching on Serve.

Port of `ray_tpu/serve/llm`: the continuous-batching `EngineCore`, its KV
page bookkeeping, the `LLMEngine` deployment class with its push token
stream, the router (`LLMHandle`, `TokenStream` with mid-stream failover)
and `serve_llm`, which deploys `LLMEngine` replicas through the Serve
controller.

Quickstart (on the card; `device="cpu"` runs the plain PyTorch path)::

    import ray_tpu_torch
    from ray_tpu_torch.serve import llm

    ray_tpu_torch.init(num_cpus=4)
    handle = llm.serve_llm(model="tiny", num_replicas=1,
                           ray_actor_options={"num_gpus": 1})
    stream = handle.generate(list(b"the pod "), max_tokens=32)
    for token in stream:          # arrives as the engine decodes
        print(token)

`RAY_TPU_LLM_STREAM=0` falls back to polled `next_tokens` actor calls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.llm.engine import (EngineCore,  # noqa: F401
                                            LLMEngine)
from ray_tpu_torch.serve.llm.kv_cache import (PageAllocator,  # noqa: F401
                                              pages_from_budget,
                                              pages_needed)
from ray_tpu_torch.serve.llm.router import (LLMHandle,  # noqa: F401
                                            TokenStream)
from ray_tpu_torch.serve.llm.stream import (STREAM_STATS,  # noqa: F401
                                            stream_client)


def serve_llm(name: str = "llm", model: Any = "tiny",
              weights: Any = None, num_replicas: int = 2,
              mesh: Optional[Dict[str, int]] = None,
              num_pages: int = 0, page_size: int = 0,
              max_batch: int = 0, kv_budget_bytes: int = 0,
              seed: int = 0,
              max_ongoing_requests: int = 32,
              ray_actor_options: Optional[dict] = None,
              autoscaling_config: Any = None,
              broadcast_weights: bool = True,
              device: Any = None) -> LLMHandle:
    """Deploy an LLM engine deployment and return its routing handle.

    `weights` may be a params dict (put once; every replica gets it
    through the object plane, each tensor out of band in a shared-memory
    segment), an ObjectRef of one, or None (each replica inits
    identically from `seed`). `device` is the replicas' device: None is
    the card each replica sees (give it `ray_actor_options={"num_gpus":
    1}`), and `"cpu"` runs the plain PyTorch path on the CPU.

    `mesh` (an axes dict, e.g. {"tp": 2}) makes each replica a group of
    tp rank processes: the Serve replica is rank 0 and starts the other
    ranks as actors with the same `ray_actor_options` (e.g. `{"num_gpus":
    0.5}` puts two ranks on one card); each rank loads only its shard of
    `weights` (or makes it from `seed`), and `kv_budget_bytes` is per
    rank. See `LLMEngine`.
    """
    import ray_tpu_torch
    from ray_tpu_torch import serve

    if dataclasses.is_dataclass(model):
        # the config's kwargs: the controller then unpickles no torch
        model = dataclasses.asdict(model)
    ref = weights
    if weights is not None and not hasattr(weights, "object_id"):
        ref = ray_tpu_torch.put(weights)
    if ref is not None and broadcast_weights and num_replicas > 1:
        # cut-through relay: seed every node's store before the
        # replicas cold-start, so N replicas pull locally instead of
        # N point-to-point transfers from the owner
        try:
            from ray_tpu_torch._private import context as _context
            ctx = _context.maybe_ctx()
            bcast = getattr(ctx, "broadcast_object", None)
            if bcast is not None:
                bcast(ref.object_id)
        except BaseException:
            pass

    dep = serve.deployment(
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=dict(ray_actor_options or {}),
        autoscaling_config=autoscaling_config,
    )(LLMEngine).options(name=name)
    app = dep.bind(model=model, weights=ref, mesh=mesh,
                   num_pages=num_pages, page_size=page_size,
                   max_batch=max_batch,
                   kv_budget_bytes=kv_budget_bytes, seed=seed,
                   device=None if device is None else str(device),
                   ray_actor_options=(dict(ray_actor_options or {})
                                      if mesh else None))
    serve.run(app, name=name)
    return LLMHandle(name)


def get_llm_handle(name: str = "llm") -> LLMHandle:
    return LLMHandle(name)
