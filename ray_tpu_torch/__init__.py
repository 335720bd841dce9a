"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package `ray_tpu` stays the reference; this package grows beside
it, one slice at a time, and imports nothing of it (nor JAX). The first
slice is the serving path: the Llama-family decoder, its paged
prefill/decode forwards and the continuous-batching `EngineCore`. The
second is the training path: `Transformer.loss`, its backward and an
AdamW step (`ray_tpu_torch.bench`). Later slices added `save_attn` remat
and `LLMEngine`, the serving deployment class, with its push token
stream, then the single-host runtime: ``init/shutdown/remote/get/put/
wait/kill/cancel/get_actor`` and actors, with a ``GPU`` resource that
counts the CUDA devices. Their kernels are written by hand in CUDA C++
for `sm_90a` (`ops/csrc/`): the flash-attention forward, its dK/dV and
dQ backward, and the RMSNorm forward.

Entry points run on the card unless the caller passes `device="cpu"`;
on the CPU every kernel wrapper runs its plain PyTorch version, which is
what the parity tests compare against the JAX package.

The core API resolves at first use (as `ray_tpu`'s does at import), so
`import ray_tpu_torch.ops` or `.models` loads neither the runtime nor its
codec, and a worker process imports no torch until a task needs it.
"""
import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "init": "ray_tpu_torch._private.runtime",
    "shutdown": "ray_tpu_torch._private.runtime",
    "ObjectRef": "ray_tpu_torch._private.refs",
    "ActorClass": "ray_tpu_torch.actor",
    "ActorHandle": "ray_tpu_torch.actor",
    "cancel": "ray_tpu_torch.api",
    "available_resources": "ray_tpu_torch.api",
    "broadcast": "ray_tpu_torch.api",
    "cluster_resources": "ray_tpu_torch.api",
    "get": "ray_tpu_torch.api",
    "get_actor": "ray_tpu_torch.api",
    "kill": "ray_tpu_torch.api",
    "method": "ray_tpu_torch.api",
    "put": "ray_tpu_torch.api",
    "remote": "ray_tpu_torch.api",
    "wait": "ray_tpu_torch.api",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    if name == "exceptions":
        return importlib.import_module("ray_tpu_torch.exceptions")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))


def is_initialized() -> bool:
    from ray_tpu_torch._private import context
    return context.is_initialized()


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "method", "get", "put",
    "wait", "kill", "cancel", "broadcast", "get_actor",
    "cluster_resources", "available_resources", "ObjectRef", "ActorClass",
    "ActorHandle", "exceptions", "__version__",
]
