"""The process's runtime context (the port's stub).

Port of `maybe_ctx()` and `is_initialized()` of
`ray_tpu/_private/context.py`. The port has no runtime yet, so no
context is ever set: `maybe_ctx()` returns None, as the JAX function
does in a process outside a cluster.
"""
from __future__ import annotations

from typing import Any, Optional

_ctx: Optional[Any] = None


def maybe_ctx() -> Optional[Any]:
    return _ctx


def is_initialized() -> bool:
    return _ctx is not None
