"""Pickle helpers shared by the user-facing shims.

cloudpickle serializes module-level functions/classes BY REFERENCE when
their module is importable in the current process — but worker
processes cannot import driver-only modules (scripts, test files,
notebooks' helper modules). `dumps_by_value` captures such objects by
VALUE instead, leaving true library code (stdlib/site-packages/ray_tpu_torch)
by reference.
"""
from __future__ import annotations

import os
import sys
from typing import Any

import cloudpickle


def _is_library_module(mod) -> bool:
    f = getattr(mod, "__file__", None)
    if not f:
        return True                    # builtins / frozen
    f = f.replace(os.sep, "/")
    return (f.startswith(sys.prefix.replace(os.sep, "/"))
            or "site-packages" in f
            or "/ray_tpu_torch/" in f)


def dumps_by_value(obj: Any, roots: tuple = ()) -> bytes:
    """Serialize `obj`, forcing driver-local modules by value. `roots`
    names additional objects whose defining modules must also ship by
    value (e.g. the user functions inside a joblib BatchedCalls
    wrapper, which itself lives in library code)."""
    mods = []
    for o in (obj, *roots):
        mod = sys.modules.get(getattr(o, "__module__", None) or "")
        if (mod is not None and mod.__name__ != "__main__"
                and not _is_library_module(mod)
                and mod not in mods):
            mods.append(mod)
    for m in mods:
        cloudpickle.register_pickle_by_value(m)
    try:
        return cloudpickle.dumps(obj)
    finally:
        for m in mods:
            cloudpickle.unregister_pickle_by_value(m)
