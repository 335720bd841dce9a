"""Config registry with environment override (the port's copy).

Port of `ray_tpu/_private/config.py`, holding only the entries the port
reads. Every entry is overridable via ``RAY_TPU_<NAME>`` (upper-cased),
the same variable names as the JAX package, read at first access;
``CONFIG.reload()`` re-reads the environment.

Usage::

    from ray_tpu_torch._private.config import CONFIG
    if CONFIG.llm_stream: ...
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True)
class ConfigEntry:
    name: str
    default: Any
    parse: Callable[[str], Any]
    doc: str


_REGISTRY: Dict[str, ConfigEntry] = {}


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _define(name: str, default: Any, doc: str) -> None:
    parse: Callable[[str], Any]
    if isinstance(default, bool):
        parse = _parse_bool
    elif isinstance(default, int):
        parse = int
    elif isinstance(default, float):
        parse = float
    else:
        parse = str
    _REGISTRY[name] = ConfigEntry(name, default, parse, doc)


# ---------------------------------------------------------------- knobs
_define("metrics", True,
        "Master switch for the metrics plane: 0 registers no series and "
        "every observe short-circuits on one memoized gate.")
_define("llm_stream", True,
        "LLM serving token transport (serve/llm): 1 streams tokens over "
        "a peer-dialed push connection to the engine; 0 falls back to "
        "the polled next_tokens path.")
_define("llm_page_size", 16,
        "KV-cache page size in token positions. Every sequence's cache "
        "occupancy is a whole number of pages; smaller pages waste less "
        "on short tails but grow the page tables.")
_define("llm_max_batch", 8,
        "Continuous-batching decode width per engine: the step loop "
        "decodes up to this many in-flight sequences per iteration.")
_define("llm_step_delay_s", 0.0,
        "Debug/chaos pacing: sleep this long between engine iterations. "
        "Stretches generations so fault-injection tests can land a kill "
        "or a drain mid-stream; keep 0 in production.")
_define("llm_stream_wait_s", 0.5,
        "Polled token fallback (llm_stream=0): how long next_tokens "
        "parks server-side waiting for fresh tokens before returning an "
        "empty slice.")


class _Config:
    """Attribute access resolves registry entries with env override."""

    def __init__(self):
        self._cache: Dict[str, Any] = {}
        # Bumped by reload(): per-call-site memos of derived config
        # state (metrics_plane.enabled) key on this instead of
        # re-reading the environment.
        self._gen: int = 0

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        cache = self.__dict__["_cache"]
        if name in cache:
            return cache[name]
        entry = _REGISTRY.get(name)
        if entry is None:
            raise AttributeError(
                f"unknown config {name!r}; known: {sorted(_REGISTRY)}")
        env = os.environ.get("RAY_TPU_" + name.upper())
        value = entry.default if env is None else entry.parse(env)
        cache[name] = value
        return value

    def reload(self) -> None:
        """Drop cached values so env overrides re-apply."""
        self.__dict__["_cache"].clear()
        self.__dict__["_gen"] += 1


CONFIG = _Config()
