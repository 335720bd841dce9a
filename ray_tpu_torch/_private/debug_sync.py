"""Lock-order-inversion detection for the pure-Python runtime.

SURVEY §5.2 parity: the reference runs its C++ core under
TSan/deadlock sanitizers in CI (reference .bazelrc tsan configs,
BUILD sanitizer toggles). A pure-Python runtime has no TSan, but the
failure mode those configs exist to catch — two threads taking the
same pair of locks in opposite orders — is detectable the same way
TSan's deadlock detector does it: record the acquisition graph and
flag the first edge that closes a cycle, at the moment it is taken,
whether or not the schedule actually deadlocks this run.

Enable with ``RAY_TPU_DEBUG_LOCKS=1``: runtime subsystems create their
mutexes via :func:`make_lock`, which returns an :class:`OrderedLock`
recording, per thread, the stack of held locks and, globally, every
held->acquiring edge with the stack trace that created it. A cycle
raises :class:`LockOrderInversion` (fail-fast in tests) or, with
``RAY_TPU_DEBUG_LOCKS=warn``, writes the report to stderr and
continues. Disabled (the default), make_lock returns a plain
``threading.Lock`` — zero overhead in production.
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, Optional, Set

__all__ = ["make_lock", "LockOrderInversion", "lock_report",
           "reset_lock_graph", "enabled"]


class LockOrderInversion(RuntimeError):
    """Two lock sites acquired in inconsistent order across threads."""


def enabled() -> str:
    """"" (off), "raise", or "warn"."""
    v = os.environ.get("RAY_TPU_DEBUG_LOCKS", "").strip().lower()
    if v in ("", "0", "false"):
        return ""
    return "warn" if v == "warn" else "raise"


class _LockGraph:
    """Global acquisition-order graph: edge A->B means some thread
    acquired B while holding A. A path B~>A existing when edge A->B is
    added is an inversion."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}
        self._sites: Dict[tuple, str] = {}   # (a, b) -> formatted stack
        self._inversions: list[dict] = []

    def add_edge(self, held: str, acquiring: str, mode: str) -> None:
        with self._mu:
            if acquiring in self._edges.get(held, ()):
                return                      # known-good edge
            # cycle check BEFORE recording: path acquiring ~> held?
            if self._path_exists(acquiring, held):
                prior = self._sites.get((acquiring, held)) or next(
                    (s for (a, _b), s in self._sites.items()
                     if a == acquiring), "<site unknown>")
                here = "".join(traceback.format_stack(limit=8)[:-1])
                report = {
                    "cycle": f"{held} -> {acquiring} -> ... -> {held}",
                    "this_order": f"{held} held while acquiring "
                                  f"{acquiring}",
                    "this_site": here,
                    "reverse_site": prior,
                }
                self._inversions.append(report)
                msg = (f"lock-order inversion: {report['cycle']}\n"
                       f"--- this acquisition ({report['this_order']}) "
                       f"---\n{here}\n--- reverse-order site ---\n"
                       f"{prior}")
                if mode == "raise":
                    raise LockOrderInversion(msg)
                import sys
                sys.stderr.write("ray_tpu_torch DEBUG_LOCKS: " + msg + "\n")
                return
            self._edges.setdefault(held, set()).add(acquiring)
            self._sites[(held, acquiring)] = "".join(
                traceback.format_stack(limit=8)[:-1])

    def _path_exists(self, src: str, dst: str) -> bool:
        seen = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False

    def report(self) -> dict:
        with self._mu:
            return {"locks": sorted({a for a in self._edges}
                                    | {b for bs in self._edges.values()
                                       for b in bs}),
                    "edges": {a: sorted(bs)
                              for a, bs in self._edges.items()},
                    "inversions": list(self._inversions)}

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._sites.clear()
            self._inversions.clear()


_GRAPH = _LockGraph()
_HELD = threading.local()            # per-thread list of held lock names


def lock_report() -> dict:
    """Acquisition graph + inversions observed so far."""
    return _GRAPH.report()


def reset_lock_graph() -> None:
    _GRAPH.reset()


def _held_stack() -> list:
    held = getattr(_HELD, "stack", None)
    if held is None:
        held = _HELD.stack = []
    return held


def _depths() -> dict:
    d = getattr(_HELD, "depths", None)
    if d is None:
        d = _HELD.depths = {}
    return d


class OrderedLock:
    """Drop-in for ``threading.Lock``/``RLock`` that feeds the order
    graph. Implements the private Condition protocol
    (``_release_save``/``_acquire_restore``/``_is_owned``) so it can
    back a ``threading.Condition``; the held-stack stays accurate
    across ``wait()``."""

    def __init__(self, name: str, mode: str, reentrant: bool = False):
        self._name = name
        self._mode = mode
        self._lock = threading.RLock() if reentrant else threading.Lock()

    # -- lock protocol --
    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        held = _held_stack()
        depths = _depths()
        first = depths.get(self._name, 0) == 0
        if first and held:
            _GRAPH.add_edge(held[-1], self._name, self._mode)
        got = self._lock.acquire(blocking, timeout)
        if got:
            depths[self._name] = depths.get(self._name, 0) + 1
            if first:
                held.append(self._name)
        return got

    def release(self) -> None:
        depths = _depths()
        left = depths.get(self._name, 1) - 1
        if left <= 0:
            depths.pop(self._name, None)
            held = _held_stack()
            if held and held[-1] == self._name:
                held.pop()
            elif self._name in held:     # out-of-order release
                held.remove(self._name)
        else:
            depths[self._name] = left
        self._lock.release()

    def locked(self) -> bool:
        try:
            return self._lock.locked()
        except AttributeError:           # RLock pre-3.12 fallback
            if self._lock.acquire(False):
                self._lock.release()
                return False
            return True

    # -- Condition protocol --
    def _is_owned(self) -> bool:
        inner = getattr(self._lock, "_is_owned", None)
        if inner is not None:
            return inner()
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _release_save(self):
        depths = _depths()
        d = depths.pop(self._name, 1)
        held = _held_stack()
        if self._name in held:
            held.remove(self._name)
        inner = getattr(self._lock, "_release_save", None)
        if inner is not None:
            return ("r", inner(), d)
        self._lock.release()
        return ("p", None, d)

    def _acquire_restore(self, state) -> None:
        kind, inner_state, d = state
        # no edge recording: a condvar re-acquire resumes logical
        # ownership, it is not a fresh lock-ordering decision
        if kind == "r":
            self._lock._acquire_restore(inner_state)
        else:
            self._lock.acquire()
        _depths()[self._name] = d
        _held_stack().append(self._name)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"OrderedLock({self._name!r})"


def make_lock(name: str, reentrant: bool = False) -> object:
    """A mutex for a named runtime subsystem: plain
    ``threading.Lock``/``RLock`` normally, an order-tracking
    :class:`OrderedLock` under ``RAY_TPU_DEBUG_LOCKS``."""
    mode = enabled()
    if not mode:
        return threading.RLock() if reentrant else threading.Lock()
    return OrderedLock(name, mode, reentrant=reentrant)
