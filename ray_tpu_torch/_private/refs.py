"""ObjectRef: the distributed future handle.

Parity: reference python/ray/_raylet.pyx ObjectRef + C++ reference counting
(src/ray/core_worker/reference_count.cc). The protocol is centralized (the
head's controller owns all refcounts) with a real borrower protocol
(reference reference_count.h:64,115-117 borrower registration +
WaitForRefRemoved):

- Deserializing a ref ANYWHERE registers a borrow (ADDREF) and the
  borrowing process sends a deferred DECREF when its copy is collected —
  so an actor may store a ref it received inside an argument past the
  carrying task and the object stays alive until the actor drops it.
- The submit-time pin covers the window before the borrow registers:
  the executing worker's ADDREF and the task's TASK_DONE (which releases
  the pin) travel the same FIFO connection, so the count can never dip
  to zero between them.
- Objects CONTAINING refs (a put() of a list of refs, a task returning
  refs) register containment at seal time: the enclosing object holds a
  count on each inner ref, released when the enclosing object is
  deleted (reference reference_count.cc nested-ref ownership).

Known conservatism: a borrowing worker that is SIGKILLed never sends its
deferred DECREF, so its borrows leak until session shutdown (the
reference reclaims these via per-borrower death cleanup). Decrefs
deferred while NO context is installed park in a BOUNDED set and drain
on the next context attach (r16; see ``_PARK_MAX`` below) — previously
they parked unbounded until session shutdown.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional

from ray_tpu_torch._private import context as _context

# Serialize-time containment capture: object_store.serialize() installs a
# collector here; ObjectRef.__reduce__ records every ref pickled into the
# enclosing object so the store can register containment at seal.
_capture = threading.local()

# Deferred decrefs: __del__ may fire during GC at ANY allocation point —
# including while the current thread holds a non-reentrant lock that the
# decref's deletion path needs (store lock, connection send lock), a
# guaranteed self-deadlock. So __del__ only appends the id here; a
# dedicated flusher thread performs the actual decref (the reference
# defers destructor work to the core worker's io service the same way).
#
# Parked-set bound (r16): while NO context is installed (shutdown /
# re-init gap, or a process that dropped refs before ever attaching),
# the ids PARK here. Unbounded parking was the documented borrow leak —
# a context-less process collecting refs forever grew this deque until
# session end. Past _PARK_MAX the flusher trims the OLDEST parked ids
# (their owner-side counts leak, counted in `dropped_parked`, the same
# conservative direction as a SIGKILLed borrower); everything still
# parked drains the moment a context attaches (context.set_ctx wakes
# the flusher).
_PARK_MAX = 65_536
_deferred: collections.deque = collections.deque()
dropped_parked = 0
_flush_wake = threading.Event()
_flusher_started = False
_flusher_lock = threading.Lock()

# Release hooks (r18): caches keyed by object id — the direct actor
# plane's inline-reply result cache — register here so a ref's release
# also drops the cached value. Invoked on the flusher thread with each
# drained id batch BEFORE the owner-side decref, so a hook never sees
# an id whose owner-side count it could revive.
_release_hooks: list = []


def register_release_hook(fn) -> None:
    """Register fn(object_ids) to run for every flushed decref batch.
    Process-lifetime registration (callers are per-process singletons
    like the direct actor caller's inline-result cache)."""
    _release_hooks.append(fn)


def _ensure_flusher() -> None:
    global _flusher_started
    if _flusher_started:
        return
    with _flusher_lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(target=_flush_loop, name="rtpu-decref",
                     daemon=True).start()


def _flush_loop() -> None:
    global dropped_parked
    while True:
        if not _deferred:
            _flush_wake.wait(0.2)
            _flush_wake.clear()
            continue
        ctx = _context.maybe_ctx()
        if ctx is None:
            # No context (shutdown / re-init gap): leave the ids parked
            # — popping here would leak the owner-side count forever.
            # set_ctx wakes us the moment a new context installs and
            # the parked backlog drains first thing. The set is
            # BOUNDED (r16): trim the oldest past _PARK_MAX so a
            # context-less process cannot grow it for its lifetime.
            while len(_deferred) > _PARK_MAX:
                try:
                    _deferred.popleft()
                    dropped_parked += 1
                except IndexError:
                    break
            _flush_wake.wait(0.2)
            _flush_wake.clear()
            continue
        # Drain in batches: one DECREF_BATCH frame instead of N DECREF
        # frames (context impls without a wire hop just loop locally).
        # The configured cap is clamped to 64, the wire's structural-
        # encoding bound for language-neutral id lists.
        from ray_tpu_torch._private.config import CONFIG
        cap = min(64, max(1, int(CONFIG.wire_batch_max_frames)))
        batch: list[str] = []
        while len(batch) < cap:
            try:
                batch.append(_deferred.popleft())
            except IndexError:
                break
        for hook in _release_hooks:
            try:
                hook(batch)
            except Exception:
                pass
        try:
            ctx.decref_batch(batch)
        except Exception:
            pass


class ObjectRef:
    __slots__ = ("_id", "_owned", "__weakref__")

    def __init__(self, object_id: str, owned: bool = True):
        self._id = object_id
        self._owned = owned

    @property
    def object_id(self) -> str:
        return self._id

    def hex(self) -> str:
        return self._id

    def __repr__(self) -> str:
        return f"ObjectRef({self._id})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self) -> int:
        return hash(self._id)

    def __reduce__(self):
        ids = getattr(_capture, "ids", None)
        if ids is not None:
            ids.append(self._id)
        return (_reconstruct_borrowed, (self._id,))

    def __del__(self):
        if self._owned and _context.maybe_ctx() is not None:
            # never decref synchronously from a destructor (see
            # _deferred above); deque.append is GC-reentrancy-safe
            _deferred.append(self._id)
            _flush_wake.set()
            _ensure_flusher()

    # `await ref` support inside async actors.
    def __await__(self):
        def _get():
            ctx = _context.get_ctx()
            return ctx.get_objects([self._id], timeout=None)[0]
        yield
        return _get()

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        import concurrent.futures
        import threading
        fut: concurrent.futures.Future = concurrent.futures.Future()
        ref = self

        def _run():
            ctx = _context.get_ctx()
            try:
                fut.set_result(ctx.get_objects([ref._id], timeout=None)[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
        threading.Thread(target=_run, daemon=True).start()
        return fut


def _reconstruct_borrowed(object_id: str) -> ObjectRef:
    """Deserialization endpoint: register a borrow with the owner (the
    head) so the ref counts while this process holds it; the ref's
    __del__ sends the matching deferred decref. Falls back to a
    non-counting ref in processes without a runtime context (e.g. a
    relaying node agent)."""
    ctx = _context.maybe_ctx()
    if ctx is not None:
        try:
            ctx.addref(object_id)
            return ObjectRef(object_id, owned=True)
        except Exception:
            pass
    return ObjectRef(object_id, owned=False)


class ActorID:
    __slots__ = ("_id",)

    def __init__(self, actor_id: str):
        self._id = actor_id

    def hex(self) -> str:
        return self._id

    def __repr__(self) -> str:
        return f"ActorID({self._id})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ActorID) and other._id == self._id

    def __hash__(self) -> int:
        return hash(self._id)
