"""Task / actor specifications — the wire-level unit of work.

Parity: reference ``TaskSpecification`` (src/ray/common/task/task_spec.h)
collapsed to the fields the centralized runtime needs. Functions and actor
classes are registered once in the controller's function store (reference
GcsFunctionManager, src/ray/gcs/gcs_server/gcs_kv_manager.h) and referenced
by content hash, so hot-loop task submission ships ids, not pickles.
"""
from __future__ import annotations

import hashlib
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

import cloudpickle


# Per-process-tree session tag, hex-only (id parsing splits on 'r').
# Prefixing every task/object id with it names shm segments
# rtt_<tag>... so end-of-session orphan sweeps can't touch a
# concurrent driver's segments. Child processes inherit it via env.
import os as _os

import re as _re

_env_tag = _os.environ.get("RAY_TPU_TORCH_SESSION", "")
# only a sane hex tag counts as inherited (ids are parsed on 'r' and
# segment names are swept by prefix — junk/empty values are ignored)
SESSION_TAG_INHERITED = bool(_re.fullmatch(r"[0-9a-f]{4,16}", _env_tag))
SESSION_TAG = _env_tag if SESSION_TAG_INHERITED else uuid.uuid4().hex[:6]
_os.environ["RAY_TPU_TORCH_SESSION"] = SESSION_TAG


# Pooled entropy for hot-path id minting: uuid4() costs one urandom
# syscall per id (~0.4 ms under load on the CI box — 23% of per-submit
# head CPU); drawing a 1 KiB urandom block and slicing it keeps the
# same entropy per id at one syscall per ~85 ids.
import threading as _threading

_hex_pool = ""
_hex_lock = _threading.Lock()


def _reset_hex_pool() -> None:
    # fork safety: a child inheriting the pool (and possibly a held
    # lock) would mint the same ids as its parent — uuid4's per-call
    # urandom read never had that problem
    global _hex_pool, _hex_lock
    _hex_pool = ""
    _hex_lock = _threading.Lock()


if hasattr(_os, "register_at_fork"):
    _os.register_at_fork(after_in_child=_reset_hex_pool)


def rand_hex(n: int) -> str:
    global _hex_pool
    with _hex_lock:
        if len(_hex_pool) < n:
            _hex_pool = _os.urandom(512).hex()
        out, _hex_pool = _hex_pool[:n], _hex_pool[n:]
    return out


def new_task_id() -> str:
    return SESSION_TAG + rand_hex(12)


def new_actor_id() -> str:
    return rand_hex(16)


def function_id(pickled: bytes) -> str:
    return hashlib.sha1(pickled).hexdigest()[:16]


@dataclass
class RefMarker:
    """Placeholder for a top-level ObjectRef argument: the executing worker
    fetches the value before invoking the function (dependency resolution,
    reference transport/dependency_resolver.cc analogue)."""
    object_id: str


@dataclass
class TaskSpec:
    task_id: str
    func_id: str                      # key into the function store
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    num_returns: int = 1
    return_ids: list[str] = field(default_factory=list)
    resources: dict[str, float] = field(default_factory=dict)
    max_retries: int = 3
    retries_used: int = 0
    name: str = ""
    # scheduling
    placement_group_id: Optional[str] = None
    placement_group_bundle_index: int = -1
    scheduling_strategy: Any = None
    node_id: Optional[str] = None     # node affinity (cluster sim)
    affinity_soft: bool = False       # soft affinity falls back anywhere
    # normalized (hard, soft) node-label constraints, or None
    label_constraints: Any = None
    runtime_env: Optional[dict] = None
    # bookkeeping (filled by runtime)
    pinned_refs: list[str] = field(default_factory=list)
    # tracing plane (r9): the trace this task belongs to and the span
    # it parents under (the submit span); 0 = untraced. Travels with
    # the pickled spec so scheduler/worker spans stitch cross-process.
    trace_id: int = 0
    parent_span: int = 0
    # Partition-tolerant membership (r17): bumped at every re-place
    # (retry, node-death resubmit, lease reclaim, lineage/head-restart
    # resubmission). Completion entries echo the attempt they executed;
    # the head drops terminal events for stale attempts (first-
    # terminal-wins), so a fenced zombie's TASK_DONE can never race
    # the re-placed winner into a double count.
    attempt: int = 0

    def __getstate__(self):
        # The metrics plane's head-side submit stamp (_submit_mono) is
        # read off the head's mirrored spec only — a monotonic reading
        # is meaningless in another process, so keep it off the wire.
        state = self.__dict__
        if "_submit_mono" in state:
            state = {k: v for k, v in state.items()
                     if k != "_submit_mono"}
        return state


@dataclass
class ActorSpec:
    actor_id: str
    class_id: str                     # key into the function store
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)
    resources: dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    name: Optional[str] = None
    namespace: str = "default"
    lifetime: Optional[str] = None    # "detached" or None
    placement_group_id: Optional[str] = None
    placement_group_bundle_index: int = -1
    scheduling_strategy: Any = None
    node_id: Optional[str] = None
    affinity_soft: bool = False
    label_constraints: Any = None
    runtime_env: Optional[dict] = None
    # the constructor's top-level ObjectRef args: pinned while the actor
    # may still run its constructor (a restart runs it again), released
    # when the actor is dead for good
    pinned_refs: list[str] = field(default_factory=list)


@dataclass
class ActorTaskSpec:
    task_id: str
    actor_id: str
    method_name: str
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    num_returns: int = 1
    return_ids: list[str] = field(default_factory=list)
    max_retries: int = 0              # from actor's max_task_retries
    retries_used: int = 0
    name: str = ""
    pinned_refs: list[str] = field(default_factory=list)
    # tracing plane (r9): see TaskSpec
    trace_id: int = 0
    parent_span: int = 0

    # same contract as TaskSpec: the head-side e2e submit stamp never
    # ships in pickled copies
    __getstate__ = TaskSpec.__getstate__


def bump_attempt(spec: Any) -> None:
    """Advance a spec's re-place attempt counter (r17 membership):
    call at EVERY site that hands an already-submitted spec back to
    ``cluster.submit``. Safe on pre-r17 pickled specs (the attribute
    is created) and on frozen/odd spec objects (best effort)."""
    try:
        spec.attempt = int(getattr(spec, "attempt", 0)) + 1
    except Exception:
        pass


def pickle_callable(fn: Any) -> tuple[str, bytes]:
    data = cloudpickle.dumps(fn)
    return function_id(data), data


def extract_ref_args(args: tuple, kwargs: dict, keep: list):
    """Replace top-level ObjectRef args with RefMarkers; return pinned ids.

    Nested refs (inside lists/dicts/dataclasses) pass through pickled and
    arrive as borrowed ObjectRefs, matching reference semantics where only
    top-level refs are resolved to values before execution.

    A top-level arg that is, or holds inside dicts, lists and tuples, a
    `bytes` or `bytearray` of at least `inline_threshold_bytes` is `put` in
    the object store and passed as a RefMarker too, so those bytes travel
    out of band and not inside the spec's frame (which
    `wire_max_frame_bytes` bounds). Its ObjectRef goes into `keep`: the
    caller holds it until the submit has pinned the id."""
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.object_store import bytes_out_of_band
    from ray_tpu_torch._private.refs import ObjectRef
    pinned: list[str] = []

    def conv(v):
        if bytes_out_of_band(v, CONFIG.inline_threshold_bytes) is not v:
            from ray_tpu_torch._private import context
            v = context.get_ctx().put(v)
            keep.append(v)
        if isinstance(v, ObjectRef):
            pinned.append(v.object_id)
            return RefMarker(v.object_id)
        return v

    new_args = tuple(conv(a) for a in args)
    new_kwargs = {k: conv(v) for k, v in kwargs.items()}
    return new_args, new_kwargs, pinned
