"""Object plane: serialization + shared-memory object store.

Replaces the reference's two-tier object plane (in-process memory store,
reference src/ray/core_worker/store_provider/memory_store/memory_store.h:43,
and the plasma shm arena, reference src/ray/object_manager/plasma/) with:

- ``serialize``/``deserialize`` built on pickle protocol 5 with
  ``buffer_callback``: large contiguous buffers (numpy arrays, and torch
  tensors through ``_Pickler``) are carved out-of-band so cross-process
  transfer is zero-copy through
  POSIX shared memory, the same property plasma's fd-passing provides
  (reference plasma/fling.cc) without a bespoke arena: the kernel shm
  object *is* the arena and the eviction unit.
- ``LocalStore``: the driver-resident authoritative store. Small payloads
  live inline; each large buffer lives in its own named shm segment,
  unlinked when the distributed refcount hits zero (refcounting lives in
  the controller, reference core_worker/reference_count.cc analogue).

Lifetime design: a segment exists *by name* in the kernel from creation
until ``shm_unlink``; no process needs to hold a handle to keep it alive.
Creators therefore write, then immediately close the fd. Readers map via
raw ``mmap`` (not SharedMemory, which would leak an fd per attach); the
mapping is freed automatically when the last deserialized array view is
garbage collected. Unlink-while-mapped is safe POSIX: existing mappings
survive, the name disappears.

Segment pooling (``_SegmentPool``): refcount-zero releases feed a
bounded size-classed free pool (segments renamed, not unlinked) that
the next compatible ``put`` reuses, eliminating the per-put
create/zero-fill/fault/unlink churn on the large-object path;
``RAY_TPU_SHM_POOL=0`` restores strict unlink-on-free. Reuse is only
sound because nothing can still be mapping a pooled segment's pages:
deserialized views hold a borrow on their object until collected
(``_pin_mapped_object``), so the refcount cannot hit zero under them;
transient copiers (pull serving) mark their names via
``guard_segments``; and every release site that can run with live
refs (spill, stale re-put) keeps the mapping-safe plain unlink.
"""
from __future__ import annotations

import collections
import io
import mmap
import os
import pickle
import sys
import threading
import time
import uuid
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

import _posixshmem  # CPython's shm syscall wrapper (used by SharedMemory)
import cloudpickle

# Buffers below this many bytes ride inline in the pickled payload; larger
# ones are carved into shm segments. Mirrors the reference's inline-small
# -return threshold semantics (task returns under ~100KiB go to the owner's
# memory store; reference core_worker.h AllocateReturnObject).
from ray_tpu_torch._private.config import CONFIG as _CFG


def _local_tag() -> str:
    """Segment names carry the PRODUCING process tree's session tag
    (not the id-issuer's): a task submitted by a remote driver but
    executed here seals segments on THIS host, and this host's
    tag-prefixed sweep must find them."""
    from ray_tpu_torch._private.specs import SESSION_TAG
    return SESSION_TAG


def new_object_id() -> str:
    from ray_tpu_torch._private.specs import SESSION_TAG, rand_hex
    return SESSION_TAG + rand_hex(14)


@dataclass
class StoredObject:
    """Serialized object: inline payload + optional out-of-band shm buffers."""
    object_id: str
    payload: bytes                      # pickle5 stream (buffers external)
    inline_buffers: list[bytes] = field(default_factory=list)
    shm_names: list[str] = field(default_factory=list)
    shm_sizes: list[int] = field(default_factory=list)
    buffer_order: list[str] = field(default_factory=list)  # "i" inline / "s" shm
    is_error: bool = False              # payload deserializes to an exception
    # object ids of refs pickled INSIDE this value: the controller holds
    # a count on each until this object is deleted (nested-ref ownership,
    # reference reference_count.cc)
    contained_ids: list[str] = field(default_factory=list)
    # kernel bytes actually backing each shm segment (pool class-
    # rounding makes this larger than shm_sizes): what capacity/spill
    # ledgers must charge, while shm_sizes stays the mmap data length.
    # Empty for pre-pool producers -> nbytes falls back to shm_sizes.
    shm_alloc_sizes: list[int] = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        # getattr: a StoredObject pickled by a pre-pool peer restores
        # without the field (pickle bypasses __init__)
        alloc = getattr(self, "shm_alloc_sizes", None)
        return (len(self.payload) + sum(len(b) for b in self.inline_buffers)
                + sum(alloc or self.shm_sizes))


class _SegmentPool:
    """Size-classed free pool of shm segments (reference plasma keeps
    its arena mapped for the same reason: creating + faulting fresh
    kernel pages per large put dominates the copy itself).

    A freed segment is RENAMED (atomic on the /dev/shm tmpfs) into a
    bounded per-class free list instead of unlinked; the next put of a
    compatible size renames it back to its object name and overwrites
    it — skipping shm_open(O_CREAT)/ftruncate and, far more
    importantly, the page-zeroing + soft-fault cost of first touch.
    Pool names carry the session tag (``rtt_<tag>_pool...``), so the
    existing unlink-by-name lifetime rules still apply: pool overflow
    falls back to a plain unlink, and the session shutdown sweep reaps
    anything still pooled. Per-process: the driver (which frees most
    result segments) feeds its own next puts."""

    MIN_CLASS = 17          # 128 KiB: below that, buffers ride inline

    def __init__(self):
        self._classes: dict[int, "collections.deque[str]"] = {}
        self._lock = threading.Lock()
        self._bytes = 0
        self.reused = 0     # introspection / bench counters
        self.pooled = 0
        self.misses = 0     # eligible acquires the pool couldn't serve

    @staticmethod
    def _cls(nbytes: int) -> int:
        return max((nbytes - 1).bit_length(), _SegmentPool.MIN_CLASS)

    @staticmethod
    def class_size(nbytes: int) -> int:
        return 1 << _SegmentPool._cls(nbytes)

    def _enabled(self) -> bool:
        return _CFG.shm_pool and os.path.isdir("/dev/shm")

    def acquire(self, name: str, data_len: int) -> bool:
        """Rename a pooled segment of the right class to `name`.
        False when the pool has nothing compatible (caller creates)."""
        if not self._enabled():
            return False
        cls = self._cls(data_len)
        with self._lock:
            free = self._classes.get(cls)
            if not free:
                self.misses += 1
                return False
            pooled_name = free.popleft()
            self._bytes -= 1 << cls
        try:
            os.rename("/dev/shm/" + pooled_name, "/dev/shm/" + name)
        except OSError:
            # pooled entry vanished (external sweep): just miss
            self.misses += 1
            return False
        self.reused += 1
        return True

    def release(self, name: str) -> bool:
        """Take ownership of a freed segment: rename it into the pool.
        False -> not pooled (wrong shape / over budget / disabled /
        mid-copy in this process); the caller must unlink it as
        before."""
        if not self._enabled():
            return False
        path = "/dev/shm/" + name
        try:
            size = os.stat(path).st_size
        except OSError:
            return False
        # only class-shaped segments are reusable (pre-pool segments
        # have exact data sizes; renaming those would strand capacity)
        if size < (1 << self.MIN_CLASS) or size & (size - 1):
            return False
        cls = size.bit_length() - 1
        with self._lock:
            # a transient copier (pull serve, guard_segments) is mid-
            # map: renaming + reusing would overwrite the pages under
            # its copy — fall back to the unlink path, which existing
            # mappings survive. The guard registers and the rename
            # happens under the same lock, so there is no window where
            # a fresh guard can race an in-flight rename.
            if name in _guarded_segments:
                return False
            free = self._classes.setdefault(cls, collections.deque())
            if (len(free) >= _CFG.shm_pool_per_class
                    or self._bytes + size > _CFG.shm_pool_max_bytes):
                return False
            pooled_name = (f"rtt_{_local_tag()}_pool{cls:02d}_"
                           f"{uuid.uuid4().hex[:8]}")
            try:
                os.rename(path, "/dev/shm/" + pooled_name)
            except OSError:
                return False
            free.append(pooled_name)
            self._bytes += size
        self.pooled += 1
        return True

    def clear(self) -> int:
        """Unlink everything pooled (store shutdown)."""
        with self._lock:
            names = [n for free in self._classes.values() for n in free]
            self._classes.clear()
            self._bytes = 0
        for name in names:
            unlink_segment(name)
        return len(names)

    def stats(self) -> dict:
        with self._lock:
            return {"pool_bytes": self._bytes,
                    "pool_segments": sum(len(f) for f in
                                         self._classes.values()),
                    "pool_reused": self.reused,
                    "pool_misses": self.misses,
                    "pool_released": self.pooled,
                    # riding the pool surface into /metrics: the put
                    # path's user-space byte copies (r12 copy budget)
                    "put_bytes_copied": COPY_STATS["put_bytes_copied"]}


SEGMENT_POOL = _SegmentPool()

# Segment names a transient copier in THIS process is currently
# mapping (pull-serve materialize): free_segment must not pool these —
# reuse would overwrite the pages mid-copy, where plain unlink is
# harmless. Guarded by SEGMENT_POOL._lock (see release()).
_guarded_segments: collections.Counter = collections.Counter()


class guard_segments:
    """Context manager marking `names` as mapped-for-copy so a
    concurrent refcount-zero free in this process unlinks instead of
    pooling them (preserving the pages under the copy)."""

    def __init__(self, names):
        self._names = list(names)

    def __enter__(self):
        with SEGMENT_POOL._lock:
            _guarded_segments.update(self._names)
        return self

    def __exit__(self, *exc):
        with SEGMENT_POOL._lock:
            _guarded_segments.subtract(self._names)
            for n in self._names:
                if _guarded_segments[n] <= 0:
                    del _guarded_segments[n]
        return False


def free_segment(name: str) -> None:
    """Refcount-zero release path: pool the segment for reuse when
    possible, else unlink-by-name exactly as before. Only safe for
    segments with no established mappings — i.e. the refcount-zero
    delete path, where the deserialize-time borrow pin
    (_pin_mapped_object) guarantees no live views remain; every other
    release site (spill, stale re-put) must keep unlink_segment."""
    if not SEGMENT_POOL.release(name):
        unlink_segment(name)


# Copy accounting for the zero-copy envelope (r12): every user-space
# byte copy on the put path (serialize -> shm) bumps this, so the
# bytes-copied-per-byte-transferred bench columns and the metrics
# plane (ray_tpu_shm_pool{counter="put_bytes_copied"}) can prove copy
# regressions. Plain int increment under the GIL, WIRE_STATS
# discipline. Transfer-side copies live in OBJECT_PLANE_STATS.
COPY_STATS = {"put_bytes_copied": 0}


def bulk_copy(dst, dst_off: int, src) -> int:
    """Copy `src` (any contiguous buffer) into the writable buffer
    `dst` at `dst_off` — through the native GIL-released memcpy when
    the library is loadable, else a plain slice assign. Returns bytes
    copied. The single choke point for object-plane byte copies, so
    the copy counters cannot drift from the copies."""
    from ray_tpu_torch import native as _native
    n = src.nbytes if isinstance(src, memoryview) else len(src)
    if n >= 65536 and _native.available():
        _native.buf_copy(dst, dst_off, src)
    else:
        dst[dst_off:dst_off + n] = src
    return n


def _open_segment_for_write(name: str, n: int) -> tuple:
    """Create (or reuse from the pool) a named segment sized for `n`
    data bytes and return ``(mmap, alloc_size)`` with the mapping left
    OPEN for the caller to fill; the segment persists by name until
    shm_unlink. Fresh segments are rounded up to the pool's size class
    so they are poolable when freed (readers map only the data length;
    mapping a prefix of the file is fine). alloc_size is the allocated
    kernel size — the class-rounded figure capacity ledgers must
    charge (a reused segment's already-touched pages can span its
    whole class regardless of this object's data length)."""
    size = SEGMENT_POOL.class_size(n) if SEGMENT_POOL._enabled() else n
    if SEGMENT_POOL.acquire(name, n):
        try:
            fd = _posixshmem.shm_open("/" + name, os.O_RDWR, mode=0o600)
            try:
                mm = mmap.mmap(fd, n)
            finally:
                os.close(fd)
            return mm, size
        except (OSError, ValueError):
            # reused segment unusable after all: fall through to create
            unlink_segment(name)
    flags = os.O_CREAT | os.O_EXCL | os.O_RDWR
    try:
        fd = _posixshmem.shm_open("/" + name, flags, mode=0o600)
    except FileExistsError:
        # Stale segment from a killed process re-running the same task
        # (lineage resubmission re-uses the object id, and same-host
        # node agents share /dev/shm). The name encodes the producing
        # task, so reclaiming is safe.
        unlink_segment(name)
        fd = _posixshmem.shm_open("/" + name, flags, mode=0o600)
    try:
        os.ftruncate(fd, size)
        mm = mmap.mmap(fd, n)
    finally:
        os.close(fd)
    return mm, size


def _create_segment(name: str, data: memoryview) -> int:
    """Create (or reuse) + fill a named segment in one step — the
    serialize() path. One memcpy total (pickle5's buffer_callback
    hands over zero-copy views of the source arrays), GIL-released
    through the native core for large buffers. Returns the allocated
    kernel size (see _open_segment_for_write)."""
    n = len(data)
    mm, size = _open_segment_for_write(name, n)
    COPY_STATS["put_bytes_copied"] += bulk_copy(mm, 0, data)
    mm.close()
    return size


def _map_segment(name: str, size: int) -> memoryview:
    """Map an existing segment read-write; the fd is closed immediately so
    nothing leaks — the mmap lives as long as views into it do."""
    fd = _posixshmem.shm_open("/" + name, os.O_RDWR, mode=0o600)
    try:
        mm = mmap.mmap(fd, size)
    finally:
        os.close(fd)
    return memoryview(mm)[:size]


def reap_object_segments(object_id: str, max_buffers: int = 64) -> int:
    """Unlink shm segments a dead producer may have created for
    `object_id` before its TASK_DONE reached us (worker killed between
    serialize and send). Buffer indices may have gaps (small buffers
    store inline), so scan /dev/shm for the prefix rather than probing
    sequentially. Returns the number reaped."""
    reaped = 0
    prefix = f"rtt_{_local_tag()}_{object_id}_"
    try:
        names = [n for n in os.listdir("/dev/shm")
                 if n.startswith(prefix)]
    except OSError:
        # no listable shm dir (non-Linux): fall back to index probing
        # over the full range, tolerating gaps
        names = [f"rtt_{_local_tag()}_{object_id}_{i}"
                 for i in range(max_buffers)]
    for name in names:
        try:
            _posixshmem.shm_unlink("/" + name)
            reaped += 1
        except OSError:
            pass
    return reaped


def sweep_session_segments() -> int:
    """Unlink every shm segment created under THIS process tree's
    session tag (ids embed it, so segment names start with
    rtt_<tag>). Safe only once all of the session's producers and
    consumers are stopped — called from Runtime/NodeAgent shutdown."""
    from ray_tpu_torch._private.specs import SESSION_TAG
    # the trailing separator matters: tag "abcd" must never match a
    # concurrent session's "abcd12..." segments (every segment name is
    # rtt_<producer-tag>_<rest>)
    prefix = f"rtt_{SESSION_TAG}_"
    reaped = 0
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return 0
    for name in names:
        if name.startswith(prefix):
            try:
                _posixshmem.shm_unlink("/" + name)
                reaped += 1
            except OSError:
                pass
    return reaped


def unlink_segment(name: str) -> None:
    try:
        _posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass
    except OSError:
        pass


class _Pickler(cloudpickle.CloudPickler):
    """cloudpickle, with torch tensors out of band: a tensor pickles as
    its dtype, shape and one buffer of its bytes, which the buffer
    callback carves out as it does a numpy array's (torch's own reduce
    keeps the bytes in band). Torch is looked up, never imported: a
    process that has not loaded it holds no tensor."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) is torch.Tensor:
            reduced = _reduce_tensor(torch, obj)
            if reduced is not None:
                return reduced
        return super().reducer_override(obj)


def _reduce_tensor(torch, t) -> Optional[tuple]:
    """A dense tensor on the CPU or the card as (`_rebuild_tensor`,
    args); None for what torch's own reduce must keep (sparse,
    quantized, meta)."""
    if (t.layout != torch.strided or t.is_quantized
            or t.device.type not in ("cpu", "cuda")):
        return None
    host = t.detach().resolve_conj().resolve_neg().contiguous().cpu()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor, (pickle.PickleBuffer(raw),
                              str(t.dtype).removeprefix("torch."),
                              tuple(t.shape), t.requires_grad))


def _rebuild_tensor(buf, dtype: str, shape: tuple, requires_grad: bool):
    """A CPU tensor over `buf`. An out-of-band buffer is the object's
    shared-memory mapping, shared with every other reader: the tensor
    is a view of it, so code that writes into it copies it first. An
    in-band buffer is copied here."""
    import torch
    dt = getattr(torch, dtype)
    if memoryview(buf).nbytes == 0:
        out = torch.empty(shape, dtype=dt)
    else:
        with warnings.catch_warnings():
            # in-band bytes are read-only; they are copied just below
            warnings.simplefilter("ignore", UserWarning)
            out = torch.frombuffer(buf, dtype=torch.uint8)
        if isinstance(buf, bytes):
            out = out.clone()
        out = out.view(dt).reshape(shape)
    if requires_grad:
        out.requires_grad_()
    return out


class _OutOfBandBytes:
    """A `bytes` or `bytearray` value that pickles as one out-of-band
    buffer: the pickler writes `bytes` in band and never offers them to
    `reducer_override`, so `serialize` wraps a large one in this."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data

    def __reduce_ex__(self, protocol):
        return (_rebuild_bytes, (pickle.PickleBuffer(self.data),
                                 type(self.data) is bytearray))


def _rebuild_bytes(buf, mutable: bool):
    """The `bytes` (or `bytearray`) that `_OutOfBandBytes` carried, copied
    out of `buf` (a shared-memory mapping when it travelled out of band)."""
    return bytearray(buf) if mutable else bytes(buf)


class _Cycle(Exception):
    pass


_BUSY = object()


def bytes_out_of_band(value: Any, limit: int) -> Any:
    """`value` with every `bytes`/`bytearray` of at least `limit` bytes, the
    value itself or one inside (exact) dicts, lists and tuples, wrapped to
    pickle out of band (`_OutOfBandBytes`): the pickler writes `bytes` in
    band and never offers them to `reducer_override`. Containers holding
    one are copied (a shared one once); a value holding none comes back
    as it is, and so does one with a reference cycle."""
    memo: dict = {}

    def walk(v):
        t = type(v)
        if t is bytes or t is bytearray:
            return _OutOfBandBytes(v) if len(v) >= limit else v
        if t is not dict and t is not list and t is not tuple:
            return v
        got = memo.get(id(v))
        if got is _BUSY:
            raise _Cycle
        if got is not None:
            return got
        memo[id(v)] = _BUSY
        if t is dict:
            items = {k: walk(x) for k, x in v.items()}
            same = all(items[k] is x for k, x in v.items())
        else:
            items = [walk(x) for x in v]
            same = all(a is b for a, b in zip(items, v))
            items = items if t is list else tuple(items)
        memo[id(v)] = out = v if same else items
        return out

    try:
        return walk(value)
    except (_Cycle, RecursionError):
        return value
    finally:
        # `walk` holds itself through its closure: a cycle that kept the
        # memo, and every ObjectRef in `value`, alive until the cyclic GC
        # ran, so a dropped ref's object outlived it (ROADMAP queue 3,
        # item 19)
        del walk


def _pickle(value: Any) -> tuple:
    """(payload, out-of-band buffers, ids of the ObjectRefs inside)."""
    raw_buffers: list[pickle.PickleBuffer] = []
    from ray_tpu_torch._private.refs import _capture
    # Save/restore the enclosing capture list instead of resetting to
    # None: a nested serialize (user __reduce__ calling put() mid-
    # pickle) must not stop the OUTER object's later refs from
    # registering as contained — they would be deletable while still
    # referenced.
    prev_ids = getattr(_capture, "ids", None)
    _capture.ids = contained = []
    try:
        with io.BytesIO() as f:
            _Pickler(f, protocol=5,
                     buffer_callback=raw_buffers.append).dump(value)
            return f.getvalue(), raw_buffers, contained
    finally:
        _capture.ids = prev_ids


def serialize(value: Any, object_id: Optional[str] = None,
              create_shm: bool = True) -> StoredObject:
    """Pickle `value` into a StoredObject: every buffer of at least
    `inline_threshold_bytes` (an array's, a tensor's) out of band in its
    own shm segment, the rest inline.

    A `bytes` or `bytearray` of at least `inline_threshold_bytes` travels
    out of band too, as one buffer, whether it is the value itself or
    sits inside dicts, lists and tuples (`bytes_out_of_band`), and
    `deserialize` gives back an equal object of the same type."""
    object_id = object_id or new_object_id()
    limit = _CFG.inline_threshold_bytes
    payload, raw_buffers, contained = _pickle(bytes_out_of_band(value,
                                                                limit))
    inline: list[bytes] = []
    shm_names: list[str] = []
    shm_sizes: list[int] = []
    shm_alloc: list[int] = []
    order: list[str] = []
    for i, pb in enumerate(raw_buffers):
        mv = pb.raw()
        if len(mv) < _CFG.inline_threshold_bytes or not create_shm:
            inline.append(mv.tobytes())
            order.append("i")
        else:
            name = f"rtt_{_local_tag()}_{object_id}_{i}"
            shm_alloc.append(_create_segment(name, mv))
            shm_names.append(name)
            shm_sizes.append(len(mv))
            order.append("s")
    is_error = isinstance(value, BaseException)
    return StoredObject(object_id, payload, inline, shm_names, shm_sizes,
                        order, is_error, contained_ids=contained,
                        shm_alloc_sizes=shm_alloc)


def _pin_mapped_object(object_id: str, mms: list) -> None:
    """Hold a borrow on `object_id` while any of the given mmaps is
    alive. Unlink-by-name made freeing at refcount zero safe for
    already-established mappings (the pages survived); pooled reuse
    does not — the next put OVERWRITES them. So a deserialized view
    must keep the refcount above zero until it is collected: addref
    now, deferred decref when the last mmap dies (same discipline as
    ObjectRef.__del__ — never decref synchronously from a finalizer)."""
    if not SEGMENT_POOL._enabled():
        return                      # unlink-on-free: seed semantics
    from ray_tpu_torch._private import context as _context
    from ray_tpu_torch._private import refs as _refs
    ctx = _context.maybe_ctx()
    if ctx is None:
        return
    try:
        ctx.addref(object_id)
    except Exception:
        return
    tokens: "collections.deque[int]" = collections.deque(range(len(mms)))

    def _release(_tokens=tokens, _oid=object_id):
        _tokens.popleft()           # deque ops are GC-reentrancy-safe
        if not _tokens:
            _refs._deferred.append(_oid)
            _refs._flush_wake.set()
            _refs._ensure_flusher()

    for mm in mms:
        weakref.finalize(mm, _release)


def deserialize(obj: StoredObject) -> Any:
    """Reconstruct the value. shm-backed buffers become zero-copy views
    whose underlying mappings are freed when the views are collected;
    while any view lives, the object is pinned (see
    _pin_mapped_object) so the segment pool cannot reuse its pages."""
    buffers: list[Any] = []
    mms: list[Any] = []
    ii = si = 0
    for kind in obj.buffer_order:
        if kind == "i":
            buffers.append(obj.inline_buffers[ii]); ii += 1
        else:
            mv = _map_segment(obj.shm_names[si], obj.shm_sizes[si])
            buffers.append(mv)
            mms.append(mv.obj)      # the underlying mmap
            si += 1
    if mms:
        _pin_mapped_object(obj.object_id, mms)
    return pickle.loads(obj.payload, buffers=buffers)


@dataclass
class _SpilledObject:
    object_id: str
    path: str
    nbytes: int


class LocalStore:
    """Driver-resident object store: refcount-driven deletion, plus a
    capacity cap with LRU spill-to-disk of unpinned objects.

    Parity: reference plasma eviction
    (object_manager/plasma/eviction_policy.cc LRU) + raylet spilling
    (raylet/local_object_manager.cc). A `put` that pushes residency past
    `capacity_bytes` spills least-recently-used unpinned objects to
    `spill_dir` (shm segments are materialised into the spill file and
    unlinked); a later `get` restores transparently.
    """

    def __init__(self, capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 pinned_fn=None):
        import collections
        import tempfile
        if capacity_bytes is None:
            capacity_bytes = _CFG.object_store_memory or None
        self.capacity_bytes = capacity_bytes
        self._spill_dir = spill_dir or os.path.join(
            tempfile.gettempdir(), f"rtt_spill_{os.getpid()}")
        self._pinned_fn = pinned_fn or (lambda: ())
        self._objects: "collections.OrderedDict[str, StoredObject]" = (
            collections.OrderedDict())
        self._spilled: dict[str, _SpilledObject] = {}
        # last hand-out time per object: the spill policy avoids objects
        # a reader may be about to map (get_stored returns shm names the
        # caller maps OUTSIDE the lock; see _pick_victims_locked)
        self._touched_at: dict[str, float] = {}
        self._spilling: set[str] = set()        # popped, disk write in flight
        self._spill_cancelled: set[str] = set()  # deleted mid-spill
        self._restoring: set[str] = set()        # spill-file read in flight
        self._restore_cancelled: set[str] = set()  # deleted mid-restore
        # process-local pins (pull sessions serving an object): the
        # spill policy must not evict these mid-transfer. Orthogonal to
        # the distributed pin set (pinned_fn) the head computes.
        self._local_pins: "collections.Counter[str]" = (
            collections.Counter())
        self._bytes = 0
        self._spilled_bytes_total = 0
        self._restored_bytes_total = 0
        from ray_tpu_torch._private.debug_sync import make_lock
        self._lock = make_lock("object_store")
        self._cv = threading.Condition(self._lock)
        # Seal hook: called AFTER an object lands (outside the lock)
        # with its id — the runtime's waiter registry resolves blocked
        # gets/waits on it (event-driven, no parked threads).
        self.on_seal = None

    # ------------------------------------------------------------- put
    def put_stored(self, obj: StoredObject, block: bool = False) -> None:
        """Admit a sealed object. ``block=True`` applies create-queueing
        backpressure when the store is over cap and fully pinned — ONLY
        safe on producer-owned threads (driver put); connection reader
        threads must pass False (blocking them stalls the very messages
        whose processing releases pins) and instead forward the
        ``over_capacity()`` hint to the producer."""
        stale: list[str] = []
        with self._cv:
            old = self._objects.pop(obj.object_id, None)
            if old is not None:
                self._bytes -= old.nbytes
                # re-stored id (task retry): reclaim segments the new
                # object doesn't reuse, or they outlive the process
                stale = [n for n in old.shm_names
                         if n not in set(obj.shm_names)]
            self._objects[obj.object_id] = obj
            self._bytes += obj.nbytes
            self._touched_at[obj.object_id] = time.monotonic()
            victims = self._pick_victims_locked()
            self._cv.notify_all()
        for name in stale:
            # NOT free_segment: the replaced incarnation may still be
            # mapped by readers (the id is live — this is a re-put);
            # unlink keeps their pages intact, pooling would not
            unlink_segment(name)
        self._write_spills(victims)
        # Seal BEFORE any backpressure wait: consumers blocked on this
        # object must resolve (their tasks finishing is what releases
        # the pins that free space — delaying the seal would deadlock
        # the very backpressure loop).
        if self.on_seal is not None:
            self.on_seal(obj.object_id)
        if block:
            self._put_backpressure()

    def over_capacity(self) -> bool:
        """Still over cap after the spill pass — i.e. the resident
        overage is pinned. Producers use this as a throttle hint."""
        with self._lock:
            return (self.capacity_bytes is not None
                    and self._bytes > self.capacity_bytes)

    def _put_backpressure(self) -> None:
        """Create-queueing parity (reference plasma
        create_request_queue.cc): when the store is over capacity and
        nothing is spillable — every resident byte pinned by in-flight
        work — park the PRODUCER until space frees (deletes, unpins
        making spill possible) or the budget runs out, then admit
        over-cap with a loud warning instead of failing."""
        if self.capacity_bytes is None:
            return
        block_s = _CFG.store_put_block_s
        if block_s <= 0:
            return
        deadline = time.monotonic() + block_s
        warned_wait = False
        while True:
            with self._cv:
                if self._bytes <= self.capacity_bytes:
                    return
                victims = self._pick_victims_locked()
                if not victims:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        sys.stderr.write(
                            f"ray_tpu_torch: object store over capacity "
                            f"({self._bytes} > {self.capacity_bytes} "
                            f"bytes) with all bytes pinned by in-flight "
                            f"work after {block_s:.0f}s of "
                            f"backpressure; admitting over-cap\n")
                        return
                    if not warned_wait:
                        warned_wait = True
                        sys.stderr.write(
                            "ray_tpu_torch: object store full and fully "
                            "pinned; applying put backpressure\n")
                    self._cv.wait(timeout=min(left, 0.2))
                    continue
            self._write_spills(victims)     # outside the lock

    def put(self, value: Any, object_id: Optional[str] = None,
            block: bool = False) -> str:
        # block defaults False: internal callers (error seals, recovery
        # paths) run on connection reader threads where backpressure
        # would stall the very messages that release pins. Producer-
        # owned threads opt in (Runtime.put).
        obj = serialize(value, object_id)
        self.put_stored(obj, block=block)
        return obj.object_id

    # ----------------------------------------------------------- spill
    def _pick_victims_locked(self) -> list[tuple[str, StoredObject]]:
        """Pop LRU spill victims from residency (lock held) WITHOUT
        doing I/O — the caller writes them to disk after releasing the
        lock (`_write_spills`), so a slow disk never stalls the whole
        object plane. Mid-spill objects are invisible to get/wait until
        recorded; readers simply block on the condvar until then."""
        if self.capacity_bytes is None or self._bytes <= self.capacity_bytes:
            return []
        pinned = set(self._pinned_fn())
        pinned.update(oid for oid, n in self._local_pins.items() if n > 0)
        now = time.monotonic()
        victims: list[tuple[str, StoredObject]] = []

        def take(oid: str) -> None:
            obj = self._objects.pop(oid)
            self._bytes -= obj.nbytes
            self._spilling.add(oid)
            victims.append((oid, obj))

        # LRU order = OrderedDict insertion/touch order. Objects handed
        # out in the last few seconds are skipped: a reader may still be
        # mapping their shm segments outside the lock (get/deserialize
        # race) — the retry path in the runtime covers the remainder.
        deferred: list[str] = []
        for oid in list(self._objects):
            if self._bytes <= self.capacity_bytes:
                break
            if oid in pinned:
                continue
            if now - self._touched_at.get(oid, 0.0) < 5.0:
                deferred.append(oid)
                continue
            take(oid)
        # still over: last resort, take recently-touched (but not
        # pinned) victims rather than blow past the cap unboundedly
        for oid in deferred:
            if self._bytes <= self.capacity_bytes:
                break
            take(oid)
        return victims

    def _write_spills(self, victims: list[tuple[str, StoredObject]]) -> None:
        """Disk I/O phase of spilling (NO store lock held)."""
        if not victims:
            return
        os.makedirs(self._spill_dir, exist_ok=True)
        for oid, obj in victims:
            path = os.path.join(self._spill_dir, oid)
            buffers = []
            ii = si = 0
            for kind in obj.buffer_order:
                if kind == "i":
                    buffers.append(obj.inline_buffers[ii]); ii += 1
                else:
                    mv = _map_segment(obj.shm_names[si], obj.shm_sizes[si])
                    buffers.append(mv.tobytes())
                    del mv
                    si += 1
            with open(path, "wb") as f:
                pickle.dump({"payload": obj.payload, "buffers": buffers,
                             "is_error": obj.is_error,
                             "contained": obj.contained_ids}, f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            for name in obj.shm_names:
                # NOT free_segment: spill victims usually have live
                # refs, so readers may hold mapped views of these
                # segments; unlink preserves their pages, pooled reuse
                # would overwrite them
                unlink_segment(name)
            with self._cv:
                self._spilling.discard(oid)
                if oid in self._spill_cancelled:
                    # deleted while we were writing: drop everything
                    self._spill_cancelled.discard(oid)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                else:
                    self._spilled[oid] = _SpilledObject(oid, path,
                                                        obj.nbytes)
                    self._spilled_bytes_total += obj.nbytes
                self._cv.notify_all()

    def _restore(self, oid: str,
                 timeout: Optional[float] = None) -> Optional[StoredObject]:
        """Two-phase restore mirroring the spill write: claim the
        spill record under the lock, READ THE FILE OUTSIDE IT (a large
        restore must not stall the whole object plane), re-admit under
        the lock. Concurrent getters of the same oid wait on the
        condvar via the _restoring marker. `timeout` bounds how long a
        losing racer waits for the winner's re-admission (0 = don't
        block: the non-blocking-probe contract of get_stored)."""
        with self._cv:
            rec = self._spilled.pop(oid, None)
            if rec is None:
                # Someone else claimed the spill record. If their disk
                # read is still in flight the object is in neither map
                # yet — wait for re-admission instead of reporting a
                # spurious miss to the loser of the race.
                if oid in self._restoring and timeout != 0:
                    self._cv.wait_for(
                        lambda: oid in self._objects
                        or oid not in self._restoring,
                        timeout=timeout)
                return self._objects.get(oid)
            self._restoring.add(oid)
        try:
            with open(rec.path, "rb") as f:
                blob = pickle.load(f)
            os.unlink(rec.path)
        except BaseException:
            with self._cv:
                self._restoring.discard(oid)
                self._spilled[oid] = rec        # put the claim back
                self._cv.notify_all()
            raise
        # Rebuild: buffers go back inline (they re-spill if pressure
        # persists; re-carving shm here would thrash under scans).
        obj = StoredObject(oid, blob["payload"],
                           inline_buffers=list(blob["buffers"]),
                           buffer_order=["i"] * len(blob["buffers"]),
                           is_error=blob["is_error"],
                           contained_ids=list(blob.get("contained", ())))
        with self._cv:
            self._restoring.discard(oid)
            if oid in self._restore_cancelled:   # deleted mid-restore
                self._restore_cancelled.discard(oid)
                self._cv.notify_all()
                return None
            self._objects[oid] = obj
            self._bytes += obj.nbytes
            self._restored_bytes_total += obj.nbytes
            victims = self._pick_victims_locked()
            self._cv.notify_all()
        self._write_spills(victims)
        # Re-admission is a seal: wake registry waiters that parked in
        # the gap before this restore claimed the spill record.
        if self.on_seal is not None:
            self.on_seal(oid)
        return obj

    # ------------------------------------------------- local pinning
    def pin_local(self, object_id: str) -> None:
        """Keep `object_id` resident (not spillable) while a transfer
        serves it — pull sessions hold one for their lifetime so an
        LRU pass can't unlink segments mid-pull."""
        with self._lock:
            self._local_pins[object_id] += 1

    def unpin_local(self, object_id: str) -> None:
        with self._cv:
            n = self._local_pins[object_id] - 1
            if n > 0:
                self._local_pins[object_id] = n
            else:
                self._local_pins.pop(object_id, None)
            self._cv.notify_all()       # backpressure may be waiting

    # ------------------------------------------------------------- get
    def held_objects(self) -> list[tuple[str, int]]:
        """(object_id, nbytes) for every resident or spilled object —
        reported to the head on rejoin so the rehydrated object
        directory learns this node's copies."""
        with self._lock:
            out = [(oid, o.nbytes) for oid, o in self._objects.items()]
            out.extend((oid, s.nbytes) for oid, s in self._spilled.items()
                       if oid not in self._objects)
            return out

    def contains(self, object_id: str) -> bool:
        with self._lock:
            return (object_id in self._objects
                    or object_id in self._spilled
                    or object_id in self._spilling
                    or object_id in self._restoring)

    def get_stored(self, object_id: str,
                   timeout: Optional[float] = None,
                   restore: bool = True) -> Optional[StoredObject]:
        """restore=False is a residency-only probe: spilled objects
        report a miss instead of triggering a synchronous disk read —
        event-driven callers route restores to a worker pool."""
        with self._cv:
            def present():
                return (object_id in self._objects
                        or object_id in self._spilled)
            if timeout != 0:
                self._cv.wait_for(present, timeout=timeout)
            # timeout == 0 is a NON-BLOCKING probe: a mid-flight
            # spill/restore simply reports miss; the caller's blocking
            # path (waiter thread) picks it up once the record lands.
            obj = self._objects.get(object_id)
            if obj is not None:
                self._objects.move_to_end(object_id)   # LRU touch
                self._touched_at[object_id] = time.monotonic()
                return obj
            if object_id not in self._spilled:
                if object_id in self._restoring and timeout != 0:
                    # another thread is reading the spill file: wait for
                    # its re-admission instead of returning a miss
                    self._cv.wait_for(
                        lambda: object_id in self._objects,
                        timeout=timeout)
                    obj = self._objects.get(object_id)
                    if obj is not None:
                        self._touched_at[object_id] = time.monotonic()
                    return obj
                return None
            if not restore:
                return None
        obj = self._restore(object_id, timeout=timeout)
        if obj is not None:
            with self._lock:
                self._touched_at[object_id] = time.monotonic()
        return obj

    def wait_any(self, object_ids: list[str], num_returns: int,
                 timeout: Optional[float]) -> list[str]:
        """Block until >= num_returns of object_ids are local; return ready ids."""
        with self._cv:
            def ready():
                return [o for o in object_ids
                        if o in self._objects or o in self._spilled
                        or o in self._spilling or o in self._restoring]
            self._cv.wait_for(lambda: len(ready()) >= num_returns,
                              timeout=timeout)
            return ready()

    def delete(self, object_id: str) -> None:
        with self._lock:
            obj = self._objects.pop(object_id, None)
            if obj is not None:
                self._bytes -= obj.nbytes
            rec = self._spilled.pop(object_id, None)
            self._touched_at.pop(object_id, None)
            if object_id in self._spilling:
                # mid-flight spill: the writer drops the file + segments
                # when it finishes (see _write_spills)
                self._spill_cancelled.add(object_id)
            if object_id in self._restoring:
                self._restore_cancelled.add(object_id)
        if obj is not None:
            for name in obj.shm_names:
                free_segment(name)
        if rec is not None:
            try:
                os.unlink(rec.path)
            except OSError:
                pass

    def stats(self) -> dict:
        with self._lock:
            out = {
                "num_objects": len(self._objects) + len(self._spilled),
                "bytes": self._bytes,
                "num_spilled": len(self._spilled),
                "spilled_bytes": sum(r.nbytes
                                     for r in self._spilled.values()),
                "spilled_bytes_total": self._spilled_bytes_total,
                "restored_bytes_total": self._restored_bytes_total,
                "capacity_bytes": self.capacity_bytes,
            }
        out.update(SEGMENT_POOL.stats())
        return out

    def shutdown(self) -> None:
        with self._lock:
            ids = list(self._objects) + list(self._spilled)
        for oid in ids:
            self.delete(oid)
        # deletes above may have fed the pool; the session is over, so
        # reap it (the tag-prefixed sweep would catch stragglers too)
        SEGMENT_POOL.clear()
        try:
            os.rmdir(self._spill_dir)
        except OSError:
            pass
