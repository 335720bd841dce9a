"""Cross-host object transfer: chunked pull protocol.

The reference moves objects node-to-node with a chunked push/pull plane
(reference src/ray/object_manager/object_manager.cc, pull_manager.cc,
object_buffer_pool.cc chunking). Here the equivalent is a pull-only
protocol riding the framed-message channel:

    PULL_OBJECT {object_id[, manifest]} -> {found, pull_id, nchunks,
                                            size[, manifest]}
    PULL_CHUNK  {pull_id, index}        -> {data|raw}       (x nchunks)

Two serve/land paths coexist on the wire (negotiated per transfer by
the REPLY SHAPE — the puller asks for a manifest; a holder that
predates wire MINOR 5, or has ``RAY_TPU_PULL_MANIFEST=0``, ignores the
unknown request key and answers with the blob protocol):

**Manifest path (r12, the default).** The PULL reply describes the
object instead of copying it: payload length + per-buffer kinds/sizes.
The logical transfer stream is ``payload · buffer0 · buffer1 ...``
split at fixed CHUNK_BYTES boundaries, and chunk bodies ride the
Envelope ``raw`` field — emitted scatter-gather straight from the
holder's mapped shm (zero serve-side copies; one mapping serves every
concurrent session) and landed by the puller straight into
pre-created pooled shm segments at each chunk's offset via the native
GIL-released memcpy (one land-side copy, the unavoidable wire->memory
one; no bytearray reassembly, no ``_decode`` re-pickle, no second
copy into the store). With ``RAY_TPU_PULL_CUT_THROUGH`` (default on)
a puller also serves its ALREADY-LANDED chunk ranges to its own
children while the pull is still in flight — the broadcast tree's
cut-through relay: chunk requests for not-yet-landed ranges park on
the landing (event-driven, never blocking the shared read loop) and
answer the moment the range lands, so tree depth costs per-chunk, not
per-object, latency.

**Blob path (pre-MINOR-5 interop).** ``materialize()`` + pickle of the
whole StoredObject served in slices — byte-identical to the r8
protocol, kept so old peers interoperate in both directions.

Serving side (PullServer):
- a pull session PINS its object in the local store for its lifetime
  (`pin_local`), so the LRU spill pass cannot unlink segments
  mid-transfer; manifest sessions additionally hold their segment
  names in ``guard_segments`` so a concurrent refcount-zero delete
  unlinks (mapping-safe) instead of pooling pages out from under the
  mapped views; if the object was ALREADY spilled (or spills in the
  probe->encode window), the serve path restores from the spill file
  and retries instead of failing the segment map;
- sessions expire after `pull_session_ttl_s`: the sweep runs lazily on
  every pull/chunk message AND on the puller's connection close, so
  pullers that die mid-pull cannot leak blobs, mappings or pins;
- concurrent pulls of one object share a single source — one encoded
  blob (blob path) or one set of shm mappings (manifest path): N
  children of one tree node cost one encode/mapping.

Client side (``pull_object``): a dropped/expired chunk re-opens the
session with the holder and resumes from the failed index, up to
`pull_chunk_retries` times; a chunk-wait on a PARTIAL holder that
exceeds ``pull_partial_chunk_timeout_s`` counts as a drop, so a
stalled relay degrades to the existing retry / re-root-on-source
machinery instead of burning the transfer deadline. Transfer/serve/
retry/copy counters accumulate in ``OBJECT_PLANE_STATS`` (surfaced via
the ``object_plane_stats`` state op, node heartbeats, and the metrics
plane).
"""
from __future__ import annotations

import bisect
import pickle
import threading
import time
import uuid
import weakref
from dataclasses import dataclass
from typing import Callable, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.config import CONFIG as _CFG
from ray_tpu_torch._private.object_store import (StoredObject, _local_tag,
                                           _map_segment,
                                           _open_segment_for_write,
                                           bulk_copy, guard_segments,
                                           unlink_segment)
from ray_tpu_torch._private.wire import RAW_KEY

CHUNK_BYTES = 4 * 1024 * 1024

# Process-wide object-plane counters (this process's transfers only):
# plain int increments under the GIL, same discipline as
# protocol.WIRE_STATS. Agents carry a copy on heartbeats; the head
# aggregates per node in the object_plane_stats state op.
OBJECT_PLANE_STATS = {
    "pulls_started": 0,       # transfers this process initiated
    "pulls_completed": 0,
    "pulls_failed": 0,
    "pull_bytes": 0,
    "pull_dedup_hits": 0,     # pulls that joined an in-flight transfer
    "pull_suspect_deferred": 0,  # holders deferred to the rotation
                              #   tail because their node is SUSPECT
                              #   (r17 gray-failure deprioritization)
    "chunk_retries": 0,       # chunk-level session re-opens
    "serves_started": 0,      # pull sessions opened by remote pullers
    "serves_completed": 0,
    "serve_bytes": 0,
    "bcast_plans": 0,         # BCAST_PLAN messages acted on (agents)
    # ---- r12 zero-copy envelope ----
    "manifest_pulls": 0,      # transfers that ran the manifest protocol
    "blob_pulls": 0,          # transfers on the pre-MINOR-5 blob path
    "serve_bytes_copied": 0,  # user-space serve-side copies (blob only)
    "land_bytes_copied": 0,   # user-space land-side copies: manifest =
                              #   the single wire->shm memcpy; blob =
                              #   the reassembly join (a LOWER bound —
                              #   the _decode re-pickle copies again)
    "partial_serves": 0,      # chunk ranges served from an in-flight
                              #   landing (cut-through relay)
    "partial_waits": 0,       # chunk requests parked on a landing
}


def materialize(obj: StoredObject) -> StoredObject:
    """Copy of `obj` with every shm-backed buffer pulled inline — the
    blob path's transportable form (the manifest path never calls
    this; it serves straight from the mapping)."""
    if not obj.shm_names:
        return obj
    inline: list[bytes] = []
    ii = si = 0
    order: list[str] = []
    # guard: a concurrent refcount-zero free in this process must
    # unlink (mapping-safe), not pool-and-reuse, while we copy
    with guard_segments(obj.shm_names):
        for kind in obj.buffer_order:
            if kind == "i":
                inline.append(obj.inline_buffers[ii]); ii += 1
            else:
                mv = _map_segment(obj.shm_names[si], obj.shm_sizes[si])
                inline.append(mv.tobytes())
                OBJECT_PLANE_STATS["serve_bytes_copied"] += len(mv)
                del mv
                si += 1
            order.append("i")
    return StoredObject(obj.object_id, obj.payload, inline, [], [],
                        order, obj.is_error,
                        contained_ids=list(obj.contained_ids))


def _encode(obj: StoredObject) -> bytes:
    blob = pickle.dumps(materialize(obj),
                        protocol=pickle.HIGHEST_PROTOCOL)
    OBJECT_PLANE_STATS["serve_bytes_copied"] += len(blob)
    return blob


def _decode(data: bytes) -> StoredObject:
    return pickle.loads(data)


class PullBudgetExceeded(Exception):
    """The in-flight byte budget could not admit this transfer before
    the deadline — NOT a source failure (the holder is fine), so pull
    managers must not drop the location over it."""


# ====================================================================
# manifest chunk sources
# ====================================================================

def _nchunks(total: int) -> int:
    return max(1, (total + CHUNK_BYTES - 1) // CHUNK_BYTES)


class _SpanSet:
    """The manifest transfer stream — ``payload · buffer0 · ...`` — as
    gatherable buffer views with cumulative offsets."""

    def __init__(self, buffers):
        self.views = [memoryview(b) for b in buffers]
        self.offsets: list[int] = []
        off = 0
        for v in self.views:
            self.offsets.append(off)
            off += len(v)
        self.total = off

    def gather(self, start: int, end: int) -> list:
        """Zero-copy views covering stream range [start, end)."""
        out = []
        i = bisect.bisect_right(self.offsets, start) - 1
        pos = start
        while pos < end:
            off, v = self.offsets[i], self.views[i]
            a = pos - off
            b = min(len(v), end - off)
            out.append(v[a:b])
            pos = off + b
            i += 1
        return out

    def chunk_range(self, index: int) -> tuple[int, int]:
        start = index * CHUNK_BYTES
        return start, min(start + CHUNK_BYTES, self.total)


class _ChunkSource:
    """Serve-side descriptor of a COMPLETE object: the manifest plus
    mapped views of every span, shared by all concurrent sessions (one
    mapping serves N tree children). Refcounted; while alive it holds
    a store pin (spill protection) and guards its shm names (a
    refcount-zero delete unlinks instead of pooling, so the mapped
    pages survive under in-flight serves)."""

    partial = False

    def __init__(self, stored: StoredObject, store=None):
        self.object_id = stored.object_id
        self.kinds = list(stored.buffer_order)
        self.sizes: list[int] = []
        self.is_error = stored.is_error
        self.contained = list(stored.contained_ids)
        self._store = store
        self._shm_names = list(stored.shm_names)
        self._guard = guard_segments(self._shm_names)
        self._guard.__enter__()
        try:
            bufs = [stored.payload]
            ii = si = 0
            for kind in stored.buffer_order:
                if kind == "i":
                    b = stored.inline_buffers[ii]; ii += 1
                else:
                    b = _map_segment(stored.shm_names[si],
                                     stored.shm_sizes[si])
                    si += 1
                self.sizes.append(len(b))
                bufs.append(b)
            self.spans = _SpanSet(bufs)
        except BaseException:
            self._guard.__exit__(None, None, None)
            raise
        self.payload_len = len(stored.payload)
        self.total = self.spans.total
        self.nchunks = _nchunks(self.total)
        self._refs = 1
        self._lock = threading.Lock()
        self._pinned = False
        if store is not None:
            pin = getattr(store, "pin_local", None)
            if pin is not None:
                pin(self.object_id)
                self._pinned = True

    def manifest(self) -> dict:
        return {"payload": self.payload_len, "kinds": "".join(self.kinds),
                "sizes": list(self.sizes), "is_error": self.is_error,
                "contained": list(self.contained),
                "partial": self.partial}

    def ready(self, index: int) -> bool:
        return True

    def gather(self, index: int) -> list:
        return self.spans.gather(*self.spans.chunk_range(index))

    # ------------------------------------------------------ lifetime
    def acquire(self) -> bool:
        with self._lock:
            if self._refs <= 0:
                return False         # already torn down: don't revive
            self._refs += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            if self._refs > 0:
                return
        self._close()

    def _close(self) -> None:
        self._guard.__exit__(None, None, None)
        if self._pinned:
            unpin = getattr(self._store, "unpin_local", None)
            if unpin is not None:
                try:
                    unpin(self.object_id)
                except Exception:
                    pass
            self._pinned = False


class Landing:
    """Land-side state of one in-flight manifest transfer: pre-created
    pooled shm segments + inline bytearrays that chunk bodies memcpy
    into at their stream offsets, a landed bitmap, and parked chunk
    waiters (the cut-through children). Doubles as the chunk source
    for sessions serving FROM the landing: a chunk range is servable
    the moment it lands, while the node's own pull is still running.

    Waiter callbacks fire on the landing thread (the puller's transfer
    thread) — never on the shared read loop. A child's send can block
    up to the socket send budget; that throttles this node's relay,
    not any reader."""

    def __init__(self, store, object_id: str, manifest: dict,
                 size: int):
        self.object_id = object_id
        self.payload_len = int(manifest["payload"])
        self.kinds = list(manifest["kinds"])
        self.sizes = [int(s) for s in manifest["sizes"]]
        self.is_error = bool(manifest.get("is_error"))
        self.contained = list(manifest.get("contained") or ())
        self._store = store
        tag = uuid.uuid4().hex[:6]
        self.shm_names: list[str] = []
        self.shm_sizes: list[int] = []
        self.shm_alloc: list[int] = []
        self._mms: list = []
        self._inline: list[bytearray] = []
        bufs: list = []
        payload = bytearray(self.payload_len)
        bufs.append(payload)
        self._payload = payload
        try:
            for i, kind in enumerate(self.kinds):
                n = self.sizes[i]
                if kind == "s":
                    # unique name: same-host peers share /dev/shm, so
                    # the producer's rtt_<tag>_<oid>_<i> names (and
                    # other pullers' landings) must never collide;
                    # still session-tag-prefixed for the shutdown sweep
                    name = (f"rtt_{_local_tag()}_{object_id}"
                            f"_l{tag}_{i}")
                    mm, alloc = _open_segment_for_write(name, n)
                    self.shm_names.append(name)
                    self.shm_sizes.append(n)
                    self.shm_alloc.append(alloc)
                    self._mms.append(mm)
                    bufs.append(memoryview(mm))
                else:
                    ba = bytearray(n)
                    self._inline.append(ba)
                    bufs.append(ba)
        except BaseException:
            self._destroy_segments()
            raise
        self.spans = _SpanSet(bufs)
        self.total = self.spans.total
        if self.total != size:
            self._destroy_segments()
            raise ValueError(f"manifest total {self.total} != "
                             f"advertised size {size}")
        self.nchunks = _nchunks(self.total)
        self._landed = [False] * self.nchunks
        self.n_landed = 0
        self.failed = False
        self.done = False
        self._lock = threading.Lock()
        # index -> [(callback, deadline)]: parked cut-through serves
        self._waiters: dict[int, list] = {}
        self._refs = 1                       # owner (the pull) holds one
        self._guard = guard_segments(self.shm_names)
        self._guard.__enter__()

    partial = True

    def manifest(self) -> dict:
        return {"payload": self.payload_len, "kinds": "".join(self.kinds),
                "sizes": list(self.sizes), "is_error": self.is_error,
                "contained": list(self.contained), "partial": True}

    def matches(self, manifest: dict, size: int) -> bool:
        """Same incarnation? (retry re-opens must resume the same
        deterministic chunk grid)"""
        return (size == self.total
                and int(manifest["payload"]) == self.payload_len
                and [int(s) for s in manifest["sizes"]] == self.sizes)

    # ------------------------------------------------------- landing
    def write_chunk(self, index: int, raw) -> bool:
        """Land one chunk body at its stream offset. Returns True when
        the chunk was new (False: duplicate from a retry). Fires any
        parked waiters for the range outside the lock."""
        start, end = self.spans.chunk_range(index)
        view = memoryview(raw)
        if len(view) != end - start:
            raise ValueError(
                f"chunk {index}: got {len(view)} bytes, "
                f"want {end - start}")
        with self._lock:
            if self.failed or self._landed[index]:
                return False
        consumed = 0
        for dst in self.spans.gather(start, end):
            n = len(dst)
            bulk_copy(dst, 0, view[consumed:consumed + n])
            consumed += n
        OBJECT_PLANE_STATS["land_bytes_copied"] += end - start
        with self._lock:
            if self._landed[index]:
                return False
            self._landed[index] = True
            self.n_landed += 1
            waiters = self._waiters.pop(index, ())
        for cb, _deadline in waiters:
            try:
                cb(True)
            except Exception:
                pass
        return True

    def ready(self, index: int) -> bool:
        with self._lock:
            return self._landed[index] and not self.failed

    def gather(self, index: int) -> list:
        return self.spans.gather(*self.spans.chunk_range(index))

    def add_waiter(self, index: int, cb: Callable[[bool], None]) -> bool:
        """Park a cut-through chunk serve until the range lands; the
        callback fires with True (landed) or False (landing failed).
        Returns False when the landing can no longer answer (failed,
        or the index is out of range) — the caller replies dropped."""
        with self._lock:
            if self.failed or index >= self.nchunks:
                return False
            if self._landed[index]:
                pass                         # fire immediately below
            else:
                OBJECT_PLANE_STATS["partial_waits"] += 1
                self._waiters.setdefault(index, []).append(
                    (cb, time.monotonic()))
                return True
        try:
            cb(True)
        except Exception:
            pass
        return True

    def complete(self) -> StoredObject:
        """All chunks landed: build the StoredObject backed by the
        landed segments (no copies — payload/inline stay the landed
        bytearrays, pickle handles them like bytes)."""
        with self._lock:
            assert self.n_landed == self.nchunks
            self.done = True
        return StoredObject(
            self.object_id, self._payload, list(self._inline),
            list(self.shm_names), list(self.shm_sizes),
            list(self.kinds), self.is_error,
            contained_ids=list(self.contained),
            shm_alloc_sizes=list(self.shm_alloc))

    def fail(self) -> None:
        """The pull died: answer every parked waiter with failure so
        children fall back to their retry / re-root machinery."""
        with self._lock:
            if self.failed:
                return
            self.failed = True
            waiters, self._waiters = self._waiters, {}
        for lst in waiters.values():
            for cb, _deadline in lst:
                try:
                    cb(False)
                except Exception:
                    pass

    # ------------------------------------------------------ lifetime
    def acquire(self) -> bool:
        with self._lock:
            if self._refs <= 0:
                return False         # already torn down: don't revive
            self._refs += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            if self._refs > 0:
                return
        self._guard.__exit__(None, None, None)
        for mm in self._mms:
            try:
                mm.close()
            except (BufferError, ValueError):
                pass                 # exported views still alive: GC
        self._mms = []
        if not self.done:
            self._destroy_segments()

    def _destroy_segments(self) -> None:
        for name in self.shm_names:
            unlink_segment(name)


class _LandingTable:
    """Per-store registry of in-flight landings — the hand-off point
    between the land path (pull_object) and the serve path
    (PullServer cut-through)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._landings: dict[str, Landing] = {}

    def put(self, oid: str, landing: Landing) -> None:
        with self._lock:
            self._landings[oid] = landing

    def get(self, oid: str) -> Optional[Landing]:
        with self._lock:
            return self._landings.get(oid)

    def remove(self, oid: str, landing: Landing) -> None:
        with self._lock:
            if self._landings.get(oid) is landing:
                self._landings.pop(oid, None)


def landing_table(store) -> _LandingTable:
    """The store's landing table (lazily attached: PullServer and the
    pull managers share whatever store instance they were built on)."""
    table = getattr(store, "_rtpu_landings", None)
    if table is None:
        table = store._rtpu_landings = _LandingTable()
    return table


@dataclass
class _PullSession:
    object_id: str
    touched: float
    blob: Optional[bytes] = None         # blob protocol
    source: Optional[object] = None      # manifest: _ChunkSource/Landing
    conn_id: Optional[int] = None        # id(conn) of the puller
    pinned: bool = False


class PullServer:
    """Serves PULL_OBJECT / PULL_CHUNK against a LocalStore. Mixed into
    any endpoint that holds objects (head runtime, node agent).

    `executor` (when given) takes the slow path — spill restore from
    disk + blob encode / manifest mapping — off the connection reader
    thread, so a multi-GB restore can never stall heartbeat processing
    on a shared control connection. Cut-through serves from an
    in-flight landing stay inline (no disk IO; not-yet-landed chunks
    park event-driven instead of blocking)."""

    # bounded per-object serve-count table (object_plane_stats surface;
    # the broadcast tests assert per-node serve counts from it)
    _SERVES_PER_OBJECT_CAP = 128

    def __init__(self, store, executor=None):
        self._store = store
        self._executor = executor
        self._sessions: dict[str, _PullSession] = {}
        self._slock = threading.Lock()
        self._last_sweep = time.monotonic()
        # oid -> (weakref to the StoredObject encoded, payload, created):
        # while the store still holds that exact instance, concurrent
        # sessions share one encode/mapping (a re-put/restore swaps the
        # instance, so a stale source can never be served)
        self._blob_cache: dict[str, tuple] = {}
        self._manifest_cache: dict[str, tuple] = {}
        self._serves_per_object: dict[str, int] = {}

    # ----------------------------------------------------- sessions
    def _drop_session_locked(self, pull_id: str) -> None:
        sess = self._sessions.pop(pull_id, None)
        if sess is None:
            return
        if sess.pinned:
            self._unpin(sess.object_id)
        if sess.source is not None:
            sess.source.release()
        # last session of this object gone: release the shared source —
        # the caches exist to amortize CONCURRENT sessions (tree
        # children), not to hold multi-GB bytes/mappings on an idle node
        if not any(s.object_id == sess.object_id
                   for s in self._sessions.values()):
            self._blob_cache.pop(sess.object_id, None)
            ent = self._manifest_cache.pop(sess.object_id, None)
            if ent is not None:
                ent[1].release()

    def _unpin(self, oid: str) -> None:
        unpin = getattr(self._store, "unpin_local", None)
        if unpin is not None:
            try:
                unpin(oid)
            except Exception:
                pass

    def sweep(self, force: bool = False) -> int:
        """Lazy TTL sweep: reap sessions idle past pull_session_ttl_s.
        Runs (throttled) on every pull/chunk message so expiry does not
        depend on further traffic for the SAME session — pullers that
        die mid-pull cannot leak materialized blobs/mappings/pins."""
        now = time.monotonic()
        if not force and now - self._last_sweep < 1.0:
            return 0
        ttl = _CFG.pull_session_ttl_s
        with self._slock:
            self._last_sweep = now
            dead = [k for k, s in self._sessions.items()
                    if now - s.touched > ttl]
            for k in dead:
                self._drop_session_locked(k)
            # cache entries whose StoredObject died (deleted / re-put)
            # or that went idle are dropped with the sessions
            for oid in list(self._blob_cache):
                ref, _, created = self._blob_cache[oid]
                if ref() is None or now - created > ttl:
                    self._blob_cache.pop(oid, None)
            for oid in list(self._manifest_cache):
                ref, src, created = self._manifest_cache[oid]
                if ref() is None or now - created > ttl:
                    self._manifest_cache.pop(oid, None)
                    src.release()
        return len(dead)

    def on_conn_closed(self, conn) -> None:
        """Reap every session the closing connection's puller opened —
        the other half of dead-puller cleanup (the lazy sweep covers
        holders that never hear from anyone again)."""
        cid = id(conn)
        with self._slock:
            for k in [k for k, s in self._sessions.items()
                      if s.conn_id == cid]:
                self._drop_session_locked(k)

    def session_count(self) -> int:
        with self._slock:
            return len(self._sessions)

    def serves_per_object(self) -> dict[str, int]:
        with self._slock:
            return dict(self._serves_per_object)

    # ------------------------------------------------------- serving
    def handle_pull(self, conn: protocol.Connection, msg: dict) -> None:
        """Runs on the connection reader thread: answer only the cheap
        cases inline (not-found; cut-through landing serves — pure
        bookkeeping); ALL store serving (the mapping/_encode of a
        possibly multi-GB object, and any spill restore) goes to the
        executor so the reader thread never stalls heartbeats/control
        traffic."""
        self.sweep()
        oid = msg["object_id"]
        stored = self._store.get_stored(oid, timeout=0, restore=False)
        if stored is None and not self._store.contains(oid):
            # cut-through: a landing in flight serves its landed
            # ranges to manifest-speaking children
            if (msg.get("manifest") and _CFG.pull_manifest
                    and _CFG.pull_cut_through):
                landing = landing_table(self._store).get(oid)
                if landing is not None and not landing.failed:
                    self._open_session(conn, msg, landing,
                                       acquire=True)
                    return
            stored = self._store.get_stored(oid, timeout=0)
            if stored is None:
                conn.reply(msg, found=False)
                return
        if self._executor is not None:
            self._executor.submit(self._pull_slow, conn, msg, oid)
        elif stored is not None:
            self._serve(conn, msg, stored)
        else:
            self._pull_slow(conn, msg, oid)

    def _pull_slow(self, conn: protocol.Connection, msg: dict,
                   oid: str) -> None:
        try:
            stored = self._store.get_stored(oid, timeout=10)
            if stored is None:
                conn.reply(msg, found=False)
            else:
                self._serve(conn, msg, stored)
        except protocol.ConnectionClosed:
            pass

    def _encode_shared(self, stored) -> bytes:
        """Encode `stored`, sharing the blob across concurrent sessions
        of the same object while the store holds that exact instance
        (tree broadcast: fanout children of one node pay one encode)."""
        oid = stored.object_id
        with self._slock:
            ent = self._blob_cache.get(oid)
            if ent is not None and ent[0]() is stored:
                return ent[1]
        blob = _encode(stored)
        with self._slock:
            if len(self._blob_cache) >= 4:       # bounded: oldest out
                oldest = min(self._blob_cache,
                             key=lambda k: self._blob_cache[k][2])
                self._blob_cache.pop(oldest, None)
            self._blob_cache[oid] = (weakref.ref(stored), blob,
                                     time.monotonic())
        return blob

    def _source_shared(self, stored) -> _ChunkSource:
        """Map `stored` into a chunk source, shared across concurrent
        sessions while the store holds that exact instance — one set
        of mappings serves every tree child."""
        oid = stored.object_id
        with self._slock:
            ent = self._manifest_cache.get(oid)
            if ent is not None and ent[0]() is stored:
                ent[1].acquire()
                return ent[1]
        src = _ChunkSource(stored, store=self._store)
        src.acquire()                            # the session's ref
        with self._slock:
            old = self._manifest_cache.pop(oid, None)
            if len(self._manifest_cache) >= 4:   # bounded: oldest out
                oldest = min(self._manifest_cache,
                             key=lambda k: self._manifest_cache[k][2])
                self._manifest_cache.pop(oldest)[1].release()
            self._manifest_cache[oid] = (weakref.ref(stored), src,
                                         time.monotonic())
        if old is not None:
            old[1].release()
        return src

    def _serve(self, conn: protocol.Connection, msg: dict,
               stored) -> None:
        oid = stored.object_id
        manifest_mode = bool(msg.get("manifest")) and _CFG.pull_manifest
        # Pin for the life of the session: the spill pass must not
        # unlink this object's segments (or evict the restored copy)
        # while chunks are still being read.
        pin = getattr(self._store, "pin_local", None)
        pinned = False
        if pin is not None:
            pin(oid)
            pinned = True
        blob = source = None
        try:
            for _attempt in range(3):
                try:
                    if manifest_mode:
                        source = self._source_shared(stored)
                    else:
                        blob = self._encode_shared(stored)
                    break
                except FileNotFoundError:
                    # segments unlinked in the probe->map window (LRU
                    # spill raced us, before the pin landed): re-fetch —
                    # the store restores from the spill file, coming
                    # back with inline buffers
                    stored = self._store.get_stored(oid, timeout=10)
                    if stored is None:
                        break
        except BaseException:
            if pinned:
                self._unpin(oid)
            raise
        if blob is None and source is None:
            if pinned:
                self._unpin(oid)
            conn.reply(msg, found=False)
            return
        self._open_session(conn, msg, source, blob=blob, pinned=pinned)

    def _open_session(self, conn: protocol.Connection, msg: dict,
                      source, blob: Optional[bytes] = None,
                      pinned: bool = False,
                      acquire: bool = False) -> None:
        """Register a session for `source` (a chunk source / landing;
        None for blob sessions) and answer the PULL_OBJECT request.
        `acquire` takes the session's ref on the source here (the
        cut-through inline path; _source_shared pre-acquires)."""
        oid = msg["object_id"]
        # tracing plane: the serve span (pin + mapping/encode + session
        # open) parents under the puller's envelope-carried pull span,
        # putting the holder side of every transfer on the timeline
        tr = msg.get(_tp.TRACE_KEY)
        t_tr = _tp.recv_t0(msg)
        if acquire and source is not None:
            if not source.acquire():
                # lost the race with the landing's teardown: the
                # object is either sealed (next open serves the store
                # copy) or gone (puller rotates sources)
                conn.reply(msg, found=False)
                return
        if source is not None:
            size, nchunks = source.total, source.nchunks
        else:
            size, nchunks = len(blob), _nchunks(len(blob))
        pull_id = uuid.uuid4().hex[:12]
        sess = _PullSession(object_id=oid, touched=time.monotonic(),
                            blob=blob, source=source, conn_id=id(conn),
                            pinned=pinned)
        with self._slock:
            self._sessions[pull_id] = sess
            self._serves_per_object[oid] = (
                self._serves_per_object.get(oid, 0) + 1)
            while len(self._serves_per_object) > self._SERVES_PER_OBJECT_CAP:
                self._serves_per_object.pop(
                    next(iter(self._serves_per_object)))
        OBJECT_PLANE_STATS["serves_started"] += 1
        if getattr(source, "partial", False):
            OBJECT_PLANE_STATS["partial_serves"] += 1
        if t_tr is not None:
            _tp.record("serve", "serve:" + oid[:16], t_tr, _tp.now(),
                       tr[0], _tp.new_id(), tr[1],
                       {"nbytes": size})
        reply = {"found": True, "pull_id": pull_id, "nchunks": nchunks,
                 "size": size}
        if source is not None:
            reply["manifest"] = source.manifest()
        try:
            conn.reply(msg, **reply)
        except protocol.ConnectionClosed:
            with self._slock:
                self._drop_session_locked(pull_id)
            raise

    def handle_chunk(self, conn: protocol.Connection, msg: dict) -> None:
        self.sweep()
        pull_id, index = msg["pull_id"], msg["index"]
        with self._slock:
            sess = self._sessions.get(pull_id)
            if sess is not None:
                sess.touched = time.monotonic()
        if sess is None:
            conn.reply(msg, data=None)
            return
        if sess.source is not None:
            self._chunk_from_source(conn, msg, pull_id, sess, index)
            return
        blob = sess.blob
        start = index * CHUNK_BYTES
        data = blob[start:start + CHUNK_BYTES]
        OBJECT_PLANE_STATS["serve_bytes_copied"] += len(data)
        last = start + CHUNK_BYTES >= len(blob)
        if last:
            with self._slock:
                self._drop_session_locked(pull_id)
            OBJECT_PLANE_STATS["serves_completed"] += 1
        OBJECT_PLANE_STATS["serve_bytes"] += len(data)
        conn.reply(msg, data=data)

    def _chunk_from_source(self, conn: protocol.Connection, msg: dict,
                           pull_id: str, sess: _PullSession,
                           index: int) -> None:
        source = sess.source
        if index >= source.nchunks:
            conn.reply(msg, data=None)
            return
        if source.ready(index):
            self._reply_chunk(conn, msg, pull_id, source, index)
            return
        # not landed yet (cut-through): park — the landing thread
        # answers when the range arrives; a failed landing answers
        # dropped, and the child's retry/re-root machinery takes over.
        # NEVER blocks this (possibly shared read-loop) thread.
        def _fire(ok: bool, _conn=conn, _msg=msg) -> None:
            try:
                if ok:
                    self._reply_chunk(_conn, _msg, pull_id, source,
                                      index)
                else:
                    # the landing died: this session can never serve
                    # again — drop it now so its ref stops pinning the
                    # dead landing's segments until the TTL sweep
                    with self._slock:
                        self._drop_session_locked(pull_id)
                    _conn.reply(_msg, data=None)
            except protocol.ConnectionClosed:
                pass

        if not source.add_waiter(index, _fire):
            with self._slock:
                self._drop_session_locked(pull_id)
            conn.reply(msg, data=None)

    def _reply_chunk(self, conn: protocol.Connection, msg: dict,
                     pull_id: str, source, index: int) -> None:
        try:
            views = source.gather(index)
        except (FileNotFoundError, ValueError):
            conn.reply(msg, data=None)
            return
        n = sum(len(v) for v in views)
        OBJECT_PLANE_STATS["serve_bytes"] += n
        if index == source.nchunks - 1:
            with self._slock:
                self._drop_session_locked(pull_id)
            OBJECT_PLANE_STATS["serves_completed"] += 1
        conn.reply(msg, **{RAW_KEY: views})


def pull_object(conn: protocol.Connection, object_id: str,
                timeout: Optional[float] = 60.0,
                retries: Optional[int] = None,
                budget=None, store=None,
                on_first_chunk: Optional[Callable] = None,
                ) -> Optional[StoredObject]:
    """Client side: chunked fetch of one object over `conn`. With
    `store` (and RAY_TPU_PULL_MANIFEST on) the transfer asks for the
    manifest protocol and lands chunk bodies straight into pre-created
    pooled shm segments, sealing the result into `store` itself; an
    old holder's blob reply degrades transparently to the r8 path (the
    caller stores the returned object). A dropped chunk (session
    expired / holder restarted / partial relay stalled past
    pull_partial_chunk_timeout_s) re-opens the session and resumes
    from the failed index, `retries` times (default
    pull_chunk_retries). `budget`, when given, is a reserve/release
    byte-accounting object (see pull_manager): the transfer holds
    `size` of it from meta until return. `on_first_chunk(nbytes)`
    fires once when the first manifest chunk lands — the cut-through
    partial-holder registration hook."""
    if retries is None:
        retries = _CFG.pull_chunk_retries
    deadline = None if timeout is None else time.monotonic() + timeout
    want_manifest = store is not None and _CFG.pull_manifest

    def remaining() -> Optional[float]:
        if deadline is None:
            return None
        return max(0.1, deadline - time.monotonic())

    def _open_msg() -> dict:
        # stamped: the holder's serve span parents under the caller's
        # pull span (PULL_CHUNKs stay unstamped — one span per
        # session, not one per chunk)
        req = {"type": protocol.PULL_OBJECT, "object_id": object_id}
        if want_manifest:
            # per-transfer negotiation: an old holder ignores this
            # unknown key and replies with the blob protocol
            req["manifest"] = True
        return _tp.stamp(req)

    meta = conn.request(_open_msg(), timeout=remaining())
    if not meta.get("found"):
        return None
    size = meta["size"]
    nchunks = meta["nchunks"]
    manifest = meta.get("manifest") if want_manifest else None
    reserved = False
    if budget is not None:
        if not budget.reserve(size, timeout=remaining()):
            raise PullBudgetExceeded(
                f"{object_id}: {size} bytes did not fit the in-flight "
                f"budget before the deadline")
        reserved = True
    try:
        if manifest is not None:
            return _pull_manifest(conn, object_id, store, meta,
                                  retries, remaining, _open_msg,
                                  on_first_chunk)
        OBJECT_PLANE_STATS["blob_pulls"] += 1
        # Windowed chunk fetch: keep pull_pipeline_depth requests in
        # flight so the transfer is bandwidth-bound, not one-RTT-per-
        # chunk lockstep (tree broadcast compounds per-transfer latency
        # across its depth, so this matters doubly there).
        depth = max(1, _CFG.pull_pipeline_depth)
        parts: list = [None] * nchunks
        window: list[tuple[int, object]] = []   # (index, future)
        done = 0
        next_req = 0
        while done < nchunks:
            while next_req < nchunks and len(window) < depth:
                fut = conn.request_async(
                    {"type": protocol.PULL_CHUNK,
                     "pull_id": meta["pull_id"], "index": next_req})
                window.append((next_req, fut))
                next_req += 1
            idx, fut = window.pop(0)
            rep = fut.result(timeout=remaining())
            data = rep.get("data")
            if data is None:
                # session expired / holder lost it mid-pull: re-open and
                # resume from this index (chunking is deterministic).
                # Outstanding window futures reference the dead session
                # and would answer None too — discard them.
                if retries <= 0:
                    return None
                retries -= 1
                OBJECT_PLANE_STATS["chunk_retries"] += 1
                window.clear()
                next_req = idx
                meta = conn.request(_open_msg(), timeout=remaining())
                if (not meta.get("found") or meta["size"] != size
                        or meta.get("manifest") is not None):
                    return None          # gone, or a different incarnation
                continue
            if parts[idx] is None:
                done += 1
            parts[idx] = data
        blob = b"".join(parts)
        OBJECT_PLANE_STATS["land_bytes_copied"] += len(blob)
        return _decode(blob)
    finally:
        if reserved:
            budget.release(size)


def _pull_manifest(conn: protocol.Connection, object_id: str, store,
                   meta: dict, retries: int, remaining,
                   _open_msg, on_first_chunk) -> Optional[StoredObject]:
    """Manifest land loop: windowed chunk fetch writing raw bodies
    straight into the landing's segments; seals into `store` on
    completion (closing the landing->store serve gap before the
    landing leaves the table)."""
    OBJECT_PLANE_STATS["manifest_pulls"] += 1
    size = meta["size"]
    try:
        landing = Landing(store, object_id, meta["manifest"], size)
    except (ValueError, KeyError, TypeError):
        return None                  # malformed manifest: fail the source
    table = landing_table(store)
    if _CFG.pull_cut_through:
        table.put(object_id, landing)
    partial_src = bool(meta["manifest"].get("partial"))
    nchunks = landing.nchunks
    fired_first = False
    ok = False
    try:
        depth = max(1, _CFG.pull_pipeline_depth)
        window: list[tuple[int, object]] = []
        done = 0
        next_req = 0
        while done < nchunks:
            while next_req < nchunks and len(window) < depth:
                fut = conn.request_async(
                    {"type": protocol.PULL_CHUNK,
                     "pull_id": meta["pull_id"], "index": next_req})
                window.append((next_req, fut))
                next_req += 1
            idx, fut = window.pop(0)
            chunk_to = remaining()
            if partial_src:
                # a relay whose own pull stalls must cost a bounded
                # wait, then the retry/re-root machinery — not the
                # transfer's whole deadline
                cap = max(0.1, _CFG.pull_partial_chunk_timeout_s)
                chunk_to = cap if chunk_to is None else min(chunk_to,
                                                            cap)
            dropped = False
            try:
                rep = fut.result(timeout=chunk_to)
            except TimeoutError:
                left = remaining()
                if not partial_src or (left is not None
                                       and left <= 0.2):
                    raise
                dropped = True
                rep = None
            raw = None if dropped else rep.get(RAW_KEY)
            if raw is None:
                if retries <= 0:
                    return None
                retries -= 1
                OBJECT_PLANE_STATS["chunk_retries"] += 1
                window.clear()
                next_req = idx
                meta = conn.request(_open_msg(), timeout=remaining())
                man = meta.get("manifest")
                if (not meta.get("found") or man is None
                        or not landing.matches(man, meta["size"])):
                    return None          # gone, or a different incarnation
                partial_src = bool(man.get("partial"))
                continue
            try:
                fresh = landing.write_chunk(idx, raw)
            except ValueError:
                return None          # wrong-length body: corrupt source
            if fresh:
                done += 1
                if not fired_first and on_first_chunk is not None:
                    fired_first = True
                    try:
                        on_first_chunk(size)
                    except Exception:
                        pass
        stored = landing.complete()
        # seal BEFORE the landing leaves the table: a child's
        # handle_pull always finds the object in exactly one place
        store.put_stored(stored)
        OBJECT_PLANE_STATS["pull_bytes"] += stored.nbytes
        ok = True
        return stored
    finally:
        if not ok:
            landing.fail()
        table.remove(object_id, landing)
        landing.release()
