"""Head HA (r15): write-ahead-logged, restartable control plane.

The head's tables were snapshotted at 1 Hz (r5) — a crash lost up to a
second of submits/completions and the snapshot never covered the spec
mirror, the delegated lease ledgers, or live-task accounting. This
module closes the gap the way the reference closes it for the GCS
(PAPER.md L0: GCS state persists to Redis precisely because the head
is otherwise the cluster's SPOF):

- ``WriteAheadLog``: an append-only log of state-mutating head events.
  Records are CRC32-framed (``[len u32][crc u32][payload]``); a torn
  tail — the crash landed mid-write — truncates at the last good
  frame instead of poisoning recovery. Appends are buffered and a
  single flusher thread group-commits them with ONE ``write`` + ONE
  ``fsync`` per ``RAY_TPU_HEAD_WAL_FSYNC_MS`` window, so per-event
  durability costs a list append, not a syscall.
- Snapshot+truncate compaction: when the active segment passes
  ``RAY_TPU_HEAD_WAL_COMPACT_BYTES`` (or the compact interval), the
  segment rotates, a fresh snapshot is taken, and the old segment is
  deleted. The snapshot embeds the WAL sequence frontier it covers
  (captured under the controller lock, so mutate+log pairs are atomic
  w.r.t. the capture); replay skips records at or below the frontier,
  which makes replay idempotent even across the rotation window.
- ``HeadPersistence``: the recovery coordinator. It loads the newest
  intact snapshot (version+checksum framed; a corrupt blob falls back
  to the previous good one), replays the WAL tail into the controller
  tables, and parks each agent's rehydrated spec mirror + lease
  ledger until that agent rejoins — at which point the mirror is
  reconciled against the agent's reported in-flight set: tasks the
  agent never received are re-placed exactly once, tasks it is still
  draining stay mirrored, and completion batches it replays are
  deduped by the ordinary mirror pop.

Record design note: records are SET-semantics wherever an increment
would make replay order- or multiplicity-sensitive — refcounts and
pins are logged as absolute values (coalesced into one ``refs`` record
per flush window, the WAL's decref-batch analogue), mirrors and
directories as keyed add/remove, and node ``incarnation`` records
(r17 fencing epochs) as absolute values merged by max, so replaying a
rotated segment can never roll an epoch back and resurrect a zombie.
Replaying a tail twice therefore converges to the same tables, which
is what the recovery matrix in ``tests/test_head_ha.py`` (and the
incarnation round-trip in ``tests/test_membership.py``) asserts.
"""
from __future__ import annotations

import logging
import os
import pickle
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, Optional

log = logging.getLogger(__name__)

_FRAME = struct.Struct("<II")            # payload length, crc32(payload)
SNAP_MAGIC = b"RTPUSNP1"
_SNAP_HDR = struct.Struct("<II")         # version, crc32(blob)
SNAP_VERSION = 1

# terminal task-event states: these pop the live-task table
TERMINAL_TASK_STATES = ("FINISHED", "FAILED", "CANCELLED")


def _encode(obj: Any) -> bytes:
    """Records hold raw user task args (closures) exactly like the
    snapshot does — plain pickle where it works, cloudpickle where it
    must (same rationale as ``Controller.snapshot_state``)."""
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception:
        import cloudpickle
        return cloudpickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def frame_snapshot(blob: bytes) -> bytes:
    """Version+checksum envelope for a snapshot blob: a partially
    written or bit-rotted file is DETECTED at restore instead of
    pickling garbage into half-initialized tables."""
    return SNAP_MAGIC + _SNAP_HDR.pack(SNAP_VERSION,
                                       zlib.crc32(blob) & 0xFFFFFFFF) + blob


def unframe_snapshot(data: bytes) -> bytes:
    """Inverse of ``frame_snapshot``; raises ValueError on a corrupt or
    torn blob. Pre-r15 snapshots (no magic) pass through unchanged so
    an upgraded head still restores its last pre-upgrade state."""
    if not data.startswith(SNAP_MAGIC):
        return data                       # legacy unframed blob
    hdr = data[len(SNAP_MAGIC):len(SNAP_MAGIC) + _SNAP_HDR.size]
    if len(hdr) < _SNAP_HDR.size:
        raise ValueError("snapshot header torn")
    version, crc = _SNAP_HDR.unpack(hdr)
    if version > SNAP_VERSION:
        raise ValueError(f"snapshot version {version} from the future")
    blob = data[len(SNAP_MAGIC) + _SNAP_HDR.size:]
    if zlib.crc32(blob) & 0xFFFFFFFF != crc:
        raise ValueError("snapshot checksum mismatch (torn write?)")
    return blob


def write_snapshot_file(path: str, blob: bytes) -> None:
    """Atomic, torn-write-proof snapshot publication (shared by the
    WAL and snapshot-only modes): frame (version+crc) → tmp file →
    flush+fsync → rotate the current snapshot to ``.prev`` → rename
    into place. A crash anywhere in the sequence leaves at least one
    intact, verifiable blob."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(frame_snapshot(blob))
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        os.replace(path, path + ".prev")
    os.replace(tmp, path)


def load_snapshot_file(path: str):
    """Newest intact snapshot blob as ``(blob, used_fallback)``: the
    current file, else the previous good one — a torn current blob
    must not zero the head's tables (the pre-r15 failure mode).
    ``(None, False)`` when neither verifies."""
    for candidate, fallback in ((path, False), (path + ".prev", True)):
        if not os.path.exists(candidate):
            continue
        try:
            with open(candidate, "rb") as f:
                return unframe_snapshot(f.read()), fallback
        except Exception:
            log.exception("head snapshot %s unusable", candidate)
    return None, False


class WriteAheadLog:
    """Group-committed, CRC-framed append log with rotate/compact.

    ``append`` assigns a monotonic sequence number under the buffer
    lock and parks the already-encoded frame; the flusher thread
    drains the buffer with one write+fsync per window. ``log_ref``
    coalesces absolute refcount/pin values into ONE ``refs`` record
    per flush (a decref storm costs a dict update per object, not a
    record per event)."""

    def __init__(self, path: str, fsync_ms: float = 5.0):
        self.path = path
        self._fsync_s = max(0.0, fsync_ms) / 1000.0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        self._lock = threading.Lock()
        # serializes fd use (write/fsync/rotate/close) WITHOUT holding
        # the buffer lock across syscalls: appends never block on an
        # in-flight fsync, and compaction can never close the fd under
        # a concurrent flush (ordering: _lock before _io, never inverse)
        self._io = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._buf: list[bytes] = []
        self._pending_refs: Dict[str, tuple] = {}
        self._seq = 0
        self._flushed_seq = 0          # highest seq durably on disk
        self._flush_cv = threading.Condition(self._lock)
        self._closed = False
        # stats
        self.records = 0
        self.bytes_written = int(os.path.getsize(path)
                                 if os.path.exists(path) else 0)
        self.fsyncs = 0
        self.compactions = 0
        self._fsync_ns: list[int] = []     # ring of recent durations
        self._segment_bytes = self.bytes_written
        self._segment_opened = time.monotonic()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="rtpu-head-wal", daemon=True)
        self._flusher.start()

    # ------------------------------------------------------- appending
    def current_seq(self) -> int:
        """Sequence frontier (captured by snapshots). Taking the WAL
        lock here is safe from inside controller-locked sections: the
        WAL never calls back out."""
        with self._lock:
            return self._seq

    def advance_seq(self, floor: int) -> None:
        """Seed the sequence counter past recovered state (r15 review
        fix): a restarted head appends to the SAME segment the old
        process wrote, and a counter restarting at 0 would (a) mint
        seqs the snapshot frontier wrongly skips and (b) collide with
        the old records still in the file until first compaction —
        breaking exact-frontier replay on a double crash."""
        with self._lock:
            if floor > self._seq:
                self._seq = floor
                self._flushed_seq = max(self._flushed_seq, floor)

    def append(self, rtype: str, data: Any) -> int:
        """Park one record for the next group commit. The payload is
        encoded NOW, not at flush — specs mutate after submit
        (retries_used, trace parents) and the record must capture the
        state that was logged, not whatever the object looks like when
        the flusher gets to it."""
        with self._lock:
            if self._closed:
                return self._seq
            self._seq += 1
            payload = _encode((self._seq, rtype, data))
            self._buf.append(_FRAME.pack(len(payload),
                                         zlib.crc32(payload) & 0xFFFFFFFF)
                             + payload)
            self._cv.notify()
            return self._seq

    def log_ref(self, object_id: str, refcount: int, pins: int) -> None:
        """Absolute refcount+pin state for one object; coalesced —
        last value per object wins within a flush window, and replay
        SETS rather than increments, so duplicated replay is a no-op."""
        with self._lock:
            if self._closed:
                return
            self._pending_refs[object_id] = (int(refcount), int(pins))
            self._cv.notify()

    # -------------------------------------------------------- flushing
    def _drain_locked(self) -> list[bytes]:
        frames, self._buf = self._buf, []
        if self._pending_refs:
            refs, self._pending_refs = self._pending_refs, {}
            self._seq += 1
            payload = _encode((self._seq, "refs", refs))
            frames.append(_FRAME.pack(len(payload),
                                      zlib.crc32(payload) & 0xFFFFFFFF)
                          + payload)
        return frames

    def _flush_once(self) -> None:
        with self._lock:
            frames = self._drain_locked()
            drained_seq = self._seq
        if not frames:
            # nothing to write: durability of already-drained frames is
            # advanced by whichever write drained them (flusher or
            # compaction), never here — an empty pass must not declare
            # a concurrent in-flight write durable
            return
        blob = b"".join(frames)
        t0 = time.perf_counter_ns()
        with self._io:
            # the fd is re-read under the io lock: a concurrent
            # compaction may have rotated it, and these frames landing
            # in the NEW segment is fine (replay sorts by seq; their
            # mutations predate the compaction snapshot's frontier)
            os.write(self._fd, blob)
            os.fsync(self._fd)
        dt = time.perf_counter_ns() - t0
        with self._lock:
            self.records += len(frames)
            self.bytes_written += len(blob)
            self._segment_bytes += len(blob)
            self.fsyncs += 1
            self._fsync_ns.append(dt)
            if len(self._fsync_ns) > 256:
                del self._fsync_ns[:128]
            self._flushed_seq = max(self._flushed_seq, drained_seq)
            self._flush_cv.notify_all()

    def _flush_loop(self) -> None:
        while True:
            with self._cv:
                while (not self._buf and not self._pending_refs
                       and not self._closed):
                    self._cv.wait(timeout=1.0)
                if self._closed and not self._buf \
                        and not self._pending_refs:
                    return
            # collect-then-flush: let the window fill so one fsync
            # covers every record emitted inside it
            if self._fsync_s > 0:
                time.sleep(self._fsync_s)
            try:
                self._flush_once()
            except Exception:
                log.exception("head WAL flush failed")
                time.sleep(0.1)

    def sync(self, timeout: float = 5.0) -> None:
        """Block until everything appended BEFORE this call is on disk
        — tracked by sequence number, so an in-flight flush of older
        frames completing cannot satisfy the wait early (r15 review
        fix of the event-based version)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            target = self._seq
            if self._pending_refs:
                target += 1            # the refs record mints one more
            while self._flushed_seq < target and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._flush_cv.wait(remaining)

    # ------------------------------------------------------ compaction
    def should_compact(self, compact_bytes: int,
                       compact_interval_s: float) -> bool:
        with self._lock:
            if self._segment_bytes <= 0:
                return False
            if compact_bytes > 0 and self._segment_bytes >= compact_bytes:
                return True
            return (compact_interval_s > 0
                    and time.monotonic() - self._segment_opened
                    >= compact_interval_s
                    and self._segment_bytes > 0)

    def compact(self, snapshot_fn: Callable[[], None]) -> bool:
        """Rotate the active segment, take a fresh snapshot, delete the
        rotated segment. Crash-safe at every step: recovery replays
        ``path.old`` (if present) then ``path`` in sequence order, and
        the snapshot's embedded frontier skips anything it already
        covers — so a crash between rotation and snapshot publication
        loses nothing and duplicates nothing."""
        old = self.path + ".old"
        if os.path.exists(old):
            # a PREVIOUS compaction's snapshot failed and its rotated
            # segment is still the only copy of those records —
            # rotating again would destroy it (r15 review fix).
            # Snapshot first (the frontier covers the retained segment
            # too), clear it on success, and rotate on the next pass.
            try:
                snapshot_fn()
            except Exception:
                log.exception("head WAL compaction snapshot failed; "
                              "keeping retained segment")
                return False
            try:
                os.unlink(old)
            except OSError:
                pass
            with self._lock:
                self.compactions += 1
            return True
        with self._lock:
            if self._closed:
                return False
            # flush the buffer into the outgoing segment first so its
            # records are on disk before the snapshot frontier is read
            frames = self._drain_locked()
            drained_seq = self._seq
        with self._io:
            if frames:
                blob = b"".join(frames)
                os.write(self._fd, blob)
                os.fsync(self._fd)
            os.replace(self.path, old)
            os.close(self._fd)
            self._fd = os.open(self.path,
                               os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        with self._lock:
            if frames:
                self.records += len(frames)
                self.bytes_written += sum(len(f) for f in frames)
                self.fsyncs += 1
            self._flushed_seq = max(self._flushed_seq, drained_seq)
            self._flush_cv.notify_all()
            self._segment_bytes = 0
            self._segment_opened = time.monotonic()
        try:
            snapshot_fn()                  # captures the seq frontier
        except Exception:
            # snapshot failed: keep BOTH segments — recovery still has
            # the previous snapshot plus the full record trail
            log.exception("head WAL compaction snapshot failed; "
                          "keeping rotated segment")
            return False
        try:
            os.unlink(old)
        except OSError:
            pass
        with self._lock:
            self.compactions += 1
        return True

    # -------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
            self._flush_cv.notify_all()    # unblock sync() waiters
        self._flusher.join(timeout=5.0)
        try:
            self._flush_once()             # final drain (flusher exited)
        except Exception:
            pass
        try:
            with self._io:
                os.close(self._fd)
        except OSError:
            pass

    def stats(self) -> dict:
        with self._lock:
            ns = sorted(self._fsync_ns)
            p = (lambda q: round(
                ns[min(len(ns) - 1, int(q * len(ns)))] / 1e6, 3)
                if ns else None)
            return {
                "path": self.path,
                "seq": self._seq,
                "records": self.records,
                "bytes": self.bytes_written,
                "segment_bytes": self._segment_bytes,
                "fsyncs": self.fsyncs,
                "fsync_p50_ms": p(0.50),
                "fsync_p99_ms": p(0.99),
                "compactions": self.compactions,
                "buffered": len(self._buf) + len(self._pending_refs),
            }


def read_wal(path: str) -> list[tuple]:
    """Decode one segment: ``[(seq, rtype, data), ...]``. A torn tail
    (crash mid-write) truncates at the last frame whose length and
    CRC both verify — everything before it is intact by construction
    (frames are appended in one write, in order)."""
    out: list[tuple] = []
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return out
    off = 0
    n = len(data)
    while off + _FRAME.size <= n:
        ln, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        end = start + ln
        if ln <= 0 or end > n:
            break                          # torn tail
        payload = data[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break                          # torn/corrupt tail
        try:
            rec = pickle.loads(payload)
        except Exception:
            break
        out.append(rec)
        off = end
    return out


class _PendingNode:
    """A rehydrated agent's mirror + lease ledger, parked until the
    agent rejoins (or its rejoin grace expires)."""

    def __init__(self, work: dict, leased: set):
        self.work = dict(work)             # key -> (spec, dispatched)
        self.leased = set(leased)


class HeadPersistence:
    """Recovery coordinator + live logging front-end for the runtime.

    Lifecycle: construct → ``recover()`` (replays snapshot+WAL into
    the controller and parks per-node mirrors) → ``activate()`` (live
    records start flowing). Logging before activation is suppressed so
    replay can drive the ordinary controller methods without
    re-logging its own input."""

    def __init__(self, snapshot_path: str, wal_path: str,
                 fsync_ms: float = 5.0, compact_bytes: int = 8 << 20,
                 compact_interval_s: float = 30.0):
        self.snapshot_path = snapshot_path
        self.wal = WriteAheadLog(wal_path, fsync_ms=fsync_ms)
        self._compact_bytes = int(compact_bytes)
        self._compact_interval_s = float(compact_interval_s)
        self._active = False
        self._lock = threading.Lock()
        self.pending_nodes: Dict[str, _PendingNode] = {}
        # recovery/replay observability
        self.recovered = {"snapshot": False, "snapshot_fallback": False,
                          "wal_records": 0, "wal_skipped": 0,
                          "live_tasks": 0, "mirrored_tasks": 0,
                          "resubmitted": 0, "replayed_completions": 0,
                          "deduped_completions": 0}
        self.restored_task_ids: set[str] = set()
        self.last_snapshot_at: Optional[float] = None

    # ------------------------------------------------------- live path
    def active(self) -> bool:
        return self._active

    def activate(self) -> None:
        self._active = True

    def log(self, rtype: str, data: Any) -> None:
        if self._active:
            self.wal.append(rtype, data)

    def log_ref(self, object_id: str, refcount: int, pins: int) -> None:
        if self._active:
            self.wal.log_ref(object_id, refcount, pins)

    def wal_seq(self) -> int:
        return self.wal.current_seq()

    # ------------------------------------------------------- snapshots
    def write_snapshot(self, blob: bytes) -> None:
        write_snapshot_file(self.snapshot_path, blob)
        self.last_snapshot_at = time.monotonic()

    def load_snapshot(self) -> Optional[bytes]:
        blob, fallback = load_snapshot_file(self.snapshot_path)
        if blob is not None:
            self.recovered["snapshot"] = True
            self.recovered["snapshot_fallback"] = fallback
            if fallback:
                log.warning("head snapshot %s corrupt; restored from "
                            "the previous good generation",
                            self.snapshot_path)
        return blob

    # -------------------------------------------------------- recovery
    def wal_tail(self) -> list[tuple]:
        """Every retained record in sequence order: a rotated-but-not-
        deleted segment (compaction crashed mid-way) first, then the
        active segment."""
        recs = read_wal(self.wal.path + ".old") + read_wal(self.wal.path)
        recs.sort(key=lambda r: r[0])
        return recs

    def replay(self, controller, records: Iterable[tuple],
               frontier: int, mirrors: Dict[str, dict],
               leases: Dict[str, set]) -> int:
        """Apply WAL records newer than the snapshot frontier to the
        controller tables and the parked per-node mirrors. Record
        application is set-semantics throughout, so replaying a tail
        (or parts of it) more than once converges — the
        torn-compaction path depends on this."""
        applied = 0
        for seq, rtype, data in records:
            if seq <= frontier:
                self.recovered["wal_skipped"] += 1
                continue
            try:
                if rtype in ("madd", "lease"):
                    if rtype == "madd":
                        node_id, key = data
                        mirrors.setdefault(node_id, {})[key] = None
                    else:
                        node_id, ids = data
                        leases.setdefault(node_id, set()).update(ids)
                else:
                    controller.apply_wal_record(rtype, data)
                applied += 1
            except Exception:
                log.exception("head WAL replay failed on %r", rtype)
        self.recovered["wal_records"] = applied
        return applied

    def park_node(self, node_id: str, work: dict, leased: set) -> None:
        with self._lock:
            self.pending_nodes[node_id] = _PendingNode(work, leased)
            self.recovered["mirrored_tasks"] += len(work)

    def take_pending_node(self, node_id: str) -> Optional[_PendingNode]:
        with self._lock:
            return self.pending_nodes.pop(node_id, None)

    def pending_mirrors(self) -> Dict[str, dict]:
        """Mirror view of nodes still awaiting rejoin — merged into
        snapshots taken during the grace window so a compaction there
        cannot drop a not-yet-reclaimed node's work."""
        with self._lock:
            return {nid: {"work": dict(p.work), "leased": list(p.leased)}
                    for nid, p in self.pending_nodes.items()}

    def note_replayed_completion(self, task_id: str,
                                 deduped: bool) -> None:
        if deduped:
            self.recovered["deduped_completions"] += 1
        else:
            self.recovered["replayed_completions"] += 1
        self.restored_task_ids.discard(task_id)

    # ---------------------------------------------------------- stats
    def maybe_compact(self, snapshot_fn: Callable[[], None]) -> bool:
        if not self._active:
            return False
        if not self.wal.should_compact(self._compact_bytes,
                                       self._compact_interval_s):
            return False
        return self.wal.compact(snapshot_fn)

    def stats(self) -> dict:
        with self._lock:
            pending = {nid: len(p.work)
                       for nid, p in self.pending_nodes.items()}
        age = (None if self.last_snapshot_at is None
               else round(time.monotonic() - self.last_snapshot_at, 3))
        return {
            "enabled": True,
            "active": self._active,
            "wal": self.wal.stats(),
            "last_snapshot_age_s": age,
            "pending_rejoin_mirrors": pending,
            "recovered": dict(self.recovered),
        }

    def close(self) -> None:
        self._active = False
        self.wal.close()
