"""Native core loader: build-on-first-use C library + ctypes bindings.

`core.c` holds the GIL-free channel wait primitive, the CRC32C used by
TFRecord IO, and the r7 wire frame engine (GIL-released socket read
pump, scatter-gather writev flush, and the hot-path Envelope codec) —
see its header comment for the reference parity map. The library is
compiled once per checkout with the system C compiler into
``build/ray_tpu_torch/native_core_<source-hash>.so`` at the repo root,
beside the CUDA kernels (override the directory with
``RAY_TPU_NATIVE_DIR``; extra build flags via ``RAY_TPU_NATIVE_CFLAGS``,
for sanitizer builds) and loaded via
ctypes — no pybind11/setuptools dependency, and every caller keeps a
pure-Python fallback, so a host without a compiler still works
(``RAY_TPU_DISABLE_NATIVE=1`` forces the fallbacks; the wire paths
alone can be disabled with ``RAY_TPU_WIRE_NATIVE=0``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import sys
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "core.c")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


# The JAX package caches its library by source hash under its own
# directory; the port's copy carries its own directory and file name, so
# a process that loads both never gets one library (and one set of
# static state) for the two.
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "ray_tpu_torch")


def _cache_dir() -> str:
    return os.path.expanduser(
        os.environ.get("RAY_TPU_NATIVE_DIR", _BUILD_DIR))


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        src = f.read()
    extra = os.environ.get("RAY_TPU_NATIVE_CFLAGS", "")
    tag = hashlib.sha1(src + extra.encode()).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"native_core_{tag}.so")
    if os.path.exists(out):
        return out
    cc = os.environ.get("CC") or "cc"
    os.makedirs(_cache_dir(), exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    # -Wall -Werror: the on-demand build is this repo's only compile
    # gate for core.c, so warnings must fail it loudly rather than ride
    # silently into every host's cache.
    cmd = [cc, "-O2", "-Wall", "-Werror", "-shared", "-fPIC",
           *shlex.split(extra), "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
        if proc.returncode != 0:
            sys.stderr.write(
                f"ray_tpu_torch: native core build failed "
                f"({' '.join(cmd)}):\n{proc.stderr}\n"
                f"falling back to pure-Python paths\n")
            return None
        os.replace(tmp, out)            # atomic vs concurrent builders
        return out
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        import contextlib
        with contextlib.suppress(OSError):
            os.unlink(tmp)              # failure paths leave no litter


class _IOVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p),
                ("iov_len", ctypes.c_size_t)]


class _EnvView(ctypes.Structure):
    _fields_ = [("version", ctypes.c_uint32),
                ("rid", ctypes.c_uint64),
                ("type_off", ctypes.c_int64),
                ("type_len", ctypes.c_int64),
                ("body_off", ctypes.c_int64),
                ("body_len", ctypes.c_int64),
                ("fields_off", ctypes.c_int64),
                ("fields_len", ctypes.c_int64),
                ("batch_off", ctypes.c_int64),
                ("batch_len", ctypes.c_int64),
                ("trace_id", ctypes.c_uint64),
                ("parent_span", ctypes.c_uint64),
                ("raw_off", ctypes.c_int64),
                ("raw_len", ctypes.c_int64)]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("RAY_TPU_DISABLE_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.rtpu_wait_u64s_ge.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int64]
        lib.rtpu_wait_u64s_ge.restype = ctypes.c_int
        lib.rtpu_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.rtpu_crc32c.restype = ctypes.c_uint32
        lib.rtpu_masked_crc32c.argtypes = [ctypes.c_char_p,
                                           ctypes.c_size_t]
        lib.rtpu_masked_crc32c.restype = ctypes.c_uint32
        lib.rtpu_memcpy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t]
        lib.rtpu_memcpy.restype = None
        # ---- frame engine ----
        lib.rtpu_reader_new.argtypes = [ctypes.c_uint64]
        lib.rtpu_reader_new.restype = ctypes.c_void_p
        lib.rtpu_reader_free.argtypes = [ctypes.c_void_p]
        lib.rtpu_reader_free.restype = None
        lib.rtpu_reader_pump.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rtpu_reader_pump.restype = ctypes.c_long
        lib.rtpu_reader_pump_nb.argtypes = [ctypes.c_void_p,
                                            ctypes.c_int]
        lib.rtpu_reader_pump_nb.restype = ctypes.c_long
        # ---- epoll poller (r10) ----
        lib.rtpu_poller_new.argtypes = []
        lib.rtpu_poller_new.restype = ctypes.c_int
        lib.rtpu_poller_add.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rtpu_poller_add.restype = ctypes.c_int
        lib.rtpu_poller_del.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rtpu_poller_del.restype = ctypes.c_int
        lib.rtpu_poller_wait.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.c_int]
        lib.rtpu_poller_wait.restype = ctypes.c_long
        lib.rtpu_reader_next.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_uint64)]
        lib.rtpu_reader_next.restype = ctypes.c_void_p
        lib.rtpu_writev_full.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(_IOVec),
                                         ctypes.c_long]
        lib.rtpu_writev_full.restype = ctypes.c_long
        lib.rtpu_env_decode.argtypes = [ctypes.c_char_p,
                                        ctypes.c_uint64,
                                        ctypes.POINTER(_EnvView)]
        lib.rtpu_env_decode.restype = ctypes.c_int
        lib.rtpu_batch_split.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long]
        lib.rtpu_batch_split.restype = ctypes.c_long
        lib.rtpu_env_encode.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_env_encode.restype = ctypes.c_long
        lib.rtpu_env_encode_header.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_env_encode_header.restype = ctypes.c_long
        lib.rtpu_batch_encode.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
            ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_batch_encode.restype = ctypes.c_long
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


_engine_memo: tuple = (-1, False)
_config = None


def frame_engine_enabled() -> bool:
    """Whether the wire hot path (read pump / writev flush / envelope
    codec) should go native: the library is loadable AND neither
    RAY_TPU_DISABLE_NATIVE nor RAY_TPU_WIRE_NATIVE=0 is set. Memoized
    per CONFIG generation — this runs several times per frame, so it
    must cost a dict hit, not env lookups; tests and bench A/B runs
    flip modes in-process with env var + CONFIG.reload()."""
    global _engine_memo, _config
    cfg = _config
    if cfg is None:
        from ray_tpu_torch._private.config import CONFIG
        cfg = _config = CONFIG
    gen = cfg._gen
    memo = _engine_memo
    if memo[0] == gen:
        return memo[1]
    on = (not os.environ.get("RAY_TPU_DISABLE_NATIVE")
          and bool(cfg.wire_native) and _load() is not None)
    _engine_memo = (gen, on)
    return on


def wait_u64s_ge(mv: memoryview, offset: int, count: int, value: int,
                 timeout_s: Optional[float]) -> bool:
    """Block (GIL released) until the `count` u64 words at `offset` in
    the writable buffer `mv` are all >= value. True on success, False
    on timeout. Caller guarantees the buffer outlives the call."""
    lib = _load()
    assert lib is not None, "call native.available() first"
    base = ctypes.addressof(ctypes.c_char.from_buffer(mv, offset))
    t_ns = -1 if timeout_s is None else max(0, int(timeout_s * 1e9))
    return lib.rtpu_wait_u64s_ge(base, count, value, t_ns) == 0


def buf_copy(dst, dst_off: int, src) -> int:
    """memcpy `src` (any contiguous buffer, read-only OK) into the
    WRITABLE buffer `dst` at `dst_off`, GIL released for the whole
    copy (r12 land path: multi-MB chunk bodies go wire-view -> mapped
    shm without stalling the runtime's other threads). Caller
    guarantees both buffers outlive the call; returns bytes copied."""
    lib = _load()
    assert lib is not None, "call native.available() first"
    import numpy as _np
    s = _np.frombuffer(src, dtype=_np.uint8)
    n = s.nbytes
    if n:
        base = ctypes.addressof(ctypes.c_char.from_buffer(dst, dst_off))
        lib.rtpu_memcpy(base, s.ctypes.data, n)
    return n


def crc32c(data: bytes) -> int:
    lib = _load()
    assert lib is not None
    return int(lib.rtpu_crc32c(data, len(data)))


def masked_crc32c(data: bytes) -> int:
    lib = _load()
    assert lib is not None
    return int(lib.rtpu_masked_crc32c(data, len(data)))


# ======================= frame engine bindings =======================

class PumpClosed(Exception):
    """Read pump hit EOF: the peer closed the stream."""


class PumpOversized(Exception):
    """A frame's length prefix exceeds the max-frame sanity bound:
    corrupt (or hostile) stream."""


class FrameReader:
    """Per-connection GIL-released read pump over a dup of the socket
    fd. The dup pins the open file description so a concurrent
    ``Connection.close()`` (shutdown + close of the original fd) wakes
    the blocked read with EOF instead of racing fd reuse; the dup is
    closed here, by the owning reader thread, on exit."""

    def __init__(self, fd: int, max_frame: int):
        lib = _load()
        assert lib is not None, "check frame_engine_enabled() first"
        self._lib = lib
        self._fd = os.dup(fd)
        self._handle = lib.rtpu_reader_new(max(0, int(max_frame)))
        if not self._handle:
            os.close(self._fd)
            raise MemoryError("rtpu_reader_new failed")

    @property
    def fd(self) -> int:
        """The dup'd fd the pump reads (register THIS in a poller: it
        stays valid until close(), unlike the original, which another
        thread may close at any time)."""
        return self._fd

    def _collect(self) -> list[bytes]:
        frames = []
        length = ctypes.c_uint64()
        while True:
            ptr = self._lib.rtpu_reader_next(
                self._handle, ctypes.byref(length))
            if not ptr:
                break
            frames.append(ctypes.string_at(ptr, length.value))
        return frames

    def pump(self) -> list[bytes]:
        """Block (GIL released) until at least one complete frame is
        buffered; returns all complete frame bodies. Raises PumpClosed
        on EOF, PumpOversized on a corrupt length prefix, OSError on a
        read error."""
        n = self._lib.rtpu_reader_pump(self._handle, self._fd)
        if n > 0:
            return self._collect()
        if n == 0:
            raise PumpClosed("peer closed")
        if n == -2:
            raise PumpOversized(
                "frame length prefix exceeds wire_max_frame_bytes")
        raise OSError("native frame read failed")

    def pump_nb(self) -> list[bytes]:
        """Non-blocking pump (epoll loop): drain whatever the kernel
        has via recv(MSG_DONTWAIT) and return the complete frames
        buffered so far — [] when no complete frame is ready yet (the
        level-triggered poller re-reports the fd when more arrives).
        Raises like pump()."""
        n = self._lib.rtpu_reader_pump_nb(self._handle, self._fd)
        if n > 0:
            return self._collect()
        if n == -4:
            return []
        if n == 0:
            raise PumpClosed("peer closed")
        if n == -2:
            raise PumpOversized(
                "frame length prefix exceeds wire_max_frame_bytes")
        raise OSError("native frame read failed")

    def close(self) -> None:
        if self._handle:
            self._lib.rtpu_reader_free(self._handle)
            self._handle = None
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1


def writev_all(fd: int, bufs: list[bytes]) -> None:
    """Write every buffer to the RAW fd as one scatter-gather flush
    (GIL released; partial writes and EINTR handled in C). Raises
    OSError with the failing errno — EAGAIN means the fd's SO_SNDTIMEO
    budget expired mid-write (stream desynced, kill the connection).
    Caller owns the fd's lifetime for the duration of the call: for
    sockets shared across threads prefer ``sock.sendmsg`` (as
    protocol._sendmsg_all does) — a raw fd captured before a
    concurrent close() can be reused by an unrelated connection."""
    lib = _load()
    assert lib is not None
    n = len(bufs)
    iov = (_IOVec * n)()
    for i, b in enumerate(bufs):
        iov[i].iov_base = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
        iov[i].iov_len = len(b)
    rc = lib.rtpu_writev_full(fd, iov, n)
    if rc != 0:
        raise OSError(int(-rc), os.strerror(int(-rc)))


def env_encode(version: int, mtype: bytes, rid: int,
               body: bytes) -> bytes:
    """Serialize a Python-plane Envelope (header + opaque py_body)."""
    lib = _load()
    cap = 40 + len(mtype) + len(body)
    out = ctypes.create_string_buffer(cap)
    n = lib.rtpu_env_encode(version, mtype, len(mtype), rid,
                            body, len(body), out, cap)
    assert n >= 0, "env_encode capacity bound violated"
    return ctypes.string_at(out, n)


def env_encode_header(version: int, mtype: bytes, rid: int,
                      last_tag: int, payload_len: int) -> bytes:
    """Envelope header bytes only: the payload (py_body pickle /
    batch interior) is announced via last_tag (0x2a / 0x32; 0 = none)
    + payload_len but NOT copied — the emit path sends it as its own
    writev iovec straight from the object that produced it."""
    lib = _load()
    cap = 64 + len(mtype)
    out = ctypes.create_string_buffer(cap)
    n = lib.rtpu_env_encode_header(version, mtype, len(mtype), rid,
                                   last_tag, payload_len, out, cap)
    assert n >= 0, "env_encode_header capacity bound violated"
    return ctypes.string_at(out, n)


def env_decode(data: bytes):
    """Parse the top-level Envelope fields of `data`. Returns
    ``(version, rid, type_bytes, body_bytes|None, fields_len,
    batch_off, batch_len, trace_id, parent_span, raw|None)`` with
    fields_len = -1 / batch_off = -1 when absent and trace ids 0 when
    unset, or None when the fast parser can't handle the input (the
    caller falls back to the real protobuf codec)."""
    lib = _load()
    view = _EnvView()
    if lib.rtpu_env_decode(data, len(data), ctypes.byref(view)) != 0:
        return None
    mtype = (data[view.type_off:view.type_off + view.type_len]
             if view.type_off >= 0 else b"")
    # body (and the r12 raw bulk payload) as zero-copy views: callers
    # hand them straight to pickle.loads / the shm land path, and a
    # bytes slice would copy multi-MB pull chunks a second time on
    # every frame
    body = (memoryview(data)[view.body_off:view.body_off + view.body_len]
            if view.body_off >= 0 else None)
    raw = (memoryview(data)[view.raw_off:view.raw_off + view.raw_len]
           if view.raw_off >= 0 else None)
    return (view.version, view.rid, mtype, body,
            view.fields_len if view.fields_off >= 0 else -1,
            view.batch_off, view.batch_len,
            view.trace_id, view.parent_span, raw)


def batch_split(data: bytes, off: int, length: int):
    """Split the BatchFrame submessage at data[off:off+length] into
    absolute (offset, length) sub-Envelope views, or None on malformed
    input."""
    lib = _load()
    batch = data[off:off + length]
    cap = 128
    while True:
        offs = (ctypes.c_uint64 * cap)()
        lens = (ctypes.c_uint64 * cap)()
        n = lib.rtpu_batch_split(batch, length, offs, lens, cap)
        if n < 0:
            return None
        if n <= cap:
            return [(off + offs[i], lens[i]) for i in range(n)]
        cap = n


class EpollPoller:
    """Thin wrapper over the rtpu_poller_* epoll API (r10): one
    instance drives the read side of many connections. wait() blocks
    with the GIL released (ctypes call); add/del are callable from any
    thread while a wait is in flight (kernel epoll semantics)."""

    def __init__(self):
        lib = _load()
        assert lib is not None, "check frame_engine_enabled() first"
        self._lib = lib
        self._epfd = lib.rtpu_poller_new()
        if self._epfd < 0:
            raise OSError(-self._epfd, os.strerror(-self._epfd))

    def add(self, fd: int) -> None:
        rc = self._lib.rtpu_poller_add(self._epfd, fd)
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc))

    def remove(self, fd: int) -> None:
        rc = self._lib.rtpu_poller_del(self._epfd, fd)
        if rc != 0 and rc != -9:        # EBADF: fd already closed
            raise OSError(-rc, os.strerror(-rc))

    def wait(self, timeout_ms: int, max_events: int = 64) -> list[int]:
        """Ready fd numbers ([] on timeout/EINTR)."""
        out = (ctypes.c_int * max_events)()
        n = self._lib.rtpu_poller_wait(self._epfd, out, max_events,
                                       int(timeout_ms))
        if n < 0:
            raise OSError(int(-n), os.strerror(int(-n)))
        return [out[i] for i in range(n)]

    def close(self) -> None:
        if self._epfd >= 0:
            try:
                os.close(self._epfd)
            except OSError:
                pass
            self._epfd = -1


def batch_encode(version: int, mtype: bytes,
                 subs: list[bytes]) -> bytes:
    """Assemble one BatchFrame Envelope from pre-serialized sub-
    Envelope buffers."""
    lib = _load()
    n = len(subs)
    ptrs = (ctypes.c_char_p * n)(*subs)
    lens = (ctypes.c_uint64 * n)(*[len(s) for s in subs])
    cap = 40 + len(mtype) + sum(len(s) + 11 for s in subs)
    out = ctypes.create_string_buffer(cap)
    written = lib.rtpu_batch_encode(version, mtype, len(mtype),
                                    ptrs, lens, n, out, cap)
    assert written >= 0, "batch_encode capacity bound violated"
    return ctypes.string_at(out, written)
