"""Mutable shared-memory channels: the compiled-DAG fast path.

Port of `ray_tpu/experimental/channel.py`. Parity: reference
python/ray/experimental/channel/shared_memory_channel.py
+ src/ray/core_worker/experimental_mutable_object_manager.cc — a
fixed-capacity single-writer / multi-reader shm ring that is REUSED for
every message, so a compiled DAG's hops exchange data with one memcpy
and zero store round-trips, task submissions, or driver hops.

Protocol (one segment per channel, `depth` payload slots):

    u64 magic | u64 n_readers | u64 seq | u64 depth
    u64 acks[n_readers] | u64 lens[depth]
    ... depth * capacity payload bytes ...

Messages are numbered from 1; message s lives in slot (s-1) % depth.
The writer waits until every reader's ack is >= s - depth (the slot's
previous occupant is fully consumed), copies the payload into the slot,
stores lens[slot], then publishes seq=s — a single aligned u64 store,
which is atomic on every platform the runtime targets. Reader i polls
seq until it reaches its expected value, copies the payload out, then
stores ack[i]=s. Each header word has exactly one writer, so no
cross-process atomics beyond aligned stores are needed. Blocking is
adaptive spin -> sleep polling (the reference uses futex-backed
semaphores; at the ~µs scales involved polling is competitive and
portable).

depth > 1 (r13, default RAY_TPU_CHANNEL_RING_DEPTH=2) is what makes
transfer/compute OVERLAP possible: with a single slot the writer blocks
until every reader consumed the previous message, serializing a
pipeline stage's send with its neighbor's compute; with two slots the
writer publishes message s and immediately starts computing s+1 while
the reader drains s (double buffering). MPMD pipeline stages depend on
this (train/pipeline.py).

Tensors: a numpy array or a `torch.Tensor` rides a RAW frame (its bytes
and a small meta), never a pickle stream. A tensor's bytes are
`tensor.contiguous().view(torch.uint8)` (bf16 included: numpy has no
bfloat16, so the dtype travels by name). A CUDA tensor is copied
straight from the card into the mapped slot; the reader lands it on ITS
OWN current CUDA device (two stage actors may share one card, and across
hosts a device number means nothing), and the copy is synchronized
before the slot is acked. A CPU tensor owns its bytes before the ack.

Channels are HOST-LOCAL (the segment lives in this host's /dev/shm),
like the reference's shm channels; cross-host DAG edges ride the r13
wire transport instead (experimental/wire_channel.py).
"""
from __future__ import annotations

import pickle
import struct
import sys
import time
import uuid
from typing import Any, Optional

import cloudpickle

from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.object_store import (_create_segment,
                                                 _map_segment,
                                                 unlink_segment)

_MAGIC = 0x52545055_4348414E          # "RTPUCHAN"
_CLOSED_LEN = (1 << 63) - 1           # writer closed the channel
_ERROR_FLAG = 1 << 62                 # payload pickles an error repr
# Tensor fast path (reference torch_tensor_nccl_channel.py intent, over
# host bytes): the payload is a RAW frame — u32 meta_len + pickled meta
# + bytes — written with ONE copy into the mapped slot and landed by
# the reader with one copy out. No pickle stream on the hot edge.
_RAW_FLAG = 1 << 61
_LEN_MASK = (1 << 61) - 1


def _raw_ok(dtype) -> bool:
    # object/structured dtypes need the pickle path; the dtype OBJECT
    # (not .str, which is lossy for structured dtypes) travels pickled
    # in the meta
    return not (dtype.hasobject or dtype.fields)


def _torch_payload(value, torch):
    """(meta, flat uint8 tensor) for a dense tensor; the bytes stay on
    the tensor's device until the writer copies them out. Anything a
    raw frame cannot carry raises: a CUDA tensor never falls back to a
    pickle stream."""
    if (type(value) not in (torch.Tensor, torch.nn.Parameter)
            or value.layout != torch.strided):
        raise TypeError(
            f"a channel carries dense tensors only, got "
            f"{type(value).__name__} with layout {value.layout}")
    if value.device.type not in ("cpu", "cuda"):
        raise TypeError(f"a channel cannot carry a tensor on "
                        f"{value.device}")
    t = value.detach()
    if t.is_conj() or t.is_neg():
        t = t.resolve_conj().resolve_neg()
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    meta = ("torch", str(t.dtype).rsplit(".", 1)[-1], tuple(t.shape),
            t.device.type == "cuda")
    return pickle.dumps(meta), flat


def _array_payload(value):
    """(meta, bytes) for a raw frame — the bytes a flat uint8 numpy
    array, or a flat uint8 tensor (CPU or CUDA) — or None for the pickle
    path. A
    `torch.Tensor` round-trips as a tensor (on the reader's own card
    when it left a card); plain numpy stays numpy (subclasses like
    MaskedArray take the pickle path — coercion would drop their
    semantics)."""
    import numpy as np
    if type(value) is np.ndarray and _raw_ok(value.dtype):
        arr = np.ascontiguousarray(value)
        return (pickle.dumps(("numpy", arr.dtype, arr.shape, False)),
                arr.reshape(-1).view(np.uint8))
    # a process that never imported torch holds no tensor
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return _torch_payload(value, torch)
    return None


def _copy_into(dst, body) -> None:
    """Copy a payload's bytes into `dst` (a writable uint8 ndarray view
    of a mapped slot). A CUDA tensor's copy to the host is synchronous:
    it has landed when this returns."""
    import numpy as np
    if isinstance(body, np.ndarray):
        dst[...] = body
        return
    import torch
    torch.from_numpy(dst).copy_(body)


def _host_bytes(body):
    """The payload's bytes as a contiguous uint8 ndarray on the host
    (the wire transport's raw field)."""
    import numpy as np
    if isinstance(body, np.ndarray):
        return body
    return body.cpu().numpy()


def _decode_payload(meta, body, owned: bool = False):
    """The value of a raw frame from `body`, a uint8 ndarray. Unless
    `owned`, the caller reuses `body` once this returns (a mapped ring
    slot), so the result owns its bytes; a tensor bound for the card has
    landed there."""
    import numpy as np
    kind, dtype, shape, on_card = meta
    if not body.nbytes:                     # an empty array or tensor
        if kind == "numpy":
            return np.empty(shape, dtype=dtype)
        import torch
        dev = (torch.device("cuda", torch.cuda.current_device())
               if on_card else "cpu")
        return torch.empty(shape, dtype=getattr(torch, dtype), device=dev)
    if not owned and not on_card:
        body = np.array(body)                          # own the bytes
    if kind == "numpy":
        return body.view(dtype).reshape(shape)
    import torch
    tdtype = getattr(torch, dtype)
    if not on_card:
        return torch.from_numpy(body).view(tdtype).reshape(shape)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a channel delivered a CUDA tensor to a process that sees no "
            "card")
    dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(shape, dtype=tdtype, device=dev)
    out.reshape(-1).view(torch.uint8).copy_(torch.from_numpy(body))
    # the copy has finished before the caller acks (frees) the slot
    torch.cuda.current_stream(dev).synchronize()
    return out


class ChannelClosed(Exception):
    pass


class ChannelTimeout(Exception):
    pass


def _ring_depth(depth: Optional[int]) -> int:
    if depth is None:
        from ray_tpu_torch._private.config import CONFIG
        depth = int(CONFIG.channel_ring_depth)
    return max(1, int(depth))


def _wait(predicate, timeout: Optional[float], what: str):
    deadline = None if timeout is None else time.monotonic() + timeout
    spins = 0
    sleep = 20e-6
    while True:
        if predicate():
            return
        spins += 1
        if spins < 200:
            continue                   # hot spin for µs-scale waits
        if deadline is not None and time.monotonic() > deadline:
            raise ChannelTimeout(f"timed out waiting for {what}")
        # progressive backoff: an idle exec loop parked between
        # executes settles at ~1ms polls instead of burning a core
        time.sleep(sleep)
        sleep = min(sleep * 1.5, 1e-3)


def _wait_words(ch: "Channel", offset: int, count: int, value: int,
                timeout: Optional[float], what: str) -> None:
    """Wait until the `count` u64 header words at `offset` are all
    >= value. Native path (ray_tpu_torch/native/core.c) spins with the GIL
    RELEASED — the Python fallback holds the GIL between checks, which
    on few-core hosts starves the very peer being waited on."""
    from ray_tpu_torch import native
    if native.available():
        # ≤100ms native slices: the C spin releases the GIL but also
        # blocks Python signal delivery — slicing keeps Ctrl-C (and
        # teardown exceptions) responsive even on timeout=None waits
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        mv = ch._map()
        while True:
            if deadline is None:
                chunk = 0.1
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ChannelTimeout(
                        f"timed out waiting for {what}")
                chunk = min(remaining, 0.1)
            if native.wait_u64s_ge(mv, offset, count, value, chunk):
                return
        # not reached
    _wait(lambda: all(ch._u64(offset + 8 * i) >= value
                      for i in range(count)), timeout, what)


class Channel:
    """Descriptor + mapping for one channel. Create once (driver side),
    then hand to exactly one writer and `n_readers` readers (each with a
    distinct reader_index)."""

    transport = "shm"

    def __init__(self, name: str, capacity: int, n_readers: int,
                 depth: int = 1, label: str = ""):
        self.name = name
        self.capacity = capacity
        self.n_readers = n_readers
        self.depth = max(1, int(depth))
        self.label = label or name[-6:]
        self._mv: Optional[memoryview] = None

    @classmethod
    def create(cls, capacity: int = 1 << 20, n_readers: int = 1,
               depth: Optional[int] = None, label: str = "") -> "Channel":
        from ray_tpu_torch._private.specs import SESSION_TAG
        depth = _ring_depth(depth)
        name = f"rtt_{SESSION_TAG}_ch_{uuid.uuid4().hex[:12]}"
        header = 32 + 8 * n_readers + 8 * depth
        buf = bytearray(header + depth * capacity)
        struct.pack_into("<QQQQ", buf, 0, _MAGIC, n_readers, 0, depth)
        ch = cls(name, capacity, n_readers, depth, label)
        _create_segment(name, memoryview(bytes(buf)))
        return ch

    # ------------------------------------------------------- low level
    def _map(self) -> memoryview:
        if self._mv is None:
            header = 32 + 8 * self.n_readers + 8 * self.depth
            self._mv = _map_segment(
                self.name, header + self.depth * self.capacity)
            magic, n, _, d = struct.unpack_from("<QQQQ", self._mv, 0)
            if magic != _MAGIC or n != self.n_readers or d != self.depth:
                raise ValueError(f"bad channel segment {self.name}")
        return self._mv

    def _u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self._map(), off)[0]

    def _set_u64(self, off: int, val: int) -> None:
        struct.pack_into("<Q", self._map(), off, val)

    def _len_off(self, slot: int) -> int:
        return 32 + 8 * self.n_readers + 8 * slot

    def _slot_off(self, slot: int) -> int:
        return (32 + 8 * self.n_readers + 8 * self.depth
                + slot * self.capacity)

    # ------------------------------------------------------- endpoints
    def writer(self) -> "ChannelWriter":
        return ChannelWriter(self)

    def reader(self, reader_index: int) -> "ChannelReader":
        return ChannelReader(self, reader_index)

    def destroy(self) -> None:
        self._mv = None
        unlink_segment(self.name)

    def __reduce__(self):
        return (Channel, (self.name, self.capacity, self.n_readers,
                          self.depth, self.label))


class ChannelWriter:
    def __init__(self, channel: Channel):
        self.ch = channel
        self._seq = channel._u64(16)

    def _acquire_slot(self, timeout: Optional[float]) -> int:
        """Wait until message self._seq+1's ring slot is consumable and
        return its index: every reader must have acked the message that
        last occupied it (s - depth). With depth > 1 the writer runs
        ahead of its readers — double buffering, the transfer/compute
        overlap the MPMD pipeline schedules depend on."""
        ch = self.ch
        s = self._seq + 1
        if s > ch.depth:
            with _tp.span("channel", f"ch.wait:{ch.label}",
                          extra={"seq": s}):
                _wait_words(ch, 32, ch.n_readers, s - ch.depth, timeout,
                            "readers to free a ring slot")
        return (s - 1) % ch.depth

    def _publish(self, slot: int, len_word: int) -> None:
        ch = self.ch
        ch._set_u64(ch._len_off(slot), len_word)
        self._seq += 1
        ch._set_u64(16, self._seq)     # publish

    def write_bytes(self, data: bytes, *, error: bool = False,
                    timeout: Optional[float] = None) -> None:
        ch = self.ch
        if len(data) > ch.capacity:
            raise ValueError(
                f"message of {len(data)} bytes exceeds channel capacity "
                f"{ch.capacity}; recompile with a larger "
                f"buffer_size_bytes")
        slot = self._acquire_slot(timeout)
        with _tp.span("channel", f"ch.write:{ch.label}",
                      extra={"bytes": len(data)}):
            mv = ch._map()
            off = ch._slot_off(slot)
            mv[off:off + len(data)] = data
            self._publish(slot,
                          len(data) | (_ERROR_FLAG if error else 0))

    def write(self, value: Any, **kw) -> None:
        payload = _array_payload(value)
        if payload is not None:
            self._write_array(payload[0], payload[1], **kw)
        else:
            self.write_bytes(
                cloudpickle.dumps(value,
                                  protocol=pickle.HIGHEST_PROTOCOL),
                **kw)

    def _write_array(self, meta: bytes, arr,
                     timeout: Optional[float] = None) -> None:
        """Raw-array frame: one memcpy into the mapped slot."""
        import numpy as np
        ch = self.ch
        nbytes = arr.nbytes
        total = 4 + len(meta) + nbytes
        if total > ch.capacity:
            raise ValueError(
                f"array of {nbytes} bytes exceeds channel capacity "
                f"{ch.capacity}; recompile with a larger "
                f"buffer_size_bytes")
        slot = self._acquire_slot(timeout)
        with _tp.span("channel", f"ch.write:{ch.label}",
                      extra={"bytes": nbytes}):
            mv = ch._map()
            off = ch._slot_off(slot)
            struct.pack_into("<I", mv, off, len(meta))
            mv[off + 4:off + 4 + len(meta)] = meta
            if nbytes:
                _copy_into(np.frombuffer(
                    mv[off + 4 + len(meta):off + total], dtype=np.uint8),
                    arr)
            self._publish(slot, total | _RAW_FLAG)

    def close(self, timeout: float = 5.0) -> None:
        """Publish the closed marker (readers raise ChannelClosed once
        they reach it — messages already in the ring drain first)."""
        ch = self.ch
        try:
            slot = self._acquire_slot(timeout)
        except ChannelTimeout:
            # A ring slot hasn't freed up: a reader is wedged or gone.
            # Stomping an unconsumed slot would silently drop data;
            # leave the ring intact — stuck readers are handled by
            # teardown.
            return
        self._publish(slot, _CLOSED_LEN)

    def release(self) -> None:
        """Transport-symmetric resource hook (wire channels shut their
        server down here); shm writers hold nothing beyond the mapping."""


class ChannelReader:
    def __init__(self, channel: Channel, reader_index: int):
        if not 0 <= reader_index < channel.n_readers:
            raise ValueError("reader_index out of range")
        self.ch = channel
        self.idx = reader_index
        # messages are numbered from seq 1; a reader may attach after
        # the writer published up to `depth` messages (exec loops start
        # async), and the writer's ack gate guarantees no slot can be
        # overwritten before every reader consumed it — so always start
        # at 1
        self._expect = 1

    def read_bytes(self, timeout: Optional[float] = None) -> bytes:
        ch = self.ch
        _wait_words(ch, 16, 1, self._expect, timeout, "message")
        length = ch._u64(ch._len_off((self._expect - 1) % ch.depth))
        if length != _CLOSED_LEN and (length & _RAW_FLAG):
            # refuse BEFORE consuming: the frame stays readable via
            # read() (decoding here would ack + advance destructively)
            raise RuntimeError(
                "read_bytes on a raw-array frame; use read()")
        data, _ = self._read_frame(timeout)
        return data

    def _read_frame(self, timeout: Optional[float]):
        ch = self.ch
        with _tp.span("channel", f"ch.read:{ch.label}",
                      extra={"seq": self._expect}):
            _wait_words(ch, 16, 1, self._expect, timeout, "message")
            slot = (self._expect - 1) % ch.depth
            length = ch._u64(ch._len_off(slot))
            if length == _CLOSED_LEN:
                raise ChannelClosed(ch.name)
            error = bool(length & _ERROR_FLAG)
            raw = bool(length & _RAW_FLAG)
            length &= _LEN_MASK
            off = ch._slot_off(slot)
            if raw:
                value = self._decode_array(length, off)
                ch._set_u64(32 + 8 * self.idx, self._expect)   # ack
                self._expect += 1
                return value, True
            data = bytes(ch._map()[off:off + length])
            ch._set_u64(32 + 8 * self.idx, self._expect)   # ack
            self._expect += 1
        if error:
            raise RuntimeError(
                f"upstream DAG node failed: {pickle.loads(data)}")
        return data, False

    def _decode_array(self, length: int, off: int):
        """Consume a raw-array frame. The copy out (onto the card for a
        tensor that left one) reads STRAIGHT from the mapped slot; the
        slot is only acked — and thus reusable by the writer — after the
        copy completes."""
        import numpy as np
        mv = self.ch._map()
        (meta_len,) = struct.unpack_from("<I", mv, off)
        meta = pickle.loads(bytes(mv[off + 4:off + 4 + meta_len]))
        body = np.frombuffer(mv[off + 4 + meta_len:off + length],
                             dtype=np.uint8)
        return _decode_payload(meta, body)

    def read(self, timeout: Optional[float] = None) -> Any:
        data, raw = self._read_frame(timeout)
        if raw:
            return data
        return pickle.loads(data)

    def release(self) -> None:
        """Transport-symmetric resource hook (wire readers close their
        connection here); shm readers hold nothing beyond the mapping."""
