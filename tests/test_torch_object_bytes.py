"""Large `bytes` travel out of band (ROADMAP queue 3): a `bytes` object
over `wire_max_frame_bytes` used to be pickled in band into one frame,
and the end that read the frame killed the connection.

The frame limit is set to 8 MiB here (1 GiB by default) and each route
carries 24 MiB: `put`, a task's return value, a task's argument, and an
actor method's argument and result; the same again with the bytes inside
a dict (nested bytes went in band until they were wrapped too). The JAX
package keeps the fault (`ray_tpu/_private/object_store.py:417`).
"""
import hashlib
import os

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import object_store as osm
from ray_tpu_torch._private.config import CONFIG

FRAME_LIMIT = 8 << 20
BLOB_BYTES = 24 << 20


def _blob() -> bytes:
    return hashlib.sha256(b"seed").digest() * (BLOB_BYTES // 32)


@pytest.fixture(scope="module")
def small_frames():
    """The port's runtime, workers included, with 8 MiB frames."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    prev = os.environ.get("RAY_TPU_WIRE_MAX_FRAME_BYTES")
    os.environ["RAY_TPU_WIRE_MAX_FRAME_BYTES"] = str(FRAME_LIMIT)
    CONFIG.reload()
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        if prev is None:
            os.environ.pop("RAY_TPU_WIRE_MAX_FRAME_BYTES", None)
        else:
            os.environ["RAY_TPU_WIRE_MAX_FRAME_BYTES"] = prev
        CONFIG.reload()


@ray_tpu_torch.remote
def _digest(data):
    return type(data).__name__, hashlib.sha256(data).hexdigest()


@ray_tpu_torch.remote
def _digest_of_ref(refs):
    data = ray_tpu_torch.get(refs[0])
    return type(data).__name__, hashlib.sha256(data).hexdigest()


@ray_tpu_torch.remote
def _make_blob():
    import hashlib as _hashlib
    return _hashlib.sha256(b"seed").digest() * ((24 << 20) // 32)


@ray_tpu_torch.remote
def _make_nested():
    import hashlib as _hashlib
    return {"step": 3, "parts": [_hashlib.sha256(b"seed").digest()
                                 * ((24 << 20) // 32)]}


@ray_tpu_torch.remote
def _digest_of_nested_ref(refs):
    data = ray_tpu_torch.get(refs[0])
    return hashlib.sha256(data["parts"][0]).hexdigest()


def _nested() -> dict:
    return {"step": 3, "parts": [_blob()]}


@ray_tpu_torch.remote
class _Echo:
    def echo(self, data):
        return data


@pytest.mark.parametrize("kind", [bytes, bytearray])
def test_serialize_carries_large_bytes_out_of_band(kind):
    """The value itself goes out of band as one shm segment and comes
    back equal, of its own type; a small one stays inline."""
    blob = kind(_blob())
    obj = osm.serialize(blob)
    try:
        assert obj.buffer_order == ["s"]
        assert len(obj.payload) < 1024
        back = osm.deserialize(obj)
        assert type(back) is kind and back == blob
    finally:
        for name in obj.shm_names:
            osm.unlink_segment(name)
    small = osm.serialize(kind(b"x" * 100))
    assert small.shm_names == [] and osm.deserialize(small) == kind(
        b"x" * 100)


def test_put_over_the_frame_limit(small_frames):
    blob = _blob()
    ref = ray_tpu_torch.put(blob)
    assert ray_tpu_torch.get(ref) == blob
    # a worker resolves the same ref (its GET reply crosses the wire)
    assert ray_tpu_torch.get(_digest_of_ref.remote([ref]), timeout=60) == (
        "bytes", hashlib.sha256(blob).hexdigest())


def test_task_result_over_the_frame_limit(small_frames):
    assert ray_tpu_torch.get(_make_blob.remote(), timeout=60) == _blob()


def test_task_argument_over_the_frame_limit(small_frames):
    blob = _blob()
    assert ray_tpu_torch.get(_digest.remote(blob), timeout=60) == (
        "bytes", hashlib.sha256(blob).hexdigest())


@pytest.mark.parametrize("kind", [bytes, bytearray])
def test_actor_call_over_the_frame_limit(small_frames, kind):
    blob = kind(_blob())
    echo = _Echo.remote()
    try:
        back = ray_tpu_torch.get(echo.echo.remote(blob), timeout=60)
        assert type(back) is kind and back == blob
    finally:
        ray_tpu_torch.kill(echo)


def test_serialize_carries_nested_bytes_out_of_band():
    """Bytes inside a dict (in a list) go out of band as one segment; the
    container comes back equal, and a value holding no large bytes is
    pickled as it is, not copied."""
    value = _nested()
    obj = osm.serialize(value)
    try:
        assert obj.buffer_order == ["s"]
        assert len(obj.payload) < 1024
        assert osm.deserialize(obj) == value
    finally:
        for name in obj.shm_names:
            osm.unlink_segment(name)
    small = {"a": [b"x" * 100, (1, 2)]}
    assert osm.bytes_out_of_band(small, 1 << 10) is small


@pytest.mark.parametrize("big", [False, True])
def test_the_walk_keeps_nothing_alive(big):
    """What `bytes_out_of_band` walked dies with its last reference, with
    the cyclic GC off: its memo once lived in a cycle until the GC ran,
    and with it every ObjectRef a task's argument list held (ROADMAP
    queue 3, item 19)."""
    import gc
    import weakref

    class Item:
        pass

    item = Item()
    alive = weakref.ref(item)
    value = {"a": [item, b"x" * (2048 if big else 16)], "b": (item,)}
    was = gc.isenabled()
    gc.disable()
    try:
        osm.bytes_out_of_band(value, 1 << 10)
        del value, item
        assert alive() is None
    finally:
        if was:
            gc.enable()


def test_put_of_nested_bytes_over_the_frame_limit(small_frames):
    value = _nested()
    ref = ray_tpu_torch.put(value)
    assert ray_tpu_torch.get(ref) == value
    # a worker resolves the same ref (its GET reply crosses the wire)
    assert ray_tpu_torch.get(_digest_of_nested_ref.remote([ref]),
                             timeout=60) == hashlib.sha256(_blob()).hexdigest()


def test_task_result_of_nested_bytes_over_the_frame_limit(small_frames):
    assert ray_tpu_torch.get(_make_nested.remote(), timeout=60) == _nested()


def test_actor_argument_of_nested_bytes_over_the_frame_limit(small_frames):
    value = _nested()
    echo = _Echo.remote()
    try:
        assert ray_tpu_torch.get(echo.echo.remote(value),
                                 timeout=60) == value
    finally:
        ray_tpu_torch.kill(echo)
