"""The port's native core (`ray_tpu_torch/native/core.c`): the twin of
`tests/test_native.py`. GIL-free waits, CRC32C and the GIL-released
bulk copy, built on demand with the host compiler into
`build/ray_tpu_torch/` under the port's own file name, ctypes-bound,
with pure-Python fallbacks everywhere they are used.

The JAX test's third case drives the shm channel
(`ray_tpu/experimental/channel.py`), which the port has not taken yet;
its twin drives the port's native user on this slice's path, the
object store's bulk copy, through a shm segment on the native path and
on the fallback."""
import mmap
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason="no C compiler on this host (pure-Python fallbacks active)")


def test_crc32c_matches_python_reference():
    from ray_tpu.data.datasource import _crc32c as py_crc
    assert native.crc32c(b"123456789") == 0xE3069283   # known answer
    for blob in (b"", b"\x00", bytes(range(256)) * 33,
                 b"tfrecord" * 1000):
        assert native.crc32c(blob) == py_crc(blob)
        py_masked = (((py_crc(blob) >> 15) | (py_crc(blob) << 17))
                     + 0xA282EAD8) & 0xFFFFFFFF
        assert native.masked_crc32c(blob) == py_masked
    # the port's library is its own: another file than the JAX
    # package's, under build/ray_tpu_torch/
    path = native._load()._name
    assert os.path.basename(path).startswith("native_core_")
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "ray_tpu_torch")


def test_wait_u64s_ge_success_and_timeout():
    buf = mmap.mmap(-1, 4096)
    mv = memoryview(buf)
    struct.pack_into("<QQQ", mv, 0, 1, 1, 0)
    # word[2] lags: waiting on all three must block until it is set
    def flip():
        time.sleep(0.12)
        struct.pack_into("<Q", mv, 16, 9)

    threading.Thread(target=flip).start()
    t0 = time.perf_counter()
    assert native.wait_u64s_ge(mv, 0, 3, 1, 5.0)
    assert 0.08 < time.perf_counter() - t0 < 2.0
    # timeout path returns False and respects the deadline
    t0 = time.perf_counter()
    assert not native.wait_u64s_ge(mv, 0, 3, 10**9, 0.15)
    assert time.perf_counter() - t0 < 1.5


def test_shm_object_roundtrip_native_and_fallback(monkeypatch):
    """An object bigger than the native copy's 64 KiB floor goes into a
    shm segment and back identically through the native GIL-released
    memcpy and through the pure-Python slice assign."""
    from ray_tpu_torch._private import object_store as osm

    arr = np.random.default_rng(0).standard_normal(1 << 16)  # 512 KiB
    for force_fallback in (False, True):
        if force_fallback:
            monkeypatch.setattr(native, "available", lambda: False)
        copied = []
        real_copy = native.buf_copy
        monkeypatch.setattr(native, "buf_copy",
                            lambda *a: copied.append(1) or real_copy(*a))
        obj = osm.serialize(arr)
        try:
            assert obj.shm_names                 # it went through shm
            np.testing.assert_array_equal(osm.deserialize(obj), arr)
            assert bool(copied) is not force_fallback
        finally:
            for name in obj.shm_names:
                osm.unlink_segment(name)


def test_disable_env_forces_fallback(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c",
         "import ray_tpu_torch.native as n; print(n.available())"],
        env={"PATH": "/usr/bin:/bin", "RAY_TPU_DISABLE_NATIVE": "1",
             "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "False", out.stderr
