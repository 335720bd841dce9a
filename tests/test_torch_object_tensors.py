"""Torch tensors in the port's object plane.

`object_store.serialize` pickles a tensor as its dtype, shape and one
out-of-band buffer of its bytes, as it does a numpy array, so a large
tensor travels through one shared-memory segment and bf16 (which numpy
cannot hold) makes the round trip. The object plane looks torch up and
never imports it: a process that has not loaded torch (the Serve
controller's worker) stays without it.

The runtime fixtures are this file's own; the port's runtime is shut
down when the module ends.
"""
import os
import subprocess
import sys

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import object_store
from ray_tpu_torch._private.config import CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)


def _segments(ref):
    from ray_tpu_torch._private.specs import SESSION_TAG
    prefix = f"rtt_{SESSION_TAG}_{ref.object_id}_"
    return sorted(n for n in os.listdir("/dev/shm") if n.startswith(prefix))


def _same(a, b):
    return (type(b) is torch.Tensor and a.dtype == b.dtype
            and a.shape == b.shape and torch.equal(a, b))


def test_bf16_tensor_round_trips_exactly(ray_cluster):
    g = torch.Generator().manual_seed(0)
    t = torch.randn(3, 17, 5, generator=g).to(torch.bfloat16)
    assert _same(t, ray_tpu_torch.get(ray_tpu_torch.put(t)))


def test_non_contiguous_and_odd_tensors_round_trip(ray_cluster):
    g = torch.Generator().manual_seed(1)
    base = torch.randn(40, 30, generator=g)
    cases = [base[:, ::3], base.t(), base[5:9, 2],
             torch.tensor(2.5, dtype=torch.float64),     # 0-d
             torch.empty(0, 7, dtype=torch.bfloat16),    # no bytes
             torch.arange(12, dtype=torch.int32).view(3, 4)[:, 1:],
             torch.tensor([True, False, True]),
             torch.randn(4, 2, generator=g, dtype=torch.complex64).conj()]
    for t in cases:
        back = ray_tpu_torch.get(ray_tpu_torch.put(t))
        assert _same(t, back), t
    grad = torch.ones(3, requires_grad=True)
    assert ray_tpu_torch.get(ray_tpu_torch.put(grad)).requires_grad


def test_dict_of_tensors_goes_out_of_band(ray_cluster):
    """Every tensor of at least inline_threshold_bytes gets its own
    `rtt_` shm segment; smaller ones ride in band; all come back exact,
    also in a task on another process."""
    n = CONFIG.inline_threshold_bytes
    g = torch.Generator().manual_seed(2)
    params = {"w": torch.randn(n // 2, generator=g).to(torch.bfloat16),
              "big": torch.randn(n // 4 + 3, generator=g),
              "norm": torch.randn(64, generator=g),
              "layers": [{"wq": torch.randn(n // 8, 2, generator=g,
                                            dtype=torch.float64)}]}
    ref = ray_tpu_torch.put(params)
    assert len(_segments(ref)) == 3
    back = ray_tpu_torch.get(ref)
    assert back.keys() == params.keys()
    for k in ("w", "big", "norm"):
        assert _same(params[k], back[k]), k
    assert _same(params["layers"][0]["wq"], back["layers"][0]["wq"])

    @ray_tpu_torch.remote
    def digest(p):
        return {k: (str(v.dtype), tuple(v.shape), v.double().sum().item())
                for k, v in p.items() if k != "layers"}
    want = {k: (str(v.dtype), tuple(v.shape), v.double().sum().item())
            for k, v in params.items() if k != "layers"}
    assert ray_tpu_torch.get(digest.remote(ref), timeout=60) == want


def test_serialized_tensor_payload_holds_no_bytes():
    """The pickle itself carries only dtype and shape: a 4 MiB tensor's
    bytes are the one out-of-band buffer, as a numpy array's are."""
    t = torch.zeros(1 << 21, dtype=torch.bfloat16)
    obj = object_store.serialize({"w": t}, create_shm=False)
    assert len(obj.payload) < 1024
    assert [len(b) for b in obj.inline_buffers] == [t.numel() * 2]
    assert _same(t, object_store.deserialize(obj)["w"])


def test_serve_and_numpy_objects_load_no_torch():
    """`import ray_tpu_torch.serve` and a numpy put/get through the
    runtime load no torch (the Serve controller's worker must not)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, numpy as np\n"
            "import ray_tpu_torch, ray_tpu_torch.serve\n"
            "ray_tpu_torch.init(num_cpus=1)\n"
            "a = np.arange(1 << 18)\n"
            "assert (ray_tpu_torch.get(ray_tpu_torch.put(a)) == a).all()\n"
            "ray_tpu_torch.shutdown()\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m == 'torch' or m.startswith('torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
