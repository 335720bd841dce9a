"""The port's single-host runtime beside the JAX package's.

Both runtimes can be alive in one process (an xdist worker runs a JAX
test file and then a port one, and `tests/conftest.py` keeps the JAX
runtime up until the session ends), so neither may share a
process-wide name with the other: each has its own session variable,
shm prefix and native library, and shutting one down leaves the other's
objects and segments alone. Also here: the GPU resource (0 on a host
with no card, where a `num_gpus` request stays infeasible), how
`CUDA_VISIBLE_DEVICES` is read, and the slice as a whole: a CPU actor of
the port runs `tiny()` and its logits match the JAX `Transformer.apply`
on the same weights.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import specs as jspecs
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu_torch._private import specs
from ray_tpu_torch._private.runtime import _visible_gpus, detect_num_gpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def port():
    yield ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)


def _segments(prefix):
    return {n for n in os.listdir("/dev/shm") if n.startswith(prefix)}


def test_session_tags_and_variables_are_the_ports_own():
    assert specs.SESSION_TAG != jspecs.SESSION_TAG
    assert os.environ["RAY_TPU_TORCH_SESSION"] == specs.SESSION_TAG
    assert os.environ["RAY_TPU_SESSION"] == jspecs.SESSION_TAG
    # a port process started under a JAX runtime's tag makes its own
    out = subprocess.run(
        [sys.executable, "-c", "from ray_tpu_torch._private import specs;"
         " print(specs.SESSION_TAG)"],
        env={**os.environ, "RAY_TPU_SESSION": "abc123",
             "RAY_TPU_TORCH_SESSION": "", "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() not in ("", "abc123")


def test_shutting_one_runtime_down_leaves_the_others_objects():
    """Each runtime's `put` objects stay readable, and their shm
    segments stay in /dev/shm, when the other runtime shuts down."""
    a = np.arange(1 << 16, dtype=np.float64)      # 512 KiB: a shm segment
    jprefix = f"rtpu_{jspecs.SESSION_TAG}_"
    pprefix = f"rtt_{specs.SESSION_TAG}_"
    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    jref = ray_tpu.put(a)
    pref = ray_tpu_torch.put(2 * a)
    jsegs = _segments(jprefix)
    assert jsegs and _segments(pprefix)
    ray_tpu_torch.shutdown()
    assert jsegs <= _segments(jprefix)
    np.testing.assert_array_equal(ray_tpu.get(jref), a)

    ray_tpu_torch.init(num_cpus=2)
    pref = ray_tpu_torch.put(3 * a)
    psegs = _segments(pprefix)
    assert psegs
    ray_tpu.shutdown()
    assert psegs <= _segments(pprefix)
    np.testing.assert_array_equal(ray_tpu_torch.get(pref), 3 * a)

    @ray_tpu_torch.remote
    def total(x):
        return float(x.sum())
    assert ray_tpu_torch.get(total.remote(pref)) == float(3 * a.sum())
    del pref
    ray_tpu_torch.shutdown()
    assert not _segments(pprefix)


def test_num_gpus_beyond_the_cards_stays_infeasible(port):
    """The head's GPU resource is the card count (0 here, where a
    num_gpus=1 request is never quietly placed on the CPU)."""
    cards = torch.cuda.device_count()
    assert detect_num_gpus() == cards
    assert ray_tpu_torch.cluster_resources()["GPU"] == cards

    @ray_tpu_torch.remote(num_gpus=cards + 1)
    def needs_a_card():
        return "ran"
    ref = needs_a_card.remote()
    ready, pending = ray_tpu_torch.wait([ref], timeout=2)
    assert ready == [] and pending == [ref]
    ray_tpu_torch.cancel(ref)


def test_a_stalled_driver_keeps_its_head_node_alive(port):
    """The head node's scheduler runs in the driver, which also sweeps
    liveness: when the driver stalls past `heartbeat_timeout_s` (a
    5.7 GB checkpoint copied under the GIL), the head's heartbeat is
    stale, and the sweep declared the head dead, killing every worker
    on it and leaving no node for a placement group (ROADMAP queue 3,
    item 9). Holding the head scheduler's lock keeps its loop from
    heartbeating while the sweep runs."""
    from ray_tpu_torch._private import context
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    cluster = context.get_ctx().cluster
    head = next(n for n in cluster.alive_nodes() if n.is_head)
    with head.scheduler._cv:
        head.last_heartbeat -= 60.0           # a minute without a beat
        cluster._sweep_liveness()
    assert head.alive
    assert cluster.liveness_counters["deaths"] == 0
    pg = placement_group([{"CPU": 1.0}])
    try:
        assert pg.wait(timeout_seconds=30)
    finally:
        remove_placement_group(pg)


@pytest.mark.parametrize("var, devices, uuids, visible", [
    ("", 2, [], 0),
    ("0", 2, [], 1),
    ("1,0", 2, [], 2),
    ("0,2,1", 2, [], 1),          # stops at the first device not there
    ("-1", 2, [], 0),
    ("0,0", 2, [], 0),            # a repeated device hides every device
    (" 1 ", 2, [], 1),
    ("GPU-ab", 2, ["GPU-abcd", "GPU-ef01"], 1),
    ("GPU-ef01,GPU-abcd", 2, ["GPU-abcd", "GPU-ef01"], 2),
    ("GPU-zz", 2, ["GPU-abcd", "GPU-ef01"], 0),
])
def test_cuda_visible_devices_is_read_as_cuda_reads_it(var, devices, uuids,
                                                        visible):
    assert _visible_gpus(var, devices, uuids) == visible


@ray_tpu_torch.remote
class TinyServer:
    """A CPU actor that holds the port's `tiny()` model."""

    def __init__(self, tree):
        from ray_tpu_torch.models.config import tiny
        from ray_tpu_torch.models.convert import params_from_jax
        from ray_tpu_torch.models.transformer import Transformer
        self.model = Transformer(tiny())
        self.params = params_from_jax(tree, tiny(), device="cpu")

    def apply(self, tokens):
        import torch
        with torch.no_grad():
            return self.model.apply(
                self.params, torch.from_numpy(tokens).long()).numpy()


def test_a_cpu_actor_runs_tiny_and_matches_jax(port):
    """The slice as a whole: weights made from numpy seed 0 in the JAX
    parameter tree's shapes go to a port actor (through the object
    plane) and to the JAX model; the actor's `Transformer.apply` logits
    match the JAX ones in f32 to the models' stated 1e-4."""
    jmodel = JTransformer(jtiny())
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)
    toks = rng.integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                   jnp.asarray(toks)))
    # the caller holds `weights` until the actor has them: a constructor
    # argument is not pinned (ROADMAP.md, queue 3, item 6)
    weights = ray_tpu_torch.put(tree)
    server = TinyServer.remote(weights)
    got = ray_tpu_torch.get(server.apply.remote(toks), timeout=30)
    assert got.dtype == np.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got, want, atol=1e-4)
    ray_tpu_torch.kill(server)
