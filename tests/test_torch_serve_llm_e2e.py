"""`serve_llm` on the port, end to end on the CPU, against the JAX package.

The JAX package makes `tiny()` weights from a seed; `params_from_jax`
carries them across and `put` stores them, each tensor out of band. The
port's `serve_llm` deploys an `LLMEngine` replica from that ObjectRef
through the Serve controller, and its greedy tokens must equal the JAX
`EngineCore`'s on the same weights exactly. Also here: the twin of
`tests/test_serve_llm.py::test_llm_e2e_two_replicas_short_finishes_first`
(slow there, where each replica compiles; ~5 s here).

The runtime fixtures are this file's own; the port's runtime is shut
down when the module ends.
"""
import threading
import time

import jax
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.serve.llm.engine import EngineCore as JEngineCore
from ray_tpu_torch import serve
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve import llm

PROMPTS = {"a": ([1, 2, 3, 4, 5, 6, 7], 9),
           "b": (list(range(30, 52)), 5),
           "c": ([200], 7)}


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


@pytest.fixture()
def serve_shutdown(ray_cluster):
    yield
    serve.shutdown()


@pytest.fixture(scope="module")
def weights():
    jparams = JTransformer(jtiny()).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             tiny(), device="cpu")
    return jparams, params


def _consume(streams):
    """Each TokenStream drained on its own thread; returns the tokens
    and the time each finished, by name."""
    tokens, done_at = {}, {}

    def run(name, s):
        tokens[name] = s.tokens()
        done_at[name] = time.monotonic()

    threads = [threading.Thread(target=run, args=item)
               for item in streams.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return tokens, done_at


def test_serve_llm_from_a_weights_ref_matches_jax_engine(serve_shutdown,
                                                         weights):
    """The greedy tokens of a replica built from a weights ObjectRef
    equal the JAX EngineCore's on the same weights, exactly. The ref is
    dropped once deployed: the controller keeps it for the replicas."""
    jparams, params = weights
    ref = ray_tpu_torch.put(params)
    handle = llm.serve_llm(name="parity", model="tiny", weights=ref,
                           num_replicas=1, device="cpu", num_pages=64,
                           page_size=8, max_batch=4)
    del ref
    streams = {rid: handle.generate(p, max_tokens=n, timeout_s=60)
               for rid, (p, n) in PROMPTS.items()}
    got, _ = _consume(streams)

    core = JEngineCore(jtiny(), jparams, num_pages=64, page_size=8,
                       max_batch=4)
    for rid, (p, n) in PROMPTS.items():
        core.submit(p, max_tokens=n, rid=rid)
    want = {}
    while core.has_work:
        for ev in core.step():
            if ev["token"] is not None:
                want.setdefault(ev["rid"], []).append(ev["token"])
    assert got == want
    assert all(len(got[rid]) == n for rid, (_, n) in PROMPTS.items())
    (st,) = handle.stats()
    assert st["finished"] == len(PROMPTS) and st["free_pages"] == 64
    # the CPU path launches no kernel; the counts are this replica's own
    assert st["kernel_launches"] == {"flash_fwd": 0, "rms_norm": 0,
                                     "paged_decode": 0}


def test_llm_e2e_two_replicas_short_finishes_first(serve_shutdown):
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch.serve.llm.stream import STREAM_STATS
    handle = llm.serve_llm(name="llm-e2e", model="tiny", num_replicas=2,
                           device="cpu", num_pages=64, page_size=8,
                           max_batch=4)
    t_in0 = STREAM_STATS["tokens_in"]
    long_s = handle.generate([1, 2, 3, 4], max_tokens=48, timeout_s=120)
    short_s = handle.generate([5, 6, 7, 8], max_tokens=4, timeout_s=120)
    results, done_at = _consume({"long": long_s, "short": short_s})
    assert len(results["short"]) == 4
    assert len(results["long"]) == 48
    assert done_at["short"] < done_at["long"]
    # push transport actually carried the tokens (no polling)
    if CONFIG.llm_stream:
        assert STREAM_STATS["tokens_in"] - t_in0 >= 52
    assert len(handle.stats()) >= 2     # one engine_stats per replica

    # polled fallback: same request plane, no push subscription
    import os
    os.environ["RAY_TPU_LLM_STREAM"] = "0"
    CONFIG.reload()
    try:
        s = handle.generate([9, 9, 9], max_tokens=3, timeout_s=120)
        assert len(s.tokens()) == 3
    finally:
        os.environ.pop("RAY_TPU_LLM_STREAM", None)
        CONFIG.reload()
