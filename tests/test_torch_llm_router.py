"""The port's LLM router (`serve/llm/router.py`): mid-stream failover.

Two CPU replicas of `serve_llm` on the same weights; the replica serving
a stream is killed in the middle of it. The `TokenStream` must fail over
to the survivor, which re-prefills the prompt and every token already
consumed under a bumped attempt, and the consumer must see exactly the
tokens of an uninterrupted run: none repeated, none lost. The JAX suite
has no test of this path.

The runtime fixtures are this file's own; the port's runtime is shut
down when the module ends.
"""
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.serve import llm
from ray_tpu_torch.serve.llm.engine import EngineCore


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def serve_shutdown():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    serve.shutdown()


def _uninterrupted(params, prompt, max_tokens):
    core = EngineCore(tiny(), params, device="cpu", num_pages=64,
                      page_size=8, max_batch=4)
    core.submit(prompt, max_tokens=max_tokens, rid="r")
    out = []
    while core.has_work:
        out += [ev["token"] for ev in core.step() if ev["token"] is not None]
    return out


@pytest.mark.parametrize("push", [True, False], ids=["push", "polled"])
def test_stream_fails_over_mid_generation_exactly_once(serve_shutdown,
                                                       monkeypatch, push):
    from ray_tpu_torch._private.config import CONFIG
    monkeypatch.setenv("RAY_TPU_LLM_STREAM", "1" if push else "0")
    CONFIG.reload()
    params = Transformer(tiny()).init(3, "cpu")
    prompt, max_tokens = [7, 1, 9, 4, 4, 2], 32
    # a paced step loop keeps the generation running while it is killed
    handle = llm.serve_llm(
        name="failover", model="tiny", weights=params, num_replicas=2,
        device="cpu", num_pages=64, page_size=8, max_batch=4,
        ray_actor_options={"runtime_env": {"env_vars": {
            "RAY_TPU_LLM_STEP_DELAY_S": "0.03"}}})
    try:
        stream = handle.generate(prompt, max_tokens=max_tokens,
                                 timeout_s=30)
        first = [next(stream) for _ in range(8)]
        victim = stream._replica
        ray_tpu_torch.kill(victim)
        rest = list(stream)
    finally:
        monkeypatch.undo()
        CONFIG.reload()
    assert stream._failovers >= 1
    assert stream._replica._actor_id != victim._actor_id
    assert first + rest == _uninterrupted(params, prompt, max_tokens)
    assert stream.emitted == first + rest
    assert stream.finish_reason == "length"
