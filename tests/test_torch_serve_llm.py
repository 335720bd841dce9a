"""The port's continuous-batching EngineCore against the JAX package's.

Both engines run the same `tiny()` weights (made by the JAX package from
a seed, handed over with `params_from_jax`) on the CPU and must give the
same greedy tokens, admission order, evictions and page accounting. Also
here: the port's page allocator, its device rule, and the check that the
package imports neither JAX nor the JAX package.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.serve.llm.engine import EngineCore as JEngineCore
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve.llm.engine import (FINISH_LENGTH, FINISH_STOP,
                                            EngineCore, _bucket)
from ray_tpu_torch.serve.llm.kv_cache import (PageAllocator,
                                              pages_from_budget, pages_needed)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- kv cache
def test_page_allocator_alloc_free():
    a = PageAllocator(4)
    assert a.free_pages == 4
    got = a.alloc(3)
    assert got is not None and len(got) == 3
    assert a.free_pages == 1 and a.used_pages == 3
    # all-or-nothing: 2 > 1 free -> None, nothing consumed
    assert a.alloc(2) is None
    assert a.free_pages == 1
    a.free(got[:2])
    assert a.free_pages == 3
    with pytest.raises(ValueError):
        a.free(got[:1] + got[:1])       # double free in one call
    a2 = PageAllocator(2)
    p = a2.alloc(1)
    a2.free(p)
    with pytest.raises(ValueError):
        a2.free(p)                      # double free across calls
    with pytest.raises(ValueError):
        PageAllocator(0)
    with pytest.raises(ValueError):
        a.alloc(-1)


def test_pages_needed_and_budget():
    assert pages_needed(1, 16) == 1
    assert pages_needed(16, 16) == 1
    assert pages_needed(17, 16) == 2
    cfg = tiny()
    n1 = pages_from_budget(cfg, 16, 1 << 20)
    assert n1 >= 1
    # sharding the kv heads across tp shrinks the per-shard page, so
    # the same budget holds more pages
    n2 = pages_from_budget(cfg, 16, 1 << 20, tp_shards=2)
    assert n2 >= n1


def test_bucket_is_next_power_of_two():
    assert [_bucket(n) for n in (1, 16, 17, 300, 2900)] == \
        [16, 16, 32, 512, 4096]
    assert _bucket(5000, hi=4096) == 4096


# --------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jtiny(), tiny()
    jparams = JTransformer(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _engines(models, **kw):
    jcfg, jparams, cfg, params = models
    return (JEngineCore(jcfg, jparams, **kw),
            EngineCore(cfg, params, device="cpu", **kw))


def _drain(core, max_steps=200, inject=None):
    """Step until idle; `inject` maps a step index to a callback run
    before that step. Returns (finish order, events)."""
    order, events = [], []
    for i in range(max_steps):
        if inject and i in inject:
            inject[i](core)
        evs = core.step()
        events.extend(evs)
        order.extend((e["rid"], e["reason"]) for e in evs if e["done"])
        if not core.has_work and not (inject and max(inject) > i):
            break
    return order, events


def _tokens(events):
    out = {}
    for e in events:
        if e["token"] is not None:
            out.setdefault(e["rid"], []).append(e["token"])
    return out


def _comparable(stats):
    return {k: v for k, v in stats.items() if k != "queue_wait_p95"}


# ------------------------------------------------- parity with the JAX core
def test_concurrent_requests_match_jax_engine(models):
    """Several concurrent requests, one submitted mid-flight: the same
    greedy tokens, the same events and the same counters as JAX."""
    def submit_all(core):
        core.submit([1, 2, 3, 4, 5, 6, 7], max_tokens=9, rid="a")
        core.submit(list(range(30, 52)), max_tokens=5, rid="b")
        core.submit([200], max_tokens=7, rid="c")
    late = {2: lambda core: core.submit([9, 9, 8], max_tokens=4, rid="d")}
    results = []
    for core in _engines(models, num_pages=32, page_size=8, max_batch=3):
        submit_all(core)
        order, events = _drain(core, inject=late)
        results.append((order, events, _comparable(core.stats())))
    (jorder, jevents, jstats), (order, events, stats) = results
    assert events == jevents
    assert order == jorder
    assert stats == jstats and stats["free_pages"] == 32
    assert set(_tokens(events)) == {"a", "b", "c", "d"}


def test_eviction_matches_jax_engine(models):
    """Page exhaustion mid-decode evicts the youngest sequence; it
    re-prefills prompt+emitted and both engines emit the same tokens."""
    results = []
    for core in _engines(models, num_pages=4, page_size=4, max_batch=2):
        core.submit([1, 2, 3, 4], max_tokens=10, rid="a")
        core.submit([9, 8, 7, 6], max_tokens=10, rid="b")
        order, events = _drain(core, max_steps=400)
        results.append((order, _tokens(events), core.stats()))
    (jorder, jtoks, jstats), (order, toks, stats) = results
    assert stats["evictions"] >= 1 and stats["evictions"] == \
        jstats["evictions"]
    assert order == jorder and toks == jtoks
    assert stats["free_pages"] == 4


def test_eviction_preserves_uninterrupted_tokens(models):
    _, _, cfg, params = models
    ref = EngineCore(cfg, params, device="cpu", num_pages=32, page_size=4,
                     max_batch=2)
    ref.submit([9, 8, 7, 6], max_tokens=10, rid="b")
    want = _tokens(_drain(ref)[1])["b"]
    core = EngineCore(cfg, params, device="cpu", num_pages=4, page_size=4,
                      max_batch=2)
    core.submit([1, 2, 3, 4], max_tokens=10, rid="a")
    core.submit([9, 8, 7, 6], max_tokens=10, rid="b")
    order, events = _drain(core, max_steps=400)
    assert core.stats()["evictions"] >= 1
    assert sorted(r for r, _ in order) == ["a", "b"]
    assert _tokens(events)["b"] == want


def test_decode_matches_full_forward(models):
    """Greedy prefill + paged decode equals running the whole
    transformer over the growing sequence."""
    _, _, cfg, params = models
    core = EngineCore(cfg, params, device="cpu", num_pages=32, page_size=8,
                      max_batch=2)
    prompt = [3, 17, 91, 254, 8, 44]
    core.submit(prompt, max_tokens=5, rid="g")
    _, events = _drain(core)
    toks, ref = list(prompt), []
    for _ in range(5):
        logits = core.model.apply(params, torch.tensor([toks]))
        ref.append(int(logits[0, -1].argmax()))
        toks.append(ref[-1])
    assert _tokens(events)["g"] == ref


# ------------------------------------------------ scheduler behaviour
def test_admission_interleaves_prefill_and_decode(models):
    _, _, cfg, params = models
    core = EngineCore(cfg, params, device="cpu", num_pages=64, page_size=8,
                      max_batch=4)
    core.submit(list(range(1, 9)), max_tokens=24, rid="long")
    first = core.step()
    assert [e["rid"] for e in first if e["first"]] == ["long"]
    core.submit(list(range(20, 24)), max_tokens=3, rid="short")
    kinds = {(e["rid"], e["first"]) for e in core.step()}
    assert ("short", True) in kinds and ("long", False) in kinds
    order, _ = _drain(core)
    assert order[0] == ("short", FINISH_LENGTH)
    assert order[-1][0] == "long"
    assert core.stats()["free_pages"] == 64


def test_stop_and_max_token_termination(models):
    _, _, cfg, params = models
    core = EngineCore(cfg, params, device="cpu", num_pages=32, page_size=8,
                      max_batch=2)
    core.submit([5, 6, 7], max_tokens=8, rid="probe")
    order, events = _drain(core)
    assert order == [("probe", FINISH_LENGTH)]
    toks = _tokens(events)["probe"]
    assert len(toks) == 8
    core.submit([5, 6, 7], max_tokens=8, rid="stopped", stop=(toks[0],))
    order, events = _drain(core)
    assert order == [("stopped", FINISH_STOP)]
    assert _tokens(events)["stopped"] == [toks[0]]
    assert core.stats()["free_pages"] == 32


def test_submit_validation(models):
    _, _, cfg, params = models
    core = EngineCore(cfg, params, device="cpu", num_pages=4, page_size=8,
                      max_batch=2)
    with pytest.raises(ValueError):
        core.submit([], max_tokens=4)
    with pytest.raises(ValueError):
        core.submit([1], max_tokens=0)
    with pytest.raises(ValueError):
        core.submit([1] * 30, max_tokens=10)    # 40 > 4 pages * 8 slots
    with pytest.raises(ValueError):
        core.submit([1] * 120, max_tokens=10)   # past max_seq_len 128
    core.submit([1], rid="x")
    with pytest.raises(ValueError):
        core.submit([2], rid="x")


def test_cancel_and_drain_match_jax_engine(models):
    outs = []
    for core in _engines(models, num_pages=16, page_size=8, max_batch=1):
        core.submit([1, 2, 3], max_tokens=6, rid="run")
        core.submit([4, 5], max_tokens=6, rid="wait")
        core.submit([6], max_tokens=6, rid="gone")
        core.step()
        assert core.cancel("gone") and not core.cancel("gone")
        descs = core.drain()
        outs.append((descs, _comparable(core.stats())))
        assert not core.has_work and core.stats()["free_pages"] == 16
    assert outs[0] == outs[1]
    assert [d["rid"] for d in outs[1][0]] == ["run", "wait"]


# ------------------------------------------------------- device rule
def test_engine_without_device_needs_the_card(models):
    _, _, cfg, params = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError):
        EngineCore(cfg, params)


def test_engine_refuses_params_on_another_device(models):
    _, _, cfg, params = models
    meta = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError):
        EngineCore(cfg, meta, device="cpu")


# ----------------------------------------------------- import hygiene
def test_port_imports_neither_jax_nor_ray_tpu():
    """Every module of the port, and chip_smoke, imports neither JAX nor
    the JAX package, nor the JAX wire's codecs (protobuf, cloudpickle),
    which the chip machine does not have."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__,\n"
        "                               'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "from ray_tpu_torch.serve.llm import LLMEngine\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'ray_tpu' or n.startswith('ray_tpu.')\n"
        "             or n == 'cloudpickle' or n.startswith('cloudpickle.')\n"
        "             or n == 'google.protobuf'\n"
        "             or n.startswith('google.protobuf.'))\n"
        "n = sum(1 for n in sys.modules if n.startswith('ray_tpu_torch.'))\n"
        "print(n, bad, ' '.join(sorted(sys.modules)))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[:2000] + out.stderr
    imported = int(out.stdout.split()[0])
    assert imported >= 22, out.stdout[:2000]
    modules = set(out.stdout.split())
    for name in ("_private.config", "_private.context",
                 "_private.direct_actor", "_private.metrics_plane",
                 "_private.protocol", "_private.wire", "util.metrics",
                 "serve.llm.stream", "serve.llm.engine"):
        assert "ray_tpu_torch." + name in modules, name
