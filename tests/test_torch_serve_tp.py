"""A serving replica sharded over tensor-parallel ranks, on gloo CPU ranks,
against the JAX package.

The JAX parameters are made from a seed and carried over with
`params_from_jax`; each rank takes its shard (`tp_shard_params`). The
sharded `prefill` and `decode_step` run on a module-scoped pool of gloo
rank processes (`torch_ranks.RankPool`), and so does an `EngineCore`
whose rank 0 drives the others through the lockstep protocol; the JAX
`decode` functions and `EngineCore(mesh=prepare_mesh(tp=...))` run here.
`tiny()` has 2 kv heads, so tp=2 there; tp=4 runs on a `tiny` variant
with 8 heads and 4 kv heads. `LLMEngine(mesh=...)` and `serve_llm(mesh=...)`
run through the port's runtime, their follower ranks as actors. Also
here: the JAX engine's cache under tp=2, which the JAX package keeps
whole on every device (ROADMAP queue 3, item 23).
"""
import dataclasses
import os
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import decode as jdecode
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.parallel import prepare_mesh as jprepare_mesh
from ray_tpu.serve.llm.engine import EngineCore as JEngineCore
from ray_tpu.serve.llm.kv_cache import pages_from_budget as jpages
from ray_tpu_torch import serve
from ray_tpu_torch.models import decode
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import (params_from_jax,
                                          tp_shard_params)
from ray_tpu_torch.serve import llm
from ray_tpu_torch.serve.llm.engine import LLMEngine
from ray_tpu_torch.serve.llm.kv_cache import pages_from_budget

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import RankPool  # noqa: E402

PAGE, PAGES, BATCH = 8, 32, 4
LOGITS_ATOL = 1e-5
PROMPTS = {"a": ([1, 2, 3, 4, 5, 6, 7], 9),
           "b": (list(range(30, 52)), 5),
           "c": ([200], 7)}


@pytest.fixture(scope="module", autouse=True)
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


def _configs(tp):
    """(JAX config, port config) for a tp: tiny(), or for tp=4 a tiny
    variant with 8 heads and 4 kv heads."""
    jcfg, cfg = jtiny(), tiny()
    if tp == 4:
        jcfg = dataclasses.replace(jcfg, n_heads=8, n_kv_heads=4)
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4)
    return jcfg, cfg


def _weights(tp, seed=0):
    jcfg, cfg = _configs(tp)
    jparams = JTransformer(jcfg).init(jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX EngineCore's tokens for PROMPTS on `tiny()` from seed 0,
    and the port's copy of those params."""
    jcfg, jparams, _, params = _weights(2)
    return _jax_tokens(jcfg, jparams)[0], params


def _group():
    """This pool rank's ReplicaGroup over the pool's default gloo group."""
    import torch.distributed as dist

    from ray_tpu_torch.serve.llm.replica_group import ReplicaGroup
    return ReplicaGroup(dist.group.WORLD, dist.get_rank(),
                        dist.get_world_size(), "gloo")


# ------------------------------------------------------ the shards
def test_shards_split_as_the_jax_rules_table():
    _, cfg = _configs(2)
    params = tp_shard_params(_weights(2)[3], cfg, 1, 0)
    s0, s1 = (tp_shard_params(params, cfg, 2, r) for r in (0, 1))
    hd = cfg.head_dim
    lay = params["layers"][0]
    assert s0["layers"][0]["wq"].shape == (cfg.d_model, cfg.n_heads * hd // 2)
    assert s0["layers"][0]["wk"].shape == (cfg.d_model, hd)
    assert torch.equal(torch.cat([s0["layers"][0]["wo"],
                                  s1["layers"][0]["wo"]]), lay["wo"])
    assert torch.equal(torch.cat([s0["layers"][0]["up"],
                                  s1["layers"][0]["up"]], 1), lay["up"])
    assert torch.equal(torch.cat([s0["lm_head"], s1["lm_head"]], 1),
                       params["lm_head"])
    assert torch.equal(s1["embed"], params["embed"])     # replicated
    with pytest.raises(ValueError, match="kv_heads"):
        tp_shard_params(params, cfg, 4, 0)


# --------------------------------------------------------- the kv budget
def test_pages_from_budget_matches_jax_and_each_rank_fits():
    jcfg, cfg = _configs(2)
    budget = 1 << 20
    for tp in (1, 2):
        pages = pages_from_budget(cfg, PAGE, budget, tp_shards=tp)
        assert pages == jpages(jcfg, PAGE, budget, tp_shards=tp)
        cache = decode.init_paged_cache(cfg, pages, PAGE, device="cpu",
                                        kv_heads=cfg.kv_heads // tp)
        assert sum(t.numel() * t.element_size()
                   for t in cache.values()) <= budget
    assert pages_from_budget(cfg, PAGE, budget, tp_shards=2) == \
        2 * pages_from_budget(cfg, PAGE, budget)


def test_jax_tp_engine_holds_tp_times_the_budget_on_each_device():
    """ROADMAP queue 3, item 23, in the reference: the JAX engine sizes
    its pool as if tp split the kv heads, but keeps the whole cache on
    each of the mesh's devices, so each device holds tp times the
    budget. The port's ranks each hold the budget (the test below)."""
    jcfg, jparams, _, _ = _weights(2)
    budget = 1 << 20
    pages = jpages(jcfg, PAGE, budget, tp_shards=2)
    core = JEngineCore(jcfg, jparams, mesh=jprepare_mesh(tp=2),
                       num_pages=pages, page_size=PAGE, max_batch=BATCH)
    core.submit([1, 2, 3], max_tokens=2)
    while core.has_work:
        core.step()
    per_device = {}
    for key in ("k", "v"):
        for shard in core._cache[key].addressable_shards:
            per_device[shard.device] = (per_device.get(shard.device, 0)
                                        + shard.data.nbytes)
    assert len(per_device) == len(jax.devices())
    assert set(per_device.values()) == {2 * budget}


# ------------------------------------------------------------- the model
def _rank_logits(cfg, params, prefill_args, decode_args):
    """Prefill then one decode step on this rank's shard; returns the
    logits of both and this rank's cache bytes."""
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.models.convert import tp_shard_params as shard_of
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.serve.llm.replica_group import cache_bytes
    g = _group()
    shard = shard_of(params, cfg, g.size, g.rank)
    model = Transformer(cfg)
    cache = dec.init_paged_cache(cfg, PAGES, PAGE, device="cpu",
                                 kv_heads=cfg.kv_heads // g.size)
    toks, n, pt = prefill_args
    lp, _ = dec.prefill(model, shard, torch.from_numpy(toks), n,
                        torch.from_numpy(pt), cache, PAGE, group=g)
    ld, _ = dec.decode_step(model, shard, cache,
                            *map(torch.from_numpy, decode_args), PAGE,
                            group=g)
    return lp.numpy(), ld.numpy(), cache_bytes(cache)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_prefill_and_decode_match_jax(ranks, tp):
    """Every rank's logits of a sharded prefill and decode step are
    within 1e-5 of the JAX `decode` functions' on the same params, and
    every rank holds its share of the cache."""
    jcfg, jparams, cfg, params = _weights(tp, seed=4)
    jmodel = JTransformer(jcfg)
    prompt = [3, 17, 91, 254, 8, 44, 9, 1, 77, 12, 5]
    toks = np.zeros((16,), np.int32)
    toks[:len(prompt)] = prompt
    pt = np.full((cfg.max_seq_len // PAGE,), -1, np.int32)
    pt[:2] = (5, 2)
    jcache = jdecode.init_paged_cache(jcfg, PAGES, PAGE)
    jlp, jcache = jdecode.prefill(jmodel, jparams, jnp.asarray(toks),
                                  jnp.int32(len(prompt)), jnp.asarray(pt),
                                  jcache, PAGE)
    tokens = np.array([int(np.argmax(jlp)), 7, 0], np.int32)
    positions = np.array([len(prompt), 0, 0], np.int32)
    pts = np.full((3, pt.shape[0]), -1, np.int32)
    pts[0], pts[1, 0] = pt, 6
    active = np.array([True, True, False])
    jld, _ = jdecode.decode_step(jmodel, jparams, jcache,
                                 *map(jnp.asarray, (tokens, positions, pts,
                                                    active)), PAGE)
    out = ranks.run(tp, _rank_logits, cfg, params, (toks, len(prompt), pt),
                    (tokens, positions, pts, active))
    whole = 2 * cfg.n_layers * PAGES * PAGE * cfg.kv_heads * cfg.head_dim * 4
    for lp, ld, nbytes in out:
        np.testing.assert_allclose(lp, np.asarray(jlp), atol=LOGITS_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(ld[:2], np.asarray(jld)[:2],
                                   atol=LOGITS_ATOL, rtol=0)
        assert nbytes * tp == whole
    # the all-reduces leave every rank the same bits
    assert all(np.array_equal(o[0], out[0][0]) and
               np.array_equal(o[1], out[0][1]) for o in out)


# ------------------------------------------------------------ the engine
def _rank_engine(cfg, params, prompts):
    """Rank 0: an EngineCore over the group, recording the top-2 margin
    of every logits row that picks a token; the other ranks: `TPRank`'s
    loop until rank 0's stop. Returns (tokens, margins) on rank 0."""
    from ray_tpu_torch.models import decode as dec
    from ray_tpu_torch.models.transformer import Transformer
    from ray_tpu_torch.serve.llm import replica_group as rg
    from ray_tpu_torch.serve.llm.engine import EngineCore
    g = _group()
    if g.rank:
        r = rg.TPRank()
        r.place("cpu")
        r.group = g
        r.setup(dataclasses.asdict(cfg), params, 0, PAGES, PAGE, BATCH)
        r.run()
        return None
    margins = []

    def top2(rows):
        v = rows.topk(2, dim=-1).values
        margins.extend((v[..., 0] - v[..., 1]).reshape(-1).tolist())

    prefill, decode_step = dec.prefill, dec.decode_step

    def rec_prefill(*a, **kw):
        logits, cache = prefill(*a, **kw)
        top2(logits)
        return logits, cache

    def rec_decode(model, p, cache, tokens, positions, pts, active, *a,
                   **kw):
        logits, cache = decode_step(model, p, cache, tokens, positions, pts,
                                    active, *a, **kw)
        top2(logits[active])
        return logits, cache

    dec.prefill, dec.decode_step = rec_prefill, rec_decode
    try:
        shard = rg.rank_params(Transformer(cfg), params, 0, g.size, 0,
                               "cpu")
        core = EngineCore(cfg, shard, device="cpu", num_pages=PAGES,
                          page_size=PAGE, max_batch=BATCH, group=g)
        for rid, (p, n) in prompts.items():
            core.submit(p, max_tokens=n, rid=rid)
        tokens = {}
        while core.has_work:
            for ev in core.step():
                if ev["token"] is not None:
                    tokens.setdefault(ev["rid"], []).append(ev["token"])
    finally:
        dec.prefill, dec.decode_step = prefill, decode_step
        g.send_step(rg.KIND_STOP)
    return tokens, margins


def _jax_tokens(jcfg, jparams, mesh=None, **kw):
    core = JEngineCore(jcfg, jparams, mesh=mesh, num_pages=PAGES,
                       page_size=PAGE, max_batch=BATCH, **kw)
    for rid, (p, n) in PROMPTS.items():
        core.submit(p, max_tokens=n, rid=rid)
    want = {}
    while core.has_work:
        for ev in core.step():
            if ev["token"] is not None:
                want.setdefault(ev["rid"], []).append(ev["token"])
    return want, core


@pytest.mark.parametrize("tp", [2, 4])
def test_engine_core_over_the_group_matches_jax_engine(ranks, tp):
    """The greedy tokens of an EngineCore over tp gloo ranks equal the
    JAX `EngineCore(mesh=prepare_mesh(tp=...))`'s, and every step's top-2
    margin is above 1e-4, so that equality means something."""
    jcfg, jparams, cfg, params = _weights(tp)
    want, _ = _jax_tokens(jcfg, jparams, mesh=jprepare_mesh(tp=tp))
    (got, margins), *rest = ranks.run(tp, _rank_engine, cfg, params,
                                      PROMPTS)
    assert rest == [None] * (tp - 1)
    assert got == want
    assert len(margins) == sum(n for _, n in PROMPTS.values())
    assert min(margins) > 1e-4, min(margins)


# --------------------------------------------------- through the runtime
def _poll_all(eng, rids, deadline_s=60.0):
    out, end = {}, time.monotonic() + deadline_s
    for rid in rids:
        toks, cur = [], 0
        while True:
            assert time.monotonic() < end, f"{rid} still open"
            r = eng.next_tokens(rid, cur, wait_s=1.0)
            toks += r["toks"]
            cur = r["cursor"]
            if r["done"]:
                break
        out[rid] = toks
    return out


def test_llm_engine_mesh_answers_with_jax_tokens(ray_cluster, jax_tokens):
    """`LLMEngine(mesh={"tp": 2}, device="cpu")` from the JAX engine's
    params: rank 0 in this process, rank 1 an actor; the JAX engine's
    tokens, every rank's cache within `kv_budget_bytes`."""
    want, params = jax_tokens
    cfg = tiny()
    budget = 2 * cfg.n_layers * PAGES * PAGE * cfg.head_dim * 4  # 1 kv head
    eng = LLMEngine(model=cfg, weights=params, mesh={"dp": 1, "tp": 2},
                    kv_budget_bytes=budget, page_size=PAGE,
                    max_batch=BATCH, device="cpu")
    try:
        rids = [eng.generate(p, max_tokens=n, rid=rid)["rid"]
                for rid, (p, n) in PROMPTS.items()]
        assert _poll_all(eng, rids) == want
        st = eng.engine_stats()
        assert st["tp"] == 2 and st["tp_backend"] == "gloo"
        assert st["num_pages"] == PAGES
        assert st["cache_bytes_by_rank"] == [budget, budget]
        assert len(st["kernel_launches_by_rank"]) == 2
    finally:
        eng.close()


def test_serve_llm_mesh_answers_with_jax_tokens(ray_cluster, jax_tokens):
    """`serve_llm(mesh={"tp": 2}, device="cpu")`: one replica of two
    ranks, from a weights ref; the JAX engine's tokens."""
    want, params = jax_tokens
    cfg = tiny()
    try:
        handle = llm.serve_llm(name="tp2", model=cfg,
                               weights=ray_tpu_torch.put(params),
                               num_replicas=1, mesh={"tp": 2}, device="cpu",
                               num_pages=PAGES, page_size=PAGE,
                               max_batch=BATCH)
        streams = {rid: handle.generate(p, max_tokens=n, timeout_s=60)
                   for rid, (p, n) in PROMPTS.items()}
        got = {rid: s.tokens() for rid, s in streams.items()}
        assert got == want
        (st,) = handle.stats()
        assert st["tp"] == 2 and len(st["tp_pids"]) == 2
    finally:
        serve.shutdown()


def _pid_gone(pid, within_s):
    """True once `pid` has exited (a zombie its parent has not reaped yet
    counts) within `within_s`."""
    end = time.monotonic() + within_s
    while time.monotonic() < end:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.1)
    return False


ERROR_WITHIN_S = 15.0


def test_a_killed_follower_ends_open_requests_with_an_error(ray_cluster,
                                                           monkeypatch):
    """SIGKILL rank 1 mid-generation: rank 0's next collective raises,
    every open request ends with reason "error" within ERROR_WITHIN_S,
    and the engine refuses new requests and reports unhealthy."""
    from ray_tpu_torch._private.config import CONFIG
    monkeypatch.setenv("RAY_TPU_LLM_STEP_DELAY_S", "0.05")
    CONFIG.reload()
    try:
        eng = LLMEngine(model="tiny", mesh={"tp": 2}, num_pages=PAGES,
                        page_size=PAGE, max_batch=BATCH, device="cpu")
    finally:
        monkeypatch.delenv("RAY_TPU_LLM_STEP_DELAY_S")
        CONFIG.reload()
    try:
        follower = eng.engine_stats()["tp_pids"][1]
        rids = [eng.generate([1, 2, 3], max_tokens=100)["rid"]
                for _ in range(2)]
        assert eng.next_tokens(rids[0], 0, wait_s=10)["toks"]
        os.kill(follower, signal.SIGKILL)
        t0 = time.monotonic()
        for rid in rids:
            cur = 0
            while True:
                r = eng.next_tokens(rid, cur, wait_s=1.0)
                cur = r["cursor"]
                if r["done"]:
                    break
                assert time.monotonic() - t0 < ERROR_WITHIN_S
            assert r["reason"] == "error" and r["err"]
        with pytest.raises(RuntimeError, match="step failed"):
            eng.check_health()
        with pytest.raises(RuntimeError, match="step failed"):
            eng.generate([1, 2], max_tokens=2)
    finally:
        eng.close()


def _rank_zero_cls():
    """An actor class (made here, so it pickles by value) that is rank 0
    of a tp=2 replica."""
    class RankZero:
        def __init__(self):
            from ray_tpu_torch.serve.llm.engine import LLMEngine as Engine
            self.eng = Engine(model="tiny", mesh={"tp": 2}, num_pages=32,
                              page_size=8, max_batch=4, device="cpu")

        def pids(self):
            return self.eng.engine_stats()["tp_pids"]
    return RankZero


def test_followers_die_with_rank_zero(ray_cluster):
    """SIGKILL rank 0's process: its follower exits within 10 s."""
    actor = ray_tpu_torch.remote(_rank_zero_cls()).remote()
    leader, follower = ray_tpu_torch.get(actor.pids.remote(), timeout=60)
    os.kill(leader, signal.SIGKILL)
    assert _pid_gone(follower, 10.0)
    assert _pid_gone(leader, 5.0)


def test_an_unhealthy_replica_stops_reporting():
    """A replica whose deployment object fails `check_health` (as
    `LLMEngine` does once a step has failed) stops its pushed reports, so
    the controller presumes it dead, kills it and starts another; a
    healthy one keeps reporting."""
    import threading

    from ray_tpu_torch.serve import _Replica

    class Engine:
        healthy = True

        def check_health(self):
            if not self.healthy:
                raise RuntimeError("the engine's step failed")

    rep = _Replica(Engine, (), {})
    # no controller: a healthy loop keeps trying to reach one
    t = threading.Thread(target=rep._report_loop,
                         args=("llm", "r0", "no-such-controller", 0.01),
                         daemon=True)
    t.start()
    t.join(0.5)
    assert t.is_alive()
    rep._obj.healthy = False
    t.join(5.0)
    assert not t.is_alive()
    rep._stop_report.set()
