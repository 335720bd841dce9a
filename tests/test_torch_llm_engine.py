"""The port's `LLMEngine` and its push token stream, on the CPU.

The cases of `tests/test_serve_llm.py` for the JAX `LLMEngine` (polled
path and signals, push stream and zombie fence, drain) run on the
port's engine, and the two engines, given the same `tiny()` weights
(the JAX engine's own, made from a seed, handed over with
`params_from_jax`), return the same greedy tokens. Also here: the
polled-only engine under `RAY_TPU_LLM_STREAM=0`, the serving
histograms, what the engine refuses, and a step that raises ending every
open request instead of leaving its consumers waiting.
"""
import queue
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.serve.llm.engine import LLMEngine as JLLMEngine
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.metrics_plane import serving_metrics
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve.llm import LLMEngine, STREAM_STATS, stream_client
from ray_tpu_torch.serve.llm.engine import FINISH_DRAINED, FINISH_LENGTH
from ray_tpu_torch.serve.llm.stream import TokenStreamServer
from ray_tpu_torch.util.metrics import DEFAULT_REGISTRY

WAIT_S = 10.0
ENGINE = dict(num_pages=32, page_size=8, max_batch=4)


@pytest.fixture
def engine():
    eng = LLMEngine(model="tiny", seed=0, device="cpu", **ENGINE)
    yield eng
    eng.close()


def _poll(eng, rid, wait_s=0.5):
    """All of rid's tokens through next_tokens; (tokens, last reply)."""
    out, cur = [], 0
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        r = eng.next_tokens(rid, cursor=cur, wait_s=wait_s)
        out.extend(r["toks"])
        cur = r["cursor"]
        if r["done"]:
            return out, r
    raise AssertionError(f"{rid} not done in {WAIT_S} s")


def _consume(sink, until_done=True, toks=None):
    """Tokens from a subscriber's sink, appended to `toks` and trimmed
    by `base` (replay and live frames may overlap); (tokens, last
    frame)."""
    toks = [] if toks is None else toks
    msg = None
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        msg = sink.get(timeout=WAIT_S)
        assert msg["base"] <= len(toks), "a frame starts past the cursor"
        toks.extend(msg["toks"][len(toks) - msg["base"]:])
        if msg["done"] or not until_done:
            return toks, msg
    raise AssertionError("stream not done")


def _wait_for(cond):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.01)


# ------------------------------------------------------ engine + stream
def test_engine_polled_path_and_signals(engine):
    acc = engine.generate([1, 2, 3], max_tokens=6, rid="p")
    assert acc["rid"] == "p" and acc["attempt"] == 0
    assert acc["incarnation"] == engine.incarnation
    out, r = _poll(engine, "p")
    assert r["incarnation"] == acc["incarnation"]
    assert len(out) == 6 and r["reason"] == FINISH_LENGTH
    # mid-stream cursor replay: re-reading from 0 returns the full
    # prefix again (dup-safe)
    r0 = engine.next_tokens("p", cursor=0, wait_s=0.1)
    assert r0["toks"][:len(out)] == out
    with pytest.raises(RuntimeError):
        engine.next_tokens("nope", wait_s=0.01)
    st = engine.engine_stats()
    assert st["queue_wait_p95"] >= 0.0 and st["incarnation"] == \
        engine.incarnation and st["stream"] == acc["stream"]
    hook = engine.__serve_stats__()
    assert set(hook) >= {"queue_wait_p95", "outstanding_tokens"}
    assert engine.ping() == "pong"


def test_engine_push_stream_and_zombie_fence(engine):
    cl = stream_client()
    acc = engine.generate([4, 5, 6], max_tokens=5, rid="push1")
    assert acc["stream"][0] == "127.0.0.1"
    sink = queue.Queue()
    assert cl.subscribe(acc["stream"], "push1", acc["incarnation"], 0, 0,
                        sink)
    toks, msg = _consume(sink)
    assert len(toks) == 5 and msg["reason"] == FINISH_LENGTH
    assert toks == _poll(engine, "push1")[0]

    # wrong incarnation -> every frame fenced, nothing delivered
    z0 = STREAM_STATS["zombie_dropped"]
    engine.generate([4, 5, 6], max_tokens=3, rid="push2")
    sink2 = queue.Queue()
    assert cl.subscribe(acc["stream"], "push2", "deadbeef", 0, 0, sink2)
    _wait_for(lambda: STREAM_STATS["zombie_dropped"] > z0)
    assert sink2.empty()

    # unknown rid -> terminal unknown frame (the consumer fails over)
    sink3 = queue.Queue()
    assert cl.subscribe(acc["stream"], "ghost", acc["incarnation"], 0, 0,
                        sink3)
    m = sink3.get(timeout=WAIT_S)
    assert m.get("unknown") and m["done"]


def test_subscribe_from_a_cursor_replays_only_the_rest(engine):
    engine.generate([7, 8, 9], max_tokens=6, rid="late")
    full, _ = _poll(engine, "late")
    sink = queue.Queue()
    acc_stream = engine.engine_stats()["stream"]
    assert stream_client().subscribe(acc_stream, "late", engine.incarnation,
                                     0, 4, sink)
    msg = sink.get(timeout=WAIT_S)
    assert msg["base"] == 4 and msg["toks"] == full[4:] and msg["done"]


@pytest.mark.parametrize("published_before_replay", [True, False])
def test_live_frames_never_overtake_the_replay(published_before_replay):
    """A step published while a subscribe is between registration and
    its replay reaches the consumer after the replay and trimmed by it:
    every frame starts at or before the consumer's cursor, and the
    tokens arrive once each, in order."""
    def event(tok, seq, done=False):
        return {"rid": "r", "token": tok, "seq": seq, "first": seq == 0,
                "done": done, "reason": FINISH_LENGTH if done else None,
                "attempt": 0}
    buf = [10, 11]

    def backlog(rid, cursor):
        if rid != "r":
            return None
        if published_before_replay:     # the step lands mid-subscribe
            buf.append(12)
            server.publish([event(12, 2)])
        return {"rid": rid, "attempt": 0, "base": cursor,
                "toks": buf[cursor:], "done": False, "reason": None,
                "err": None}
    server = TokenStreamServer("inc0", backlog)
    try:
        sink = queue.Queue()
        assert stream_client().subscribe(server.addr, "r", "inc0", 0, 0,
                                         sink)
        first = sink.get(timeout=WAIT_S)
        assert first["base"] == 0 and first["toks"] == buf
        if not published_before_replay:
            buf.append(12)
            server.publish([event(12, 2)])
        server.publish([event(13, 3, done=True)])
        toks, last = _consume(sink, toks=list(first["toks"]))
        assert toks == [10, 11, 12, 13] and last["done"]
    finally:
        server.close()


def test_engine_drain_marks_and_publishes(monkeypatch):
    monkeypatch.setenv("RAY_TPU_LLM_STEP_DELAY_S", "0.05")
    CONFIG.reload()
    eng = LLMEngine(model="tiny", seed=0, device="cpu", num_pages=32,
                    page_size=8, max_batch=2)
    try:
        acc = eng.generate([1] * 20, max_tokens=40, rid="d")
        sink = queue.Queue()
        assert stream_client().subscribe(acc["stream"], "d",
                                         acc["incarnation"], 0, 0, sink)
        before, _ = _consume(sink, until_done=False)   # mid-generation
        descs = eng.drain()
        assert [d["rid"] for d in descs] == ["d"]
        d = descs[0]
        # the descriptor carries everything a survivor needs to
        # re-prefill and continue
        assert d["prompt"] == [1] * 20 and d["max_tokens"] == 40
        assert d["emitted"][:len(before)] == before
        assert 0 < len(d["emitted"]) < 40
        r = eng.next_tokens("d", cursor=0, wait_s=0.1)
        assert r["done"] and r["reason"] == FINISH_DRAINED
        assert r["toks"] == d["emitted"]
        toks, last = _consume(sink, toks=list(before))
        assert last["done"] and last["reason"] == FINISH_DRAINED
        assert toks == d["emitted"]
        assert not eng.core.has_work
    finally:
        eng.close()
        monkeypatch.delenv("RAY_TPU_LLM_STEP_DELAY_S")
        CONFIG.reload()


def test_stream_off_serves_through_next_tokens_only(monkeypatch):
    monkeypatch.setenv("RAY_TPU_LLM_STREAM", "0")
    CONFIG.reload()
    try:
        eng = LLMEngine(model="tiny", seed=0, device="cpu", **ENGINE)
        try:
            acc = eng.generate([3, 1, 4], max_tokens=4, rid="q")
            assert acc["stream"] is None
            assert eng.engine_stats()["stream"] is None
            out, r = _poll(eng, "q")
            assert len(out) == 4 and r["reason"] == FINISH_LENGTH
        finally:
            eng.close()
    finally:
        monkeypatch.delenv("RAY_TPU_LLM_STREAM")
        CONFIG.reload()
    assert CONFIG.llm_stream is True


def test_serving_histograms_count_first_and_later_tokens(engine):
    assert serving_metrics() is not None

    def counts():
        snap = DEFAULT_REGISTRY.collect()
        hist = [snap[f"ray_tpu_llm_{n}_s"]["series"][()][1]
                for n in ("ttft", "tpot")]
        return (*hist, snap["ray_tpu_llm_tokens"]["series"][()])
    engine.generate([1, 1, 2, 3], max_tokens=1, rid="h0")  # both series
    _poll(engine, "h0")                                     # exist now
    ttft0, tpot0, tok0 = counts()
    engine.generate([2, 7, 1, 8], max_tokens=5, rid="h")
    _poll(engine, "h")
    assert counts() == (ttft0 + 1, tpot0 + 4, tok0 + 5)
    snap = DEFAULT_REGISTRY.collect()["ray_tpu_llm_ttft_s"]
    assert snap["type"] == "histogram"
    total, count, buckets = snap["series"][()]
    assert buckets[-1] == (30.0, count) and total > 0


def test_unsubscribe_stops_the_frames():
    def backlog(rid, cursor):
        return {"rid": rid, "attempt": 0, "base": cursor, "toks": [],
                "done": False, "reason": None, "err": None}
    server = TokenStreamServer("inc1", backlog)
    try:
        sink = queue.Queue()
        cl = stream_client()
        assert cl.subscribe(server.addr, "u", "inc1", 0, 0, sink)
        _wait_for(lambda: any(sub[2] is None
                              for sub in server._subs.get("u", ())))
        server.publish([{"rid": "u", "token": 5, "seq": 0, "first": True,
                         "done": False, "reason": None, "attempt": 0}])
        assert sink.get(timeout=WAIT_S)["toks"] == [5]
        cl.unsubscribe("u")
        _wait_for(lambda: not server._subs.get("u"))
        server.publish([{"rid": "u", "token": 6, "seq": 1, "first": False,
                         "done": True, "reason": FINISH_LENGTH,
                         "attempt": 0}])
        time.sleep(0.1)
        assert sink.empty()
    finally:
        server.close()


def test_metrics_off_registers_nothing(monkeypatch):
    monkeypatch.setenv("RAY_TPU_METRICS", "0")
    CONFIG.reload()
    try:
        assert serving_metrics() is None
    finally:
        monkeypatch.delenv("RAY_TPU_METRICS")
        CONFIG.reload()
    assert serving_metrics() is not None


def test_a_step_that_raises_ends_every_open_request(engine, monkeypatch):
    """A step failure (on the card, a CUDA error) must not leave
    pollers or subscribers waiting on a dead step thread."""
    def broken():
        raise RuntimeError("device lost")
    monkeypatch.setattr(engine.core, "step", broken)
    monkeypatch.setattr("threading.excepthook", lambda args: None)
    acc = engine.generate([5, 5], max_tokens=4, rid="f")
    sink = queue.Queue()
    assert stream_client().subscribe(acc["stream"], "f", acc["incarnation"],
                                     0, 0, sink)
    _, r = _poll(engine, "f")
    assert r["reason"] == "error" and "device lost" in r["err"]
    _, msg = _consume(sink)
    assert msg["reason"] == "error" and "device lost" in msg["err"]
    engine._thread.join(WAIT_S)
    assert not engine._thread.is_alive()


def test_close_ends_every_thread_and_frees_the_engine():
    """After close no thread of the engine is left, so nothing holds its
    weights and KV cache (an accept blocked on the listener would)."""
    import gc
    import threading
    import weakref
    eng = LLMEngine(model="tiny", seed=0, device="cpu", **ENGINE)
    acc = eng.generate([1, 2], max_tokens=3, rid="c")
    sink = queue.Queue()
    assert stream_client().subscribe(acc["stream"], "c", acc["incarnation"],
                                     0, 0, sink)
    _consume(sink)
    ref = weakref.ref(eng)
    eng.close()
    del eng
    names = {t.name for t in threading.enumerate()}
    assert not names & {"llm-engine-step", "llm-stream-accept"}, names
    # the closed connections' readers exit as their sockets shut down
    _wait_for(lambda: gc.collect() >= 0 and ref() is None)


def test_engine_refuses_what_the_port_lacks():
    with pytest.raises(NotImplementedError, match="parallel layer"):
        LLMEngine(model="tiny", mesh={"tp": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="object"):
        LLMEngine(model="tiny", weights=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LLMEngine(model="tiny")


# ------------------------------------------------ parity with the JAX engine
def test_greedy_tokens_match_jax_llm_engine():
    """JAX `LLMEngine(model="tiny", seed=0)` and the port's engine with
    the same weights (the JAX engine's params through `params_from_jax`)
    return the same greedy tokens for the same prompts, submitted
    together."""
    prompts = {"a": [1, 2, 3, 4, 5, 6, 7], "b": list(range(30, 45)),
               "c": [200], "d": [9, 9, 8]}     # one prefill bucket (16)
    new = {"a": 9, "b": 5, "c": 7, "d": 4}
    jeng = JLLMEngine(model="tiny", seed=0, **ENGINE)
    params = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jeng.core.params), tiny(),
        device="cpu")
    got = {}
    for name, eng in (("jax", jeng),
                      ("port", LLMEngine(model="tiny", weights=params,
                                         device="cpu", **ENGINE))):
        try:
            for rid, p in prompts.items():
                eng.generate(p, max_tokens=new[rid], rid=rid)
            got[name] = {rid: _poll(eng, rid) for rid in prompts}
        finally:
            eng.close()
    for rid in prompts:
        (jt, jr), (t, r) = got["jax"][rid], got["port"][rid]
        assert t == jt and len(t) == new[rid], rid
        assert r["reason"] == jr["reason"] == FINISH_LENGTH
