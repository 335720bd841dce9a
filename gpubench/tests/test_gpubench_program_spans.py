"""The readers of the program's own spans and counters
(`gpubench/program_spans.py`), fed records made by hand: each reads its
number where the record has one, and None where it has nothing to read,
as on a program that names no such span."""
import time

import pytest
import torch

from tiny import ROOT  # noqa: F401  (the checkout on sys.path)

from gpubench import counts, program_spans as ps


def trace(spans, kernels, window_s=10.0):
    """A reduced trace (`trace.reduce_events`): kernels name their
    launching span by its name, turned into its index here."""
    names = [n for n, _s, _e in spans]
    return {"spans": spans, "window_s": window_s,
            "kernels": [(k, s, d, names.index(sp) if sp else -1)
                        for k, s, d, sp in kernels],
            "busy_s": 0.0}


def test_intervals():
    assert ps.union([(3, 4), (0, 1), (0.5, 2), (5, 5)]) == [(0, 2), (3, 4)]
    assert ps.subtract([(0, 10)], [(1, 2), (4, 5), (9, 12)]) == [
        (0, 1), (2, 4), (5, 9)]
    assert ps.subtract([(0, 1), (3, 4)], []) == [(0, 1), (3, 4)]
    assert ps.clip([(-1, 2), (9, 11), (12, 13)], 0, 10) == [(0, 2), (9, 10)]


# -------------------------------------------------------------- serving
STEP_SPANS = [
    ("llm.step:3:0", 0.0, 4.0), ("engine.step", 0.1, 3.9),
    ("llm.decode:3:30", 1.0, 3.0), ("model.decode:3:30", 1.1, 2.9),
    ("llm.step:3:1", 5.0, 9.0), ("engine.step", 5.1, 8.9),
    ("llm.prefill:12", 5.5, 6.5), ("model.prefill:12", 5.6, 6.4),
    ("llm.decode:4:44", 7.0, 8.5), ("model.decode:4:44", 7.1, 8.4)]
STEP_KERNELS = [("k", 1.2, 1.5, "model.decode:3:30"),
                ("k", 3.5, 0.2, "engine.step"),
                ("k", 5.6, 0.8, "model.prefill:12"),
                ("k", 7.2, 1.0, "model.decode:4:44")]


def test_engine_host_idle_share():
    """The step thread's own time inside `llm.step` and outside the model
    calls is [0,1] [3,4] [5,5.5] [6.5,7] [8.5,9], 3.5 s; the device ran
    a kernel for 0.2 s of it: 3.3 s idle of the 10 s slice."""
    rec = {"trace": trace(STEP_SPANS, STEP_KERNELS)}
    assert ps.engine_host_idle_share(rec) == pytest.approx(33.0)


def test_engine_host_idle_share_has_nothing_to_read():
    harness_only = [s for s in STEP_SPANS if not s[0].startswith("llm.")]
    assert ps.engine_host_idle_share(
        {"trace": trace(harness_only, STEP_KERNELS)}) is None
    assert ps.engine_host_idle_share({"trace": trace(STEP_SPANS, [])}) \
        is None
    assert ps.engine_host_idle_share({"trace": None}) is None


@pytest.fixture
def ring(monkeypatch):
    """This process's flight recorder, emptied, of `capacity` events."""
    from ray_tpu_torch._private import tracing_plane
    from ray_tpu_torch._private.config import CONFIG

    def make(capacity=4096):
        monkeypatch.setenv("RAY_TPU_TRACE", "1")
        monkeypatch.setenv("RAY_TPU_TRACE_RING", str(capacity))
        CONFIG.reload()
        tracing_plane.recorder().clear()
        return tracing_plane
    yield make
    monkeypatch.undo()
    CONFIG.reload()


def _waits(tp, t0, starts_s, dur_s=0.1, name="llm.lock_wait.generate"):
    for s in starts_s:
        a = int((t0 + s) * 1e9)
        tp.record("llm", name, a, a + int(dur_s * 1e9), 1, 2, 0)


def test_lock_wait_p95_reads_the_window(ring):
    """The waits of `generate` and the subscribe's that start in the
    window count (20 of 0.1 s and one of 2 s: p95 is the 20th, 0.1 s);
    others' waits and those before the window do not."""
    tp = ring()
    t0 = time.perf_counter()
    _waits(tp, t0, [-5.0], dur_s=9.0)
    _waits(tp, t0, [i * 0.1 for i in range(10)])
    _waits(tp, t0, [i * 0.1 for i in range(10)],
           name="llm.lock_wait.backlog")
    _waits(tp, t0, [1.5], dur_s=2.0)
    _waits(tp, t0, [1.0], dur_s=7.0, name="llm.lock_wait.stats")
    rec = {"window": {"t0": t0, "seconds": 3.0}}
    assert ps.lock_wait_p95_ms(rec) == pytest.approx(100.0)
    _waits(tp, t0, [2.0] * 2, dur_s=2.0)
    assert ps.lock_wait_p95_ms(rec) == pytest.approx(2000.0)


def test_lock_wait_p95_none_where_the_ring_overwrote_the_window(ring):
    tp = ring(capacity=8)
    t0 = time.perf_counter()
    _waits(tp, t0, [i * 0.1 for i in range(12)])
    rec = {"window": {"t0": t0, "seconds": 3.0}}
    assert tp.recorder().dropped() == 4
    assert ps.lock_wait_p95_ms(rec) is None
    # overwritten events that all ended before the window: read
    tp.recorder().clear()
    _waits(tp, t0, [-9.0 + 0.1 * i for i in range(6)])
    _waits(tp, t0, [0.5, 0.6, 0.7, 0.8])
    assert tp.recorder().dropped() == 2
    assert ps.lock_wait_p95_ms(rec) == pytest.approx(100.0)


def test_lock_wait_p95_has_nothing_to_read(ring, monkeypatch):
    tp = ring()
    t0 = time.perf_counter()
    rec = {"window": {"t0": t0, "seconds": 3.0}}
    assert ps.lock_wait_p95_ms(rec) is None            # no such span
    _waits(tp, t0, [0.5])
    assert ps.lock_wait_p95_ms({"kind": "train", **rec}) is None
    assert ps.lock_wait_p95_ms({}) is None
    assert ps.same_clock("perf_counter", "monotonic")
    monkeypatch.setattr(ps, "same_clock", lambda a, b: False)
    assert ps.lock_wait_p95_ms(rec) is None


# ------------------------------------------------------------- training
MODEL = {"d": 64, "f": 128, "layers": 2, "heads": 4, "kv_heads": 2,
         "head_dim": 16, "vocab": 256, "experts": 4, "top_k": 2}


def train_spans(step0):
    """One step's program and torch ranges, from `step0` s."""
    t = step0
    return [("train.loss:64", t, t + 1.0), ("moe.route", t + 0.1, t + 0.2),
            ("moe.dispatch", t + 0.2, t + 0.3),
            ("moe.experts", t + 0.3, t + 0.5),
            ("moe.combine", t + 0.5, t + 0.6),
            ("train.backward", t + 1.0, t + 2.0),
            ("moe.route", t + 1.1, t + 1.2),
            ("train.optimizer", t + 2.0, t + 3.0),
            ("Optimizer.step#AdamW.step", t + 2.01, t + 2.99)]


def train_kernels(spans, step):
    i = 9 * step
    return [("mm", spans[i][1] + 0.01, 0.001, i),
            ("route", spans[i + 1][1], 0.001, i + 1),
            ("disp", spans[i + 2][1], 0.002, i + 2),
            ("exp", spans[i + 3][1], 0.005, i + 3),
            ("comb", spans[i + 4][1], 0.003, i + 4),
            ("bwd", spans[i + 5][1] + 0.01, 0.004, i + 5),
            ("route", spans[i + 6][1], 0.001, i + 6),
            ("adam", spans[i + 8][1] + 0.1, 0.010, i + 8),
            ("adam", spans[i + 8][1] + 0.2, 0.020, i + 8),
            ("zero", spans[i + 7][1] + 0.001, 0.001, i + 7)]


def train_rec():
    spans = train_spans(0.0) + train_spans(3.0)
    kernels = [k for step in (0, 1) for k in train_kernels(spans, step)]
    return {"kind": "train", "model": MODEL,
            "trace": {"spans": spans, "window_s": 6.0, "busy_s": 0.0,
                      "kernels": kernels}}


def test_moe_dispatch_ms_counts_route_dispatch_combine_a_step():
    """Forward route 1 + dispatch 2 + combine 3, the recompute's route 1:
    7 ms a step (the experts' 5 ms and the backward's are not)."""
    assert ps.moe_dispatch_ms(train_rec()) == pytest.approx(7.0)


def test_adamw_roofline_over_the_optimizer_spans():
    """Two updates of 28 bytes a parameter at 3.35 TB/s over the 31 ms a
    step launched within `train.optimizer` (AdamW's range inside it,
    and the optimizer's own kernel)."""
    least = 2 * 28 * counts.total_params(MODEL) / counts.PEAK_HBM_BYTES_S
    assert ps.adamw_roofline(train_rec()) == pytest.approx(
        100 * least / 0.062)


def test_train_readers_have_nothing_to_read():
    rec = train_rec()
    old = {**rec, "trace": {**rec["trace"], "spans": [
        ("train.step:64", s, e) if n.startswith("train.") else (n, s, e)
        for n, s, e in rec["trace"]["spans"]
        if not n.startswith("moe.")]}}
    assert ps.adamw_roofline(old) is None
    assert ps.moe_dispatch_ms(old) is None
    no_kernels = {**rec, "trace": {**rec["trace"], "kernels": []}}
    assert ps.adamw_roofline(no_kernels) is None
    assert ps.moe_dispatch_ms(no_kernels) is None
    for read in (ps.adamw_roofline, ps.moe_dispatch_ms):
        assert read({**rec, "trace": None}) is None
        assert read({**rec, "kind": None}) is None


def test_moe_dropped_pct_reads_the_programs_tally(monkeypatch):
    from ray_tpu_torch.models import moe
    moe.reset_drop_tally()
    rec = {"kind": "train", "first_batches": [torch.zeros(1, 4)]}
    assert ps.moe_dropped_pct(rec) is None              # nothing tallied
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 8, generator=g)
    w = [torch.randn(*s, generator=g) for s in
         ((8, 4), (4, 8, 6), (4, 8, 6), (4, 6, 8))]
    _, aux = moe.moe_ffn(x, *w, top_k=2, capacity_factor=0.5)
    assert ps.moe_dropped_pct(rec) == pytest.approx(
        100 * float(aux["moe_dropped_fraction"]))
    assert ps.moe_dropped_pct({**rec, "kind": "serve"}) is None
    monkeypatch.delattr(moe, "drop_tally")               # an older program
    assert ps.moe_dropped_pct(rec) is None
    moe.reset_drop_tally()
