"""`decode_attn_roofline.chat`, fed records made by hand: the least time
of the paged decode kernels' bytes inside the decode spans over those
kernels' device time, and None where no such kernel ran."""
import pytest

from tiny import ROOT  # noqa: F401  (the checkout on sys.path)

from gpubench import core

M = {"layers": 2, "heads": 8, "kv_heads": 2, "head_dim": 64}
SPANS = [("model.decode:3:30", 0.0, 1.0), ("model.prefill:12", 1.0, 2.0),
         ("model.decode:4:44", 2.0, 3.0)]


def rec(kernels):
    names = [n for n, _s, _e in SPANS]
    return {"model": M, "trace": {
        "spans": SPANS, "window_s": 10.0, "busy_s": 0.0,
        "kernels": [(k, s, d, names.index(sp)) for k, s, d, sp in kernels]}}


def reader():
    return core.Registry().reader("decode_attn_roofline.chat")


def test_reads_the_paged_kernels_inside_decode_spans():
    kernels = [("rtt_paged_decode_attn<4, 64, 16>", 0.1, 2e-6,
                "model.decode:3:30"),
               ("rtt_paged_decode_merge<64, 16>", 0.2, 1e-6,
                "model.decode:3:30"),
               ("gemm", 0.3, 5e-6, "model.decode:3:30"),
               ("rtt_paged_decode_attn<4, 64, 16>", 2.1, 3e-6,
                "model.decode:4:44"),
               ("rtt_paged_decode_attn<4, 64, 16>", 1.1, 9e-6,
                "model.prefill:12")]
    # per layer: K/V 2 x 2 B x 2 heads x 64 x (contexts + rows), q and O
    # 2 x 2 B x 8 heads x 64 x rows
    least = sum(2 * (2 * 2 * 2 * 64 * (ctx + rows) + 2 * 2 * 8 * 64 * rows)
                for rows, ctx in ((3, 30), (4, 44))) / 3.35e12
    assert reader()(rec(kernels)) == pytest.approx(100 * least / 6e-6)


def test_nothing_to_read_without_the_kernel():
    assert reader()(rec([("gemm", 0.3, 5e-6, "model.decode:3:30")])) is None
    assert reader()({"model": M, "trace": None}) is None


class FakeCore:
    """The three engine calls `install_spans` wraps."""

    def step(self):
        return None

    def _prefill(self, seq, toks):
        return None

    def _decode(self, tokens, positions, pts, active):
        return None


def decode_span(monkeypatch, windows):
    import numpy as np
    import torch.profiler
    from gpubench import serving
    names = []

    class Named:
        def __init__(self, name):
            names.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "record_function", Named)
    core_ = FakeCore()
    undo = serving.install_spans(core_, windows)
    core_._decode(None, np.array([5, 2000, 900, 0], dtype=np.int32), None,
                  np.array([True, True, True, False]))
    undo()
    return names[0]


def test_the_decode_span_carries_each_windows_reach(monkeypatch):
    """Rows at positions 5, 2,000 and 900 (a fourth inactive): contexts
    6 + 2,001 + 901; within 1,024: 6 + 1,024 + 901; within 4,096: all."""
    assert decode_span(monkeypatch, ()) == "model.decode:3:2908"
    assert decode_span(monkeypatch, (1024, 4096)) == \
        "model.decode:3:2908:1931:2908"


def test_mfu_decode_reads_the_windows_reach():
    from gpubench import counts
    m = dict(M, d=8, f=16, vocab=10, experts=0, top_k=0, layers=4,
             windows=[4, 4, 4, 0], ffn=["dense"] * 4)
    spans = [("model.decode:2:16:8", 0.0, 1.0)]
    r = {"model": m, "trace": {"spans": spans, "window_s": 10.0,
                               "busy_s": 0.0,
                               "kernels": [("gemm", 0.1, 1e-3, 0)]}}
    c = counts.decode_step_counts(m, 2, 16, [8])
    assert core.Registry().reader("mfu.decode")(r) == pytest.approx(
        100 * counts.least_s(c["flops"], c["bytes"]) / 1e-3)
