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
