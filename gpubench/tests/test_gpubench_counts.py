"""The FLOP and byte counts against counts made by hand at small
shapes."""
import itertools

import pytest

import tiny  # noqa: F401

from gpubench import core, counts

M = {"d": 8, "f": 16, "layers": 2, "heads": 4, "kv_heads": 2,
     "head_dim": 2, "vocab": 10, "experts": 0, "top_k": 0}


def causal_pairs_by_hand(s):
    return sum(1 for q, k in itertools.product(range(s), repeat=2)
               if k <= q)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64])
def test_causal_pairs(s):
    assert counts.causal_pairs(s) == causal_pairs_by_hand(s)


def test_attention_forward_by_hand():
    # s = 3, one head of dim 2: 6 pairs; QK^T and PV each 2 FLOPs per
    # multiply-add over the head dim: 6 * (2 * 2 + 2 * 2) = 48
    assert counts.attn_fwd_flops(1, 2, 6) == 48
    # q, o: 3 x 4 heads x 2 x 2 bytes; k, v: 3 x 2 x 2 x 2; lse 3 x 4 x 4
    assert counts.attn_fwd_bytes(3, 4, 2, 2) == 2 * 48 + 2 * 24 + 48
    assert counts.attn_bwd_flops(1, 2, 6) == 2.5 * 48


def test_prefill_by_hand():
    # a layer's weights: q 8x8, k 8x4, v 8x4, o 8x8, ffn 3 x 8x16
    per_layer = 64 + 32 + 32 + 64 + 3 * 128
    assert counts.layer_matmul_params(M) == per_layer
    L = 5
    want = (2 * per_layer * L * 2                  # matmuls, both layers
            + 2 * 4 * (4 * 2) * 15 // 2 * 2       # 15 pairs, 4 heads
            + 2 * 8 * 10)                         # head, last row only
    assert counts.prefill_flops(M, L) == want


def test_decode_step_by_hand():
    c = counts.decode_step_counts(M, rows=2, contexts=7)
    per_layer = counts.layer_matmul_params(M)
    weights = 2 * (per_layer * 2 + 8 * 10)
    kv = 2 * 2 * 2 * 2 * 2 * (7 + 2)       # k+v, kv heads, hd, layers
    assert c["bytes"] == weights + kv
    assert c["flops"] == 2 * (per_layer * 2 + 80) * 2 + 4 * 4 * 2 * 7 * 2


def test_moe_counts_take_the_active_experts():
    moe = dict(M, experts=8, top_k=2)
    attn = 64 + 32 + 32 + 64
    assert counts.layer_matmul_params(moe) == attn + 2 * 3 * 128 + 8 * 8
    assert counts.layer_matmul_params(moe, active_only=False) == \
        attn + 8 * 3 * 128 + 8 * 8


def test_train_flops_per_token_by_hand():
    s = 4
    mm = 6 * (counts.layer_matmul_params(M) * 2 + 80)
    attn = 3 * 4 * 4 * 2 * 10 * 2 / s          # 10 pairs, 2 layers
    assert counts.train_flops_per_token(M, s) == mm + attn


def test_least_time_takes_the_binding_bound():
    assert counts.least_s(989e12, 0) == 1.0
    assert counts.least_s(0, 3.35e12) == 1.0
    assert counts.least_s(1.0, 1e6) == 1e6 / counts.PEAK_HBM_BYTES_S


def test_total_params_agree_with_the_port():
    from ray_tpu_torch.models.config import TransformerConfig
    for kw in ({}, {"moe_num_experts": 4, "moe_top_k": 2}):
        cfg = TransformerConfig(vocab_size=50, d_model=16, n_layers=3,
                                n_heads=4, n_kv_heads=2, d_ff=24, **kw)
        assert counts.total_params(counts.sizes(cfg)) == cfg.num_params()


def test_the_mixtral_cut_at_its_training_shape():
    conf = core.Registry().config("mixtral-8x7b")
    m = counts.sizes(core.model_config(conf))
    # 2 layers of 41.9 M attention + 2 of 8 experts + the head: 0.92 B
    active = counts.layer_matmul_params(m) * 2 + m["d"] * m["vocab"]
    assert round(active / 1e9, 2) == 0.92
    assert round(counts.train_flops_per_token(m, 4096) / 1e9, 2) == 5.72


# -------------------------------------------------- windows, FFN kinds
# four layers, three of window 4 to one full (3 : 1), dense
M4 = dict(M, layers=4, windows=[4, 4, 4, 0], ffn=["dense"] * 4)


def window_pairs_by_hand(s, w):
    return sum(1 for q, k in itertools.product(range(s), repeat=2)
               if q - w < k <= q)


@pytest.mark.parametrize("s", [1, 3, 4, 5, 10, 37])
@pytest.mark.parametrize("w", [1, 2, 4, 16])
def test_window_pairs(s, w):
    assert counts.window_pairs(s, w) == window_pairs_by_hand(s, w)
    assert counts.window_pairs(s, 0) == counts.causal_pairs(s)


def test_a_window_that_covers_every_context_counts_as_full():
    wide = dict(M4, windows=[64, 64, 64, 0])
    full = dict(M4, windows=[0] * 4)
    for L in (1, 17, 64):
        assert counts.prefill_flops(wide, L) == counts.prefill_flops(full, L)
        assert counts.train_flops_per_token(wide, L) == \
            counts.train_flops_per_token(full, L)
    # rows at positions 5 and 40: every context within 64
    assert counts.decode_step_counts(wide, 2, 47, [47]) == \
        counts.decode_step_counts(full, 2, 47)
    assert counts.decode_attn_bytes(wide, 2, 47, [47]) == \
        counts.decode_attn_bytes(full, 2, 47)


def test_windowed_prefill_by_hand():
    # L = 10, window 4: 1 + 2 + 3 + 4 x 7 = 34 pairs a windowed layer,
    # 55 in the full one
    pairs = 3 * 34 + 55
    want = (2 * counts.layer_matmul_params(M4) * 10 * 4
            + 4 * 4 * 2 * pairs                  # 4 heads of dim 2
            + 2 * 8 * 10)
    assert counts.prefill_flops(M4, 10) == want
    assert counts.train_flops_per_token(M4, 10) == (
        6 * (counts.layer_matmul_params(M4) * 4 + 80)
        + 3 * 4 * 4 * 2 * pairs / 10)


def test_windowed_decode_by_hand():
    # rows at positions 5 and 9: contexts 6 and 10 (16), within the
    # window 4 and 4 (8)
    c = counts.decode_step_counts(M4, rows=2, contexts=16,
                                  window_contexts=[8])
    per_layer = counts.layer_matmul_params(M4)
    weights = 2 * (per_layer * 4 + 8 * 10)
    # k+v, 2 kv heads, head 2, bf16: 3 layers of (8 + 2), 1 of (16 + 2)
    kv = 2 * 2 * 2 * 2 * (3 * (8 + 2) + (16 + 2))
    assert c["bytes"] == weights + kv == weights + 768
    assert c["flops"] == (2 * (per_layer * 4 + 80) * 2
                          + 4 * 4 * 2 * (3 * 8 + 16))
    qo = 2 * 2 * 4 * 2 * 2                    # q and O, 4 heads, 2 rows
    assert counts.decode_attn_bytes(M4, 2, 16, [8]) == kv + 4 * qo
    with pytest.raises(ValueError):
        counts.decode_step_counts(M4, 2, 16)


def test_each_layer_counts_its_own_ffn():
    # a dense layer of width 16 before three expert layers of width 4
    mixed = dict(M, layers=4, experts=8, top_k=2, f_expert=4,
                 ffn=["dense"] + ["experts"] * 3)
    attn = 64 + 32 + 32 + 64
    assert counts.layer_matmul_params(mixed, layer=0) == attn + 3 * 128
    assert counts.layer_matmul_params(mixed, layer=1) == \
        attn + 2 * 3 * 8 * 4 + 8 * 8
    assert counts.matmul_params(mixed, active_only=False) == \
        4 * attn + 3 * 128 + 3 * (8 * 3 * 8 * 4 + 8 * 8)
    assert counts.total_params(mixed) == (
        10 * 8 + counts.matmul_params(mixed, active_only=False)
        + 4 * 2 * 8 + 8 + 8 * 10)
