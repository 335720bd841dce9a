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
