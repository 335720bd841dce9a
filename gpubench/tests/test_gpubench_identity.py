"""What the benchmark reads does not move when its code is reorganised.

The literals below were read from the harness as it stood before each
configuration reached its architecture through `arch/<name>.py`, at
`tiny_cell`'s widths on the CPU (weights, the reference) and at the
published sizes (the counts), and from every metric file on records made
here by hand. The harness must reproduce each of them to the last bit:
the same weights for every seed, the same reference logits and loss,
the same counts, and every metric the same value from the same record.
"""
import copy
import hashlib

import pytest
import torch

from tiny import TINY

from gpubench import core, counts, judge, weights

REG = core.Registry()
CONFIGS = ("mistral-7b", "mixtral-8x7b")
SEEDS = (1, 2 ** 31 + 7)


def tiny_config(name: str) -> dict:
    conf = copy.deepcopy(REG.config(name))
    conf.update(TINY)
    return conf


def digest(t: torch.Tensor, n: int = 16) -> str:
    """The first `n` hex digits of the SHA-256 of a tensor's bytes."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:n]


def cell_params(name: str, seed: int):
    """The weights as the config's cell makes them: served configs in
    their served dtype, one slab a leaf kind; trained ones in float32,
    one tensor a leaf."""
    conf = tiny_config(name)
    served = "serving" in conf
    dtype = judge.served_dtype(conf) if served else torch.float32
    dims = core.dims(conf)
    return conf, dims, weights.make_params(dims, seed, "cpu", dtype,
                                           stacked=served)


def leaf_digests(name: str, seed: int) -> list:
    _conf, dims, params = cell_params(name, seed)
    return ["/".join(map(str, p)) + " " + digest(weights.get_leaf(params, p))
            for p in weights.paths(dims)]


def reference_readings(name: str) -> dict:
    """The reference's logits over fixed tokens (every position), its
    loss over a fixed batch, and the fp8 control's loss."""
    conf, _dims, params = cell_params(name, SEEDS[1])
    ref = core.reference(conf)
    rcfg = ref.sizes(conf)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, conf["vocab_size"], (20,), generator=gen)
    batch = torch.randint(0, conf["vocab_size"], (2, 24), generator=gen)
    with torch.no_grad():
        return {"logits": digest(ref.logits(params, toks, rcfg), 32),
                "loss": float(ref.loss(params, batch, rcfg)).hex(),
                "loss_fp8": float(ref.loss(params, batch, rcfg,
                                           quant="fp8")).hex()}


# ------------------------------------------------------------ the counts
def published(conf: dict) -> dict:
    return {**conf, **conf["published"]}


def model_sizes(conf: dict) -> dict:
    return counts.sizes(core.dims(conf))


def count_readings(conf: dict) -> dict:
    m = model_sizes(conf)
    out = {"total_params": counts.total_params(m),
           "layer_matmul_params": counts.layer_matmul_params(m),
           "layer_matmul_params_all": counts.layer_matmul_params(
               m, active_only=False)}
    for n in (1, 17, 1020, 3072, 4096):
        out[f"prefill_flops:{n}"] = counts.prefill_flops(m, n).hex()
    for rows, ctx in ((1, 1), (3, 1500), (256, 272_384), (256, 1_048_576)):
        c = counts.decode_step_counts(m, rows, ctx)
        out[f"decode:{rows}:{ctx}"] = [c["flops"].hex(), c["bytes"].hex()]
    for s in (1, 1000, 4096):
        out[f"train_flops_per_token:{s}"] = \
            counts.train_flops_per_token(m, s).hex()
    return out


def count_cases():
    for name in CONFIGS:
        conf = REG.config(name)
        yield name, conf
        if conf["published"] != {k: conf[k] for k in conf["published"]}:
            yield name + ":published", published(conf)


# ------------------------------------------------- the metrics' records
def chat_record(model: dict) -> dict:
    """A traced serving record: three engine steps, the program's spans
    around the harness's, kernels inside each."""
    spans, kernels = [], []

    def span(name, s, e):
        spans.append((name, s, e))
        return len(spans) - 1

    for i, (rows, ctx, plen) in enumerate(((256, 272_384, 1020),
                                           (255, 271_000, 0),
                                           (250, 260_123, 3000))):
        t = 1.7 * i
        span(f"llm.step:{rows}:{i}", t, t + 1.6)
        span("engine.step", t + 0.01, t + 1.59)
        if plen:
            span(f"llm.prefill:{plen}", t + 0.02, t + 0.5)
            p = span(f"model.prefill:{plen}", t + 0.03, t + 0.49)
            kernels.append(("flash_fwd_kernel", t + 0.1, 0.0123 * (i + 1),
                            p))
            kernels.append(("nvjet_gemm", t + 0.2, 0.0311, p))
        span(f"llm.decode:{rows}:{ctx}", t + 0.6, t + 1.5)
        d = span(f"model.decode:{rows}:{ctx}", t + 0.61, t + 1.49)
        kernels += [("rtt_paged_decode_attn<4, 128, 16>", t + 0.7,
                     0.0131 + 0.001 * i, d),
                    ("rtt_paged_decode_merge<128, 16>", t + 0.9, 0.00071, d),
                    ("nvjet_tst_256x128", t + 1.0, 0.0069, d),
                    ("elementwise_kernel", t + 1.2, 0.0022, d)]
    kernels.sort(key=lambda k: k[1])
    return {"kind": None, "model": model, "setup_s": 23.0625,
            "gaps_s": [0.001 * ((7 * j) % 113 + 150) for j in range(400)],
            "trace": {"spans": spans, "kernels": kernels, "busy_s": 1.75,
                      "window_s": 5.9}}


def train_record(model: dict) -> dict:
    """A traced training record: two steps with the program's spans, the
    flash backward and AdamW's kernels."""
    spans, kernels = [], []
    for step in range(2):
        t = 0.33 * step
        base = len(spans)
        spans += [("train.step:8192", t, t + 0.33),
                  ("train.loss:8192", t + 0.001, t + 0.1),
                  ("moe.route", t + 0.01, t + 0.03),
                  ("moe.dispatch", t + 0.03, t + 0.04),
                  ("moe.experts", t + 0.04, t + 0.06),
                  ("moe.combine", t + 0.06, t + 0.07),
                  ("train.backward", t + 0.1, t + 0.22),
                  ("train.optimizer", t + 0.22, t + 0.329),
                  ("Optimizer.step#AdamW.step", t + 0.221, t + 0.328)]
        kernels += [("nvjet_gemm", t + 0.002, 0.004, base + 1),
                    ("route_cumsum", t + 0.011, 0.0151, base + 2),
                    ("dispatch_einsum", t + 0.031, 0.0032, base + 3),
                    ("expert_gemm", t + 0.041, 0.0121, base + 4),
                    ("combine_einsum", t + 0.061, 0.0049, base + 5),
                    ("flash_bwd_dkdv_kernel", t + 0.11, 0.00161, base + 6),
                    ("flash_bwd_dq_kernel", t + 0.113, 0.00125, base + 6),
                    ("flash_bwd_dkdv_kernel", t + 0.12, 0.00163, base + 6),
                    ("flash_bwd_dq_kernel", t + 0.123, 0.00124, base + 6),
                    ("multi_tensor_apply_kernel", t + 0.23, 0.091, base + 8)]
    return {"kind": "train", "model": model, "setup_s": 20.5,
            "window_s": 50.0078125, "steps": 155, "tokens": 155 * 8192,
            "flops_per_token": counts.train_flops_per_token(model, 4096),
            "rate_untraced": 25011.5, "enqueue_s": [0.3217, 0.3221, 0.3209],
            "attention": {"batch": 2, "seq": 4096},
            "trace": {"spans": spans, "kernels": kernels, "busy_s": 0.651,
                      "window_s": 0.66}}


def metric_readings(cell: str) -> dict:
    conf = REG.cell(cell)["config"]
    model = model_sizes(conf)
    rec = (train_record if conf.get("optimizer") else chat_record)(model)
    out = {}
    for per_layer in (False, True):
        for m in REG.metrics_for(cell, per_layer):
            v = REG.reader(m["name"])(rec)
            out[m["name"]] = None if v is None else float(v).hex()
    return out


# ------------------------------------------------------- the literals
# the parent's readings; a leaf, and the logits, by the first hex digits
# of the SHA-256 of their bytes
LEAVES = {
    'mistral-7b': {
        1: [
            'embed dd19b279ece7701e',
            'layers/0/attn_norm fb0d11c21d46d55f',
            'layers/1/attn_norm f6f422a69ee98a0d',
            'layers/0/wq aeb9aa408559fb21',
            'layers/1/wq c4971f2d83018535',
            'layers/0/wk 74c5f03a744807c9',
            'layers/1/wk 32985a493097c8c9',
            'layers/0/wv e3eeea28dae7e9f6',
            'layers/1/wv 4efe72bf14877966',
            'layers/0/wo a822400e0f21d684',
            'layers/1/wo 87098badcf4087fe',
            'layers/0/mlp_norm a100a8584a20de59',
            'layers/1/mlp_norm 0492e5d707160ae0',
            'layers/0/gate 73a2f943f22941b7',
            'layers/1/gate 98b753456211b997',
            'layers/0/up 2e02ccc2ac377622',
            'layers/1/up cad5c99b7b244cb1',
            'layers/0/down badb62a04409ec02',
            'layers/1/down 12b5c533be606809',
            'final_norm 6ceb984d4770b362',
            'lm_head a1ce27ec8bc18256',
        ],
        2147483655: [
            'embed 0d28ff387c3e2b5a',
            'layers/0/attn_norm 25225b5093598f5b',
            'layers/1/attn_norm 9a9a45f15cd46d85',
            'layers/0/wq 496c522f7603ace7',
            'layers/1/wq e815c1044a0c1cea',
            'layers/0/wk f447cdd3c43facac',
            'layers/1/wk 6435bdeda9439612',
            'layers/0/wv 621952fc40bfca94',
            'layers/1/wv 2d422c21e82ad8b6',
            'layers/0/wo 0ae4f5a2e3e328e5',
            'layers/1/wo 3fe2b0d2812c3f62',
            'layers/0/mlp_norm 4030146181f0cd69',
            'layers/1/mlp_norm 69526a6c24881e54',
            'layers/0/gate 07e89439597925e9',
            'layers/1/gate cac359f47c9d307f',
            'layers/0/up b68f3e0615ad1f92',
            'layers/1/up 794f660b3a0e28f6',
            'layers/0/down d8670f7c7ea99aaa',
            'layers/1/down e0a0d6dd004df2da',
            'final_norm 0be1a1e1033dd1ed',
            'lm_head 3fa9955a0ed2d001',
        ],
    },
    'mixtral-8x7b': {
        1: [
            'embed e3a63ffe8c41d892',
            'layers/0/attn_norm 924b8185d10e2f85',
            'layers/1/attn_norm c3ad4c2320077005',
            'layers/0/wq 146d2970671939a1',
            'layers/1/wq c3d03796b9e2a785',
            'layers/0/wk c280d18baaf69c1e',
            'layers/1/wk 9b966460bf6b4a3b',
            'layers/0/wv af6dcc3b235371f3',
            'layers/1/wv 848abbbd813d029e',
            'layers/0/wo 5869aad24bb01b34',
            'layers/1/wo 8d5b24fdd74d460c',
            'layers/0/mlp_norm 165ee5f7b6847263',
            'layers/1/mlp_norm 9269b0b19d936f44',
            'layers/0/router 5f6550a54cb5e5bb',
            'layers/1/router 69b07063d2aa2341',
            'layers/0/moe_gate a1858887fe40d696',
            'layers/1/moe_gate 338d50f3c64d7b66',
            'layers/0/moe_up 425971ab32125f7d',
            'layers/1/moe_up cf03a7aba6361780',
            'layers/0/moe_down 3e856929b6ff1c88',
            'layers/1/moe_down 3fd579c52831b349',
            'final_norm f4a9bdf97cada26c',
            'lm_head 989548abb3c9c368',
        ],
        2147483655: [
            'embed a2128d8c5e410e91',
            'layers/0/attn_norm 641dc674325a9997',
            'layers/1/attn_norm 975cf322404b8198',
            'layers/0/wq 53ae15332576666b',
            'layers/1/wq 2bc3c8403da665a3',
            'layers/0/wk f6d4c839171e0581',
            'layers/1/wk 2444760afe809d79',
            'layers/0/wv ed7b6d028c86dc49',
            'layers/1/wv 0cf18d9b3ffae265',
            'layers/0/wo e16973f73b7c3793',
            'layers/1/wo fa17f6c10b8169ce',
            'layers/0/mlp_norm 71f73b2808cdf627',
            'layers/1/mlp_norm 0e413f4296dfd119',
            'layers/0/router 842d566a9b91db81',
            'layers/1/router 6b78d4e99c2f3700',
            'layers/0/moe_gate 20154711d5e573ff',
            'layers/1/moe_gate f13c9cd49172ea54',
            'layers/0/moe_up e4fdab9eb721d551',
            'layers/1/moe_up 1a2e762999d3cf81',
            'layers/0/moe_down a4718875fbda5bc5',
            'layers/1/moe_down 6e9254250305273b',
            'final_norm 40c47846bd1f9469',
            'lm_head e553a7b8b1a36eaf',
        ],
    },
}
REFERENCE = {
    'mistral-7b': {
        'logits': 'a910d2399cf124424548a4f6e7c6005e',
        'loss': '0x1.7682ce0000000p+2', 'loss_fp8': '0x1.761ca20000000p+2'},
    'mixtral-8x7b': {
        'logits': '299d3c0ab90c49fee8690566b951839d',
        'loss': '0x1.809a0a0000000p+2', 'loss_fp8': '0x1.7fdca80000000p+2'},
}
COUNTS = {
    'mistral-7b': {
        'total_params': 7248023552,
        'layer_matmul_params': 218103808,
        'layer_matmul_params_all': 218103808,
        'prefill_flops:1': '0x1.a804000000000p+33',
        'prefill_flops:17': '0x1.baa6400000000p+37',
        'prefill_flops:1020': '0x1.a654060000000p+43',
        'prefill_flops:3072': '0x1.4a02000000000p+45',
        'prefill_flops:4096': '0x1.c002800000000p+45',
        'decode:1:1': ['0x1.a804000000000p+33', '0x1.a802000000000p+33'],
        'decode:3:1500': ['0x1.43dc000000000p+35', '0x1.addf000000000p+33'],
        'decode:256:272384':
            ['0x1.b8a0000000000p+41', '0x1.7440000000000p+35'],
        'decode:256:1048576':
            ['0x1.e800000000000p+41', '0x1.1a90000000000p+37'],
        'train_flops_per_token:1': '0x1.3e03000000000p+35',
        'train_flops_per_token:1000': '0x1.43dd800000000p+35',
        'train_flops_per_token:4096': '0x1.5601800000000p+35',
    },
    'mistral-7b:published': {
        'total_params': 7248023552,
        'layer_matmul_params': 218103808,
        'layer_matmul_params_all': 218103808,
        'prefill_flops:1': '0x1.a804000000000p+33',
        'prefill_flops:17': '0x1.baa6400000000p+37',
        'prefill_flops:1020': '0x1.a654060000000p+43',
        'prefill_flops:3072': '0x1.4a02000000000p+45',
        'prefill_flops:4096': '0x1.c002800000000p+45',
        'decode:1:1': ['0x1.a804000000000p+33', '0x1.a802000000000p+33'],
        'decode:3:1500': ['0x1.43dc000000000p+35', '0x1.addf000000000p+33'],
        'decode:256:272384':
            ['0x1.b8a0000000000p+41', '0x1.7440000000000p+35'],
        'decode:256:1048576':
            ['0x1.e800000000000p+41', '0x1.1a90000000000p+37'],
        'train_flops_per_token:1': '0x1.3e03000000000p+35',
        'train_flops_per_token:1000': '0x1.43dd800000000p+35',
        'train_flops_per_token:4096': '0x1.5601800000000p+35',
    },
    'mixtral-8x7b': {
        'total_params': 3164688384,
        'layer_matmul_params': 394297344,
        'layer_matmul_params_all': 1451261952,
        'prefill_flops:1': '0x1.b68a000000000p+30',
        'prefill_flops:17': '0x1.9383a00000000p+34',
        'prefill_flops:1020': '0x1.7a989b0000000p+40',
        'prefill_flops:3072': '0x1.230aa80000000p+42',
        'prefill_flops:4096': '0x1.880ce80000000p+42',
        'decode:1:1': ['0x1.b68a000000000p+30', '0x1.69a2400000000p+32'],
        'decode:3:1500': ['0x1.4bd4000000000p+32', '0x1.6a5de00000000p+32'],
        'decode:256:272384':
            ['0x1.bed8000000000p+38', '0x1.eec2000000000p+32'],
        'decode:256:1048576':
            ['0x1.d688000000000p+38', '0x1.b4e1000000000p+33'],
        'train_flops_per_token:1': '0x1.48e7800000000p+32',
        'train_flops_per_token:1000': '0x1.4bd4c00000000p+32',
        'train_flops_per_token:4096': '0x1.54e6c00000000p+32',
    },
    'mixtral-8x7b:published': {
        'total_params': 46702792704,
        'layer_matmul_params': 394297344,
        'layer_matmul_params_all': 1451261952,
        'prefill_flops:1': '0x1.7bf2000000000p+34',
        'prefill_flops:17': '0x1.8fda200000000p+38',
        'prefill_flops:1020': '0x1.7a89f50000000p+44',
        'prefill_flops:3072': '0x1.2306fe8000000p+46',
        'prefill_flops:4096': '0x1.88093e8000000p+46',
        'decode:1:1': ['0x1.7bf2000000000p+34', '0x1.5afc400000000p+36'],
        'decode:3:1500': ['0x1.1fe2000000000p+36', '0x1.5bb7e00000000p+36'],
        'decode:256:272384':
            ['0x1.8440000000000p+42', '0x1.e01c000000000p+36'],
        'decode:256:1048576':
            ['0x1.9bf0000000000p+42', '0x1.ad8e000000000p+37'],
        'train_flops_per_token:1': '0x1.1cf5800000000p+36',
        'train_flops_per_token:1000': '0x1.1fe2c00000000p+36',
        'train_flops_per_token:4096': '0x1.28f4c00000000p+36',
    },
}
METRICS = {
    'mistral-7b.chat': {
        'setup_s': '0x1.7100000000000p+4',
        'tpot_p95_ms': '0x1.0100000000000p+8',
        'mfu.decode': '0x1.ed0dc3e276703p+5',
        'device_idle_share.chat': '0x1.195b1e5f75271p+6',
        'lock_wait_p95_ms.chat': None,
        'engine_host_idle_share.chat': '0x1.35270d0456c76p+4',
        'decode_attn_roofline.chat': '0x1.1c5fcc216fee7p+6',
    },
    'mixtral-8x7b.train': {
        'setup_s': '0x1.4800000000000p+4',
        'train_tok_s': '0x1.8cbcee33e9719p+14',
        'mfu.train': '0x1.ceda1706949cbp+3',
        'flash_bwd_roofline.train': '0x1.84230b6554a10p+4',
        'host_enqueue_ms.train': '0x1.4191111111111p+8',
        'device_idle_share.train': '0x1.5d1745d1745e0p+0',
        'adamw_roofline.train': '0x1.d113234294966p+4',
        'moe_dispatch_ms.train': '0x1.7333333333334p+4',
        'moe_dropped_pct.train': None,
    },
}


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_weights_are_the_same_bits(name, seed):
    assert leaf_digests(name, seed) == LEAVES[name][seed]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_reference_reads_the_same_bits(name):
    assert reference_readings(name) == REFERENCE[name]


@pytest.mark.parametrize("case", list(COUNTS))
def test_the_counts_at_published_sizes(case):
    assert count_readings(dict(count_cases())[case]) == COUNTS[case]


@pytest.mark.parametrize("cell", list(METRICS))
def test_every_metric_reads_the_same_value(cell):
    assert metric_readings(cell) == METRICS[cell]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_record_sizes_are_the_programs(name):
    """`rec["model"]`, built from the architecture's sizes, holds the
    numbers the program's config gave it (a dense model's unused top-k
    aside), and each layer's window and FFN kind."""
    conf = REG.config(name)
    got = model_sizes(conf)
    cfg = core.model_config(conf)
    want = {"d": cfg.d_model, "f": cfg.d_ff, "layers": cfg.n_layers,
            "heads": cfg.n_heads, "kv_heads": cfg.kv_heads,
            "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
            "experts": cfg.moe_num_experts}
    if cfg.moe_num_experts:
        want["top_k"] = cfg.moe_top_k
    assert {k: got[k] for k in want} == want
    assert got["windows"] == [0] * cfg.n_layers
    kind = "experts" if cfg.moe_num_experts else "dense"
    assert got["ffn"] == [kind] * cfg.n_layers and got["f_expert"] == cfg.d_ff


def test_decode_attention_bytes_are_the_metric_files():
    """`counts.decode_attn_bytes`, which later metric files read, gives
    the bytes `decode_attn_roofline.chat` counts itself."""
    m = model_sizes(REG.config("mistral-7b"))
    for rows, ctx in ((1, 1), (256, 272_384)):
        kv = 2 * counts.BF16 * m["kv_heads"] * m["head_dim"] * (ctx + rows)
        qo = 2 * counts.BF16 * m["heads"] * m["head_dim"] * rows
        assert counts.decode_attn_bytes(m, rows, ctx) == \
            m["layers"] * (kv + qo)
