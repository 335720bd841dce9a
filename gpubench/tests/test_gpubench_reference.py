"""The plain reference against the port at tiny widths, in float32 on
the CPU: prefill then decode through the paged cache, the loss and its
gradients (dense and with experts), the expert layer with dropped
tokens, and the AdamW step. The test imports both; the reference
imports nothing of the port (test_gpubench_hygiene.py)."""
import copy

import pytest
import torch

from tiny import TINY

from gpubench import core, weights
from gpubench.reference import decoder

REG = core.Registry()


def config(name, **kw):
    conf = copy.deepcopy(REG.config(name))
    conf.update(TINY)
    conf.update(kw)
    conf["run"] = {**conf["run"], "dtype": "float32",
                   "param_dtype": "float32", "remat": False}
    return conf


@pytest.mark.parametrize("seed", [0, 3])
def test_prefill_then_decode_match_the_reference(seed):
    from ray_tpu_torch.models import decode
    from ray_tpu_torch.models.transformer import Transformer
    conf = config("mistral-7b")
    cfg = core.model_config(conf)
    params = weights.make_params(core.dims(conf), seed, "cpu",
                                 torch.float32, stacked=True)
    toks = torch.randint(0, cfg.vocab_size, (20,),
                         generator=torch.Generator().manual_seed(seed))
    ref = decoder.logits(params, toks, decoder.sizes(conf))
    model, page = Transformer(cfg), 4
    cache = decode.init_paged_cache(cfg, 16, page, device="cpu")
    table = torch.arange(8, dtype=torch.int32)
    n = 13                                    # prefill 13, pad to 16
    padded = torch.zeros(16, dtype=torch.long)
    padded[:n] = toks[:n]
    got, cache = decode.prefill(model, params, padded, n, table, cache,
                                page)
    torch.testing.assert_close(got, ref[n - 1], rtol=1e-4, atol=1e-4)
    # two decode rows: the sequence, and an inactive padding row
    for pos in range(n, 20):
        logits, cache = decode.decode_step(
            model, params, cache, torch.tensor([int(toks[pos]), 0]),
            torch.tensor([pos, 0]), torch.stack([table, table * 0 - 1]),
            torch.tensor([True, False]), page)
        torch.testing.assert_close(logits[0], ref[pos], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["mistral-7b", "mixtral-8x7b"])
def test_loss_and_gradients_match_the_reference(name):
    from ray_tpu_torch.models.transformer import Transformer
    conf = config(name)
    cfg = core.model_config(conf)
    dims = core.dims(conf)
    params = weights.make_params(dims, 5, "cpu", torch.float32,
                                 stacked=False)
    paths = weights.paths(dims)
    leaves = [weights.get_leaf(params, p) for p in paths]
    for t in leaves:
        t.requires_grad_(True)
    batch = torch.randint(0, cfg.vocab_size, (2, 24),
                          generator=torch.Generator().manual_seed(1))
    got = Transformer(cfg).loss(params, {"tokens": batch})
    want = decoder.loss(params, batch, decoder.sizes(conf))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    g1 = torch.autograd.grad(got, leaves)
    g2 = torch.autograd.grad(want, leaves)
    for p, a, b in zip(paths, g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=str(p))


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_the_expert_layer_drops_as_the_port_does(cf):
    from ray_tpu_torch.models.moe import moe_ffn
    conf = config("mixtral-8x7b")
    dims = core.dims(conf)
    p = weights.make_params(dims, 2, "cpu", torch.float32,
                            stacked=False)["layers"][0]
    x = torch.randn(2, 24, dims.d_model,
                    generator=torch.Generator().manual_seed(4))
    y, aux = moe_ffn(x, p["router"], p["moe_gate"], p["moe_up"],
                     p["moe_down"], top_k=2, capacity_factor=cf)
    rcfg = {**decoder.sizes(conf), "capacity_factor": cf}
    want, lb = decoder.moe(x.reshape(-1, dims.d_model), p, rcfg, None)
    torch.testing.assert_close(y.reshape(-1, dims.d_model), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux["moe_load_balance_loss"], lb)


def test_adamw_matches_the_programs_optimizer():
    from ray_tpu_torch import bench
    conf = REG.config("mixtral-8x7b")["optimizer"]
    gen = torch.Generator().manual_seed(0)
    a = [torch.randn(5, 3, generator=gen), torch.randn(7, generator=gen)]
    b = [t.clone() for t in a]
    opt = bench.make_optimizer({"embed": a[0], "layers": [],
                                "final_norm": a[1]})
    ref = decoder.AdamW(b, lr=conf["lr"], betas=conf["betas"],
                        eps=conf["eps"], weight_decay=conf["weight_decay"])
    for _ in range(3):
        grads = [torch.randn(t.shape, generator=gen) for t in a]
        for t, g in zip(a, grads):
            t.grad = g.clone()
        opt.step()
        ref.step(grads)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.detach(), y, rtol=0, atol=1e-7)


def test_the_fp8_control_rounds_every_product():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 64, generator=gen, requires_grad=True)
    w = torch.randn(64, 8, generator=gen, requires_grad=True)
    g = torch.randn(4, 8, generator=gen)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    exact, low = decoder.mm(x, w, None), decoder.mm(x, w, "fp8")
    assert 5e-3 < rel(low, exact) < 0.1      # e4m3: 3 mantissa bits
    gx, gw = torch.autograd.grad(exact, (x, w), g)
    lx, lw = torch.autograd.grad(low, (x, w), g)
    assert 5e-3 < rel(lx, gx) < 0.1 and 5e-3 < rel(lw, gw) < 0.1
