"""Back-to-back training steps: `ray_tpu_torch.bench.train_step` (the
loss, its backward, AdamW) on batches of `batch` x `seq` tokens drawn
from the seed over the whole vocabulary, the next step queued as soon
as the host can (at most two steps ahead of the card).

Set-up builds the one training object (the model, the weights made
from the seed, `bench.make_optimizer`) and drives it through its first
`reference_steps` steps by the same call and feed as the window, reading
what the reference checks: each step's loss, the first gradient as the
optimizer got it (AdamW's first moment after one step over 1 - beta1),
and the norm of each leaf's change over those steps. The window then
continues the same object.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from types import SimpleNamespace

import torch

from gpubench import core, counts, judge, weights
from gpubench.trace import Profile, slice_s


def batches(cfg, p: dict, seed: int, device):
    """An endless feed of (batch, seq) token batches from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + 17) % (1 << 63))
    while True:
        yield torch.randint(0, cfg.vocab_size, (p["batch"], p["seq"]),
                            generator=gen, device=device)


def first_gradients(opt, paths, leaves, seed: int):
    """(norms, sampled elements) of each leaf's first gradient as the
    optimizer got it, from AdamW's state after one step:
    m_1 = (1 - beta1) g_1 (zero where the optimizer holds no state).
    One leaf at a time, so no copy of the whole gradient is held."""
    b1 = opt.param_groups[0]["betas"][0]
    norms, sample = {}, {}
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        m = opt.state.get(leaf, {}).get("exp_avg")
        g = torch.zeros_like(leaf) if m is None else m.float() / (1 - b1)
        norms[path] = float(g.norm())
        sample.update(judge.grad_sample([path], [g], seed, first=i))
        del g
    return norms, sample


def check_optimizer(opt, conf: dict) -> None:
    """The reference follows the config's optimizer: refuse a program
    whose optimizer is set otherwise."""
    g = opt.param_groups[0]
    got = {"lr": g["lr"], "betas": list(g["betas"]), "eps": g["eps"],
           "weight_decay": g["weight_decay"]}
    if got != {k: conf[k] for k in got}:
        raise RuntimeError(f"optimizer {got} is not the config's {conf}")


def start(cell, seed: int, device):
    """The one training object (model, weights from the seed, optimizer,
    feed), driven through its first `reference_steps` steps by the
    window's own call and feed, and what the reference checks of them."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models.transformer import Transformer
    conf, p = cell["config"], cell["params"]
    cfg = core.model_config(conf)
    dims = core.dims(conf)
    params = weights.make_params(dims, seed, device, cfg.parameter_dtype,
                                 stacked=False)
    paths = weights.paths(dims)
    leaves = [weights.get_leaf(params, q) for q in paths]
    model = Transformer(cfg)
    opt = bench.make_optimizer(params)
    check_optimizer(opt, conf["optimizer"])
    feed = batches(cfg, p, seed, device)
    first = [next(feed) for _ in range(int(p["reference_steps"]))]
    prog = {"losses": []}
    for i, batch in enumerate(first):
        loss = bench.train_step(model, params, opt, {"tokens": batch})
        prog["losses"].append(float(loss))
        if i == 0:
            prog["grad_norms"], prog["grad_sample"] = first_gradients(
                opt, paths, leaves, seed)
    prog["update_norms"] = judge.change_norms(
        dims, seed, device, dict(zip(paths, leaves)))
    return SimpleNamespace(cfg=cfg, dims=dims, params=params, model=model,
                           opt=opt, feed=feed, first=first, prog=prog,
                           loss=loss)


def run(cell, seed, seconds, trace, device, t_start, control=False):
    from ray_tpu_torch import bench
    seed = core.seed_of(seed)
    p = cell["params"]
    phases = {"imports": time.perf_counter() - t_start}
    st = start(cell, seed, device)
    cfg, dims, params, model, opt, feed, first, prog = (
        st.cfg, st.dims, st.params, st.model, st.opt, st.feed, st.first,
        st.prog)
    loss = batch = st.loss
    del st
    phases["first_steps"] = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start

    tokens_per_step = p["batch"] * p["seq"]
    prof = Profile() if trace else None
    span = _span if trace else _no_span
    split = seconds - slice_s(seconds) if trace else None
    enqueue, pending = [], collections.deque()
    steps = steps_before = 0
    t_split = None
    window_losses = []
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        if split is not None and t_split is None \
                and time.perf_counter() - t0 >= split:
            sync()
            t_split, steps_before = time.perf_counter(), steps
            prof.start()
        batch = next(feed)
        ts = time.perf_counter()
        with span(f"train.step:{tokens_per_step}"):
            loss = bench.train_step(model, params, opt, {"tokens": batch})
        if t_split is None:
            enqueue.append(time.perf_counter() - ts)
        window_losses.append(loss)
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.popleft().synchronize()
        steps += 1
    sync()
    t1 = time.perf_counter()
    traced = prof.stop() if prof is not None and t_split is not None \
        else None
    finite = (not window_losses
              or bool(torch.isfinite(torch.stack(window_losses)).all()))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del params, model, opt, loss, batch, window_losses, pending
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, ref, loss_gap = judge.training(cell, seed, prog, first,
                                           device)
    checks["window_losses_finite"] = core.check(
        0.0 if finite else 1.0, cell["limits"]["window_losses_finite"])
    m = counts.sizes(dims)
    before_s = (t_split - t0) if t_split is not None else (t1 - t0)
    phases["readings"] = setup_s
    return {
        "kind": "train", "setup_s": setup_s, "setup_phases_s": phases,
        "window_s": t1 - t0,
        "steps": steps, "tokens": steps * tokens_per_step,
        "attempted": steps, "failed": 0,
        "tokens_per_step": tokens_per_step,
        "flops_per_token": counts.train_flops_per_token(m, p["seq"]),
        "rate_untraced": (steps_before if t_split is not None else steps)
        * tokens_per_step / before_s,
        "enqueue_s": enqueue, "trace": traced, "model": m,
        "attention": {"batch": p["batch"], "seq": p["seq"]},
        "peak_bytes": peak, "checks": checks, "seed": seed,
        "notes": {"worst_leaves": judge.worst_leaves(prog, ref),
                  "loss_gap": loss_gap},
        "first_batches": first,
    }


def _no_span(name):
    return contextlib.nullcontext()


def _span(name):
    from torch.profiler import record_function
    return record_function(name)
