"""The comparison that decides `correct`, against the plain reference.

Serving: a sample of the requests that were served tokens (finished,
or still in flight when the window closed: their tokens so far), drawn
from the seed with the longest among them, until it holds
`sample_tokens` served tokens.
The reference runs once over each prompt with its served tokens, and
the number compared is the widest gap by which a served token's logit
lies below the reference's best at its position (0 where the program
chose the reference's argmax). With `control`, the same positions are
read under the reference in fp8 (its `mm` with `quant="fp8"`): the gap
of the token that the fp8 reference puts first.

The reference is the configuration's own (`core.reference`: the module
under `reference/` that its architecture names).

Training: see `training`.

Each limit is the cell's own (`workloads/<cell>.json`, "limits"), set
from the readings that `PERF.md` gives.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Optional

import torch

from gpubench import core, load, weights


def sample(served: list, seed: int, want_tokens: int) -> list:
    """The longest served request (prompt and output), then others in
    an order drawn from the seed, until `want_tokens` served tokens."""
    if not served:
        return []
    pool = sorted(served, key=lambda r: r.rid)
    longest = max(pool, key=lambda r: (len(r.prompt) + len(r.toks), r.rid))
    rest = [r for r in pool if r is not longest]
    order = load.rng(seed, 7).permutation(len(rest))
    out, n = [longest], len(longest.toks)
    for i in order:
        if n >= want_tokens:
            break
        out.append(rest[i])
        n += len(rest[i].toks)
    return out


def serving(cell: dict, seed: int, served: list, device,
            sample_tokens: int = 400,
            control: bool = False):
    """(checks, sample summary) of a serving run."""
    limits = cell["limits"]
    picked = sample(served, seed, sample_tokens)
    conf = cell["config"]
    ref_mod = core.reference(conf)
    rcfg = ref_mod.sizes(conf)
    ref_mod.no_tf32()
    params = weights.make_params(core.dims(conf), seed, device,
                                 served_dtype(conf), stacked=True)
    gap, ctrl = 0.0, 0.0
    served = 0
    for r in picked:
        toks = torch.tensor(r.prompt + r.toks[:-1], device=device)
        pos = slice(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.toks))
        ref = ref_mod.logits(params, toks, rcfg, rows=pos)
        got = torch.tensor(r.toks, device=device)
        best = ref.max(dim=-1).values
        gap = max(gap, float((best - ref.gather(1, got[:, None])[:, 0])
                             .max()))
        if control:
            low = ref_mod.logits(params, toks, rcfg, quant="fp8",
                                 rows=pos)
            pick = low.argmax(dim=-1)
            ctrl = max(ctrl, float((best - ref.gather(1, pick[:, None])
                                    [:, 0]).max()))
            del low
        served += len(r.toks)
        del ref
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = {"logit_gap": core.check(gap if picked else None,
                                      limits["logit_gap"])}
    summary = {"requests": len(picked), "tokens": served,
               "longest": max((len(r.prompt) + len(r.toks) for r in picked),
                              default=0)}
    if control:
        summary["control_logit_gap"] = ctrl
    return checks, summary


# ---------------------------------------------------------------- training
def rel_gap(got: float, want: float, floor: float) -> float:
    """|got - want| over the larger of |want| and `floor`."""
    return abs(got - want) / max(abs(want), floor)


def worst_leaf(got: Dict[tuple, float], want: Dict[tuple, float],
               keep: Optional[set] = None) -> float:
    """The worst leaf's gap between two norms, each measured against the
    reference's norm of that leaf or the median leaf's, whichever is
    larger (some gradients are all but zero)."""
    names = [p for p in want if keep is None or p in keep]
    med = sorted(want[p] for p in names)[len(names) // 2]
    return max(rel_gap(got[p], want[p], med) for p in names)


def moved_leaves(grad_norms: Dict[tuple, float]) -> set:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = sorted(grad_norms.values())[len(grad_norms) // 2]
    return {p for p, g in grad_norms.items() if g > 1e-3 * med}


SAMPLE = 65536      # elements of each leaf's first gradient compared


def sample_index(numel: int, seed: int, salt: int) -> torch.Tensor:
    """A seeded sample of a leaf's flat positions (on the CPU, the same
    for the program's side and the reference's)."""
    g = torch.Generator().manual_seed((seed * 7919 + salt) % (1 << 63))
    n = min(numel, SAMPLE)
    return torch.randint(0, numel, (n,), generator=g)


def grad_sample(paths, grads, seed: int, first: int = 0
                ) -> Dict[tuple, torch.Tensor]:
    """Each leaf's first gradient at its sampled positions (f32, CPU);
    `first` is the first leaf's place in `weights.paths` order."""
    out = {}
    for i, (p, g) in enumerate(zip(paths, grads), start=first):
        flat = g.detach().reshape(-1)
        idx = sample_index(flat.numel(), seed, i).to(flat.device)
        out[p] = flat[idx].float().cpu()
    return out


def sample_gaps(got: Dict[tuple, torch.Tensor],
                want: Dict[tuple, torch.Tensor]) -> Dict[tuple, float]:
    """Each leaf's distance between the program's and the reference's
    sampled first gradient, over the reference's sample norm or the
    median leaf's, whichever is larger: the gradient's error itself,
    which a lower precision moves and a norm barely does."""
    norms = {p: float(w.norm()) for p, w in want.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {p: float((got[p] - want[p]).norm()) / max(norms[p], med)
            for p in want}


def upper_decile(values) -> float:
    """The value at the 90th percentile (nearest rank from 0): of 25
    leaves, the third largest."""
    v = sorted(values)
    return v[int(0.9 * (len(v) - 1) + 0.5)]


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared: the worst step's loss gap (relative), the
    worst leaf's gap of the first gradient's norm, the worst moved
    leaf's gap of the norm of the change over the steps, and the
    distance of the first gradient on a seeded sample of each leaf's
    elements, at the 90th-percentile leaf. (The two worst leaves there
    are the routers, whose gradient jumps wherever rounding flips a near
    tie between two experts, in the program and in the control alike;
    the median leaf sits among expert and attention leaves whose order
    changes from seed to seed. The upper leaves, attention's projections
    and norms, carry the precision's error most steadily.)"""
    loss = max(rel_gap(a, b, 1e-6) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    return {"loss_gap": loss,
            "grad_norm_gap": worst_leaf(prog["grad_norms"],
                                        ref["grad_norms"]),
            "update_norm_gap": worst_leaf(prog["update_norms"],
                                          ref["update_norms"],
                                          moved_leaves(ref["grad_norms"])),
            "grad_sample_gap": upper_decile(sample_gaps(
                prog["grad_sample"], ref["grad_sample"]).values())}


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """Which leaf sets each per-leaf number, and the worst leaf's sampled
    distance (for the readings' notes)."""
    def arg(got, want):
        med = sorted(want.values())[len(want) // 2]
        return "/".join(map(str, max(want, key=lambda p: rel_gap(
            got[p], want[p], med))))
    gaps = sample_gaps(prog["grad_sample"], ref["grad_sample"])
    worst = max(gaps, key=gaps.get)
    return {"grad_norm_gap": arg(prog["grad_norms"], ref["grad_norms"]),
            "update_norm_gap": arg(prog["update_norms"],
                                   ref["update_norms"]),
            "grad_sample_worst": ["/".join(map(str, worst)), gaps[worst]]}


def reference_training(cell: dict, seed: int, batches: List[torch.Tensor],
                       device, quant: Optional[str] = None,
                       rows: Optional[int] = None) -> dict:
    """The reference's own run of the program's first steps, from the
    seed's weights: each step's loss, the first gradient's norm a leaf,
    and the norm of each leaf's change over the steps. `quant` computes
    it in a lower precision (the control); `rows` keeps only the first
    rows of each batch (a fault: part of the batch left out, the mean
    taken over the rest)."""
    conf = cell["config"]
    dims = core.dims(conf)
    ref_mod = core.reference(conf)
    rcfg = ref_mod.sizes(conf)
    opt_conf = conf["optimizer"]
    ref_mod.no_tf32()
    params = weights.make_params(dims, seed, device, torch.float32,
                                 stacked=False)
    paths = weights.paths(dims)
    leaves = [weights.get_leaf(params, p) for p in paths]
    for t in leaves:
        t.requires_grad_(True)
    opt = ref_mod.AdamW(leaves, lr=opt_conf["lr"],
                        betas=tuple(opt_conf["betas"]), eps=opt_conf["eps"],
                        weight_decay=opt_conf["weight_decay"])
    losses, grad_norms = [], {}
    for i, batch in enumerate(batches):
        loss = ref_mod.loss(params, batch[:rows], rcfg, quant=quant)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if i == 0:
            grad_norms = {p: float(g.norm()) for p, g in zip(paths, grads)}
            sampled = grad_sample(paths, grads, seed)
        opt.step(grads)
        del grads, loss
    del opt
    update_norms = change_norms(dims, seed, device,
                                {p: t.detach() for p, t in
                                 zip(paths, leaves)})
    del params, leaves
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": grad_norms,
            "update_norms": update_norms, "grad_sample": sampled}


@torch.no_grad()
def change_norms(dims, seed: int, device, now: Dict[tuple, torch.Tensor]
                 ) -> Dict[tuple, float]:
    """||leaf now - leaf at the start|| a leaf; the start made again from
    the seed (`core.dims` of the config), one leaf at a time."""
    out = {}
    for path, start in weights.iter_leaves(dims, seed, device,
                                           torch.float32, stacked=False):
        out[path] = float((now[path].to(torch.float32) - start).norm())
        del start
    return out


def training(cell: dict, seed: int, prog: dict, batches, device):
    """(checks, the reference's readings) of a training run."""
    ref = reference_training(cell, seed, batches, device)
    nums = training_numbers(prog, ref)
    return training_checks(nums, cell["limits"]), ref, nums["loss_gap"]


def training_checks(nums: Dict[str, float], limits: dict) -> dict:
    """`training_numbers` beside the cell's limits. The loss gap has no
    upper reading (neither the control nor a fault reads ten times the
    program's): it is reported, not compared."""
    return {k: core.check(v, limits[k]) for k, v in nums.items()
            if k != "loss_gap"}


def served_dtype(config: dict) -> torch.dtype:
    """The dtype the weights are served in (the activation dtype)."""
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[config["run"]["dtype"]]
