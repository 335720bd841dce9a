"""An open loop of independent users: Poisson arrivals at `rate_per_s`,
each request timed from the moment it was due, whether or not the
engine has caught up.

Mix parameters: `rate_per_s` (set for each cell, from the sweep),
`prompt_tokens` and `output_tokens` (distributions, `load.py`), and
`block`: arrivals in blocks of that many requests, each block with the
same gaps and lengths in its own order (0: one block, the window).
Every seed gets the same gaps and the same lengths, in its own order.
"""
from __future__ import annotations

from gpubench import load, serving
from gpubench.serving import Req


def schedule(cfg, p: dict, seed: int, seconds: float):
    block = int(p.get("block", 0))
    due = load.arrivals(float(p["rate_per_s"]), seconds, seed, 4, block)
    n = len(due)
    if block:
        rounds = -(-n // block)
        plen = load.rounds(p["prompt_tokens"], block, rounds, seed, 1)[:n]
        olen = load.rounds(p["output_tokens"], block, rounds, seed, 2)[:n]
    else:
        plen = load.lengths(p["prompt_tokens"], n, seed, 1)
        olen = load.lengths(p["output_tokens"], n, seed, 2)
    prompts = load.prompts(plen, cfg.vocab_size, seed, 3)
    reqs = [Req(f"o{j}", pr, m, due=t)
            for j, (pr, m, t) in enumerate(zip(prompts, olen, due))]
    return reqs, sorted(set(plen))


def run(cell, seed, seconds, trace, device, t_start, control=False):
    return serving.run_cell(cell, seed, seconds, trace, device, t_start,
                            closed_loop=False, schedule_fn=schedule,
                            control=control)
