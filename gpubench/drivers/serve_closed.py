"""A closed loop of `clients` users: each sends its next request when its
last one ends, so the batch stays as full as the engine lets it.

Mix parameters: `clients`, `prompt_tokens` and `output_tokens`
(distributions, `load.py`), `rounds` (requests a client can send). The
first `clients` requests carry the same `clients` strata of each length
for every seed, and so does every later round.
"""
from __future__ import annotations

from gpubench import load, serving
from gpubench.serving import Req


def schedule(cfg, p: dict, seed: int, seconds: float):
    clients, rounds = int(p["clients"]), int(p.get("rounds", 32))
    plen = load.rounds(p["prompt_tokens"], clients, rounds, seed, 1)
    olen = load.rounds(p["output_tokens"], clients, rounds, seed, 2)
    prompts = load.prompts(plen, cfg.vocab_size, seed, 3)
    per_client = [[] for _ in range(clients)]
    for j, (pr, n) in enumerate(zip(prompts, olen)):
        per_client[j % clients].append(Req(f"c{j}", pr, n))
    return per_client, sorted(set(plen))


def run(cell, seed, seconds, trace, device, t_start, control=False):
    return serving.run_cell(cell, seed, seconds, trace, device, t_start,
                            closed_loop=True, schedule_fn=schedule,
                            control=control)
