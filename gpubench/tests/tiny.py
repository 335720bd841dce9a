"""Cells of the benchmark cut to CPU size for the tests: every width
small, the structure (GQA, SwiGLU, the experts, untied head) and the
traffic's shape kept."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
            max_position_embeddings=256)


def tiny_cell(name: str, reg=None) -> dict:
    from gpubench import core
    cell = copy.deepcopy((reg or core.Registry()).cell(name))
    cell["config"].update(TINY)
    p = cell["params"]
    if p["driver"] == "serve_closed":
        p.update(clients=4,
                 prompt_tokens={"dist": "lognormal", "median": 24,
                                "sigma": 0.8, "min": 8, "max": 64},
                 output_tokens={"dist": "lognormal", "median": 12,
                                "sigma": 0.8, "min": 4, "max": 32},
                 sample_tokens=60)
        cell["config"]["serving"]["max_batch"] = 4
    elif p["driver"] == "serve_open":
        p.update(rate_per_s=6.0,
                 prompt_tokens={"dist": "uniform", "min": 40, "max": 100},
                 output_tokens={"dist": "uniform", "min": 4, "max": 16},
                 sample_tokens=60)
        cell["config"]["serving"]["max_batch"] = 4
    else:
        p.update(batch=2, seq=32)
    return cell


def run_tiny(cell: dict, seed: int = 2 ** 31 + 7, seconds: float = 2.0,
             trace: bool = False) -> dict:
    """One run of a tiny cell on the CPU, as `run.py` makes it: the
    record and the result line's object."""
    import torch

    from gpubench import core
    import gpubench.run as runner
    reg = core.Registry()
    dev = torch.device("cpu")
    rec = reg.driver(cell["params"]["driver"]).run(
        cell, seed, seconds, trace, dev, time.perf_counter())
    return rec, runner.result(reg, cell, rec, trace, dev)
