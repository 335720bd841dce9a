"""The highest rate an open-loop cell's engine sustains, found once by
a sweep on the card; the cell's file then fixes its rate as a number.

    python3 gpubench/sweep.py --workload <open-loop cell> \
        --rates 1.5 2 2.5 3 3.5 --seconds 40 --seed 1

One engine serves every rate in turn (each window starts with the engine
empty). A line a rate: requests due and finished, the time to first
token (p50, p90, and the p50 of the window's first and second halves:
a queue that grows all through the window shows as a second half far
slower than the first), tpot p95, the engine's waiting line at the
window's end, and how late the generator ran.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as harness  # noqa: E402  (gpubench/run.py)


def sweep(cell: dict, rates, seconds: float, seed: int, device) -> None:
    """One line a rate on standard output."""
    from gpubench import core, serving
    reg = core.Registry()
    seed = core.seed_of(seed)
    drv = reg.driver(cell["params"]["driver"])
    session = serving.Session(cell, seed, device)
    p = dict(cell["params"])
    _, lens = drv.schedule(session.cfg, {**p, "rate_per_s": 1.0}, seed, 1.0)
    session.warm([p["prompt_tokens"]["min"], p["prompt_tokens"]["max"]]
                 + lens)
    try:
        for rate in rates:
            sched, _ = drv.schedule(session.cfg, {**p, "rate_per_s": rate},
                                    seed, seconds)
            for r in sched:                 # request ids unique a window
                r.rid = f"{rate}-{r.rid}"
            rec = serving.run_window(session, sched, seconds, False,
                                     closed_loop=False, wait_first_s=120.0)
            rec.update(serving.summarize(rec))
            half = seconds / 2
            first = [t for r, t in zip(rec["requests"], rec["ttft_s"])
                     if r.due < half]
            second = [t for r, t in zip(rec["requests"], rec["ttft_s"])
                      if r.due >= half]
            ms = lambda v, q: round(1e3 * core.percentile(v, q), 1) \
                if v else None  # noqa: E731
            done = sum(1 for r in rec["requests"] if r.done)
            print(json.dumps({
                "rate_per_s": rate, "due": rec["attempted"],
                "failed": rec["failed"], "finished_by_close": done,
                "ttft_p50_ms": ms(rec["ttft_s"], 50),
                "ttft_p90_ms": ms(rec["ttft_s"], 90),
                "ttft_p50_first_half_ms": ms(first, 50),
                "ttft_p50_second_half_ms": ms(second, 50),
                "tpot_p95_ms": ms(rec["gaps_s"], 95),
                "output_tok_s": rec["tokens_in_window"] / seconds,
                "late_p90_ms": ms(rec["late_s"], 90),
                "queue_wait_p95_ms": 1e3 * rec["queue_wait_p95_s"],
                "waiting_at_end": rec["waiting_at_end"],
                "failures": sorted({str(r.reason) for r in rec["requests"]
                                    if r.failed}),
                "engine_steps": rec["counters"]["steps"]}), flush=True)
            # the next window starts with the engine empty
            while session.engine.core.has_work:
                time.sleep(0.2)
    finally:
        session.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness._env()
    import torch
    from gpubench import core
    cell = core.Registry().cell(args.workload)
    if not torch.cuda.is_available():
        harness.fail("no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    sweep(cell, args.rates, args.seconds, args.seed, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
