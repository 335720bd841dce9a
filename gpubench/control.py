"""The readings that the correctness limits are set from, on the card.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 50]

Serving: each seed runs the cell as `run.py` does and reads, beside the
program's widest logit gap, the control's: the same positions under the
configuration's plain reference (`reference/<name>.py`, named by its
architecture) in fp8, the gap of the token that the fp8 reference puts
first.

Training: each seed builds the training object and drives its first
steps as `run.py`'s set-up does (no window: its readings need none),
then runs the reference's first steps in the program's place in fp8
(the control) and with half of each batch left out, the mean taken over
the rest (a fault). Each prints the numbers compared against the
float32 reference, and every leaf's sampled distance. A step that
returns its state unchanged reads 1 by construction (no change, no
first moment) and needs no run.

Every reading goes through the comparison that `run.py` makes
(`judge`, `core.check`) with the cell's own limits, and its line says
whether it came out `correct`: the program's should, the control's and
the fault's should not. One JSON line a seed and kind on standard
output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as harness  # noqa: E402  (gpubench/run.py)


def control(reg, cell: dict, seeds, seconds: float, device) -> None:
    """One line a seed and kind on standard output."""
    import torch
    from gpubench import core, judge
    kind = cell["params"]["driver"]
    for seed in seeds:
        t = time.perf_counter()
        if kind == "train_steps":
            drv = reg.driver(kind)
            seed = core.seed_of(seed)
            st = drv.start(cell, seed, device)
            prog, first = st.prog, st.first
            del st
            gc.collect()
            torch.cuda.empty_cache()
            ref = judge.reference_training(cell, seed, first, device)
            half = first[0].shape[0] // 2
            for what, got in (
                    ("program", prog),
                    ("control_fp8", judge.reference_training(
                        cell, seed, first, device, quant="fp8")),
                    ("fault_half_batch", judge.reference_training(
                        cell, seed, first, device, rows=half))):
                gaps = judge.sample_gaps(got["grad_sample"],
                                         ref["grad_sample"])
                nums = judge.training_numbers(got, ref)
                checks = judge.training_checks(nums, cell["limits"])
                print(json.dumps({
                    "seed": seed, "kind": what,
                    "correct": all(c["ok"] for c in checks.values()),
                    "checks": checks, **nums,
                    "worst": judge.worst_leaves(got, ref),
                    "leaf_sample_gaps": [gaps[q] for q in sorted(gaps)],
                    "s": time.perf_counter() - t}), flush=True)
        else:
            rec = reg.driver(kind).run(cell, seed, seconds, False,
                                       device, time.perf_counter(),
                                       control=True)
            low = core.check(rec["sample"].get("control_logit_gap"),
                             cell["limits"]["logit_gap"])
            for what, checks in (("program", rec["checks"]),
                                 ("control_fp8", {"logit_gap": low})):
                print(json.dumps({
                    "seed": seed, "kind": what,
                    "correct": all(c["ok"] for c in checks.values()),
                    "checks": checks, "sample": rec["sample"],
                    "notes": rec["notes"],
                    "s": time.perf_counter() - t}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args(argv)
    harness._env()
    import torch
    from gpubench import core
    reg = core.Registry()
    cell = reg.cell(args.workload)
    if not torch.cuda.is_available():
        harness.fail("no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    control(reg, cell, args.seeds, args.seconds, device)
    bad = core.forbidden_loaded()
    if bad:
        harness.fail("forbidden modules loaded: " + ", ".join(bad), 3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
