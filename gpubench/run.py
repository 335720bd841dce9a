"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernels' build on a checkout's first run, weights
made on the card from the seed, the cache, warm-up of the cell's own
shapes) is timed from the start of this process; then the cell's driver
measures for `--seconds`, checks what the timed path produced against
the plain reference, and the last line on standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each compared number
beside its limit (also the last lines on standard error).

It exits non-zero, printing no result, where there is no CUDA device
or fewer than the cell asks for, where the program cannot be imported,
or where a module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "gpubench"


def _env() -> None:
    """Caches inside the checkout at fixed paths; no library of this
    process may load JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(BUILD / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "gpubench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))


def fail(msg: str, code: int = 2) -> None:
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def result(reg, cell: dict, rec: dict, trace: bool, device) -> dict:
    """The result line's object from a driver's record."""
    from gpubench import core
    metrics = {}
    for m in reg.metrics_for(cell["name"], per_layer=trace):
        value = reg.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = core.device_record(device, cell["chips"], rec["peak_bytes"])
    out = {"correct": all(c["ok"] for c in rec["checks"].values()),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        t = rec["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in rec["checks"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    phases = {"torch_import": time.perf_counter() - T_START}
    from gpubench import core
    reg = core.Registry()
    cell = reg.cell(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['name']} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} visible")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    phases["cuda_context"] = time.perf_counter() - T_START
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not importable: {e}")
    driver = reg.driver(cell["params"]["driver"])
    rec = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, T_START)
    out = result(reg, cell, rec, bool(args.trace), device)
    bad = core.forbidden_loaded()
    if bad:
        fail("modules of JAX or the JAX package were loaded: "
             + ", ".join(bad), code=3)
    print("setup phases (s from process start): " + json.dumps(
        {**phases, **rec.get("setup_phases_s", {})}), file=sys.stderr)
    if rec.get("notes") or rec.get("sample"):
        print("notes: " + json.dumps({**rec.get("notes", {}),
                                      "sample": rec.get("sample")}),
              file=sys.stderr)
    for k, c in out["checks"].items():
        why = rec["checks"][k].get("why")
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})"
              + (f": {why}" if why else ""), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
