"""The benchmark's registry and the plumbing every cell shares.

Everything a cell needs is found by name, so a later change adds files
and never edits these:

- `BENCHMARK.json` at the checkout's root lists the cells and metrics;
- `configs/<config>.json`: the model as it is run (published keys at the
  top level, `reduced`, `assumed`, the deployment, the engine or
  optimizer settings), and under `architecture` the name of its
  architecture (`mistral` where the key is absent);
- `arch/<architecture>.py`: what the architecture shapes: `dims` (the
  sizes, from the published keys), `leaf_specs` (the weight layout),
  `program_config` (the port's config object) and `reference`, the name
  of its plain reference `reference/<reference>.py` (`sizes`, `logits`,
  `loss`, `no_tf32`, `mm`, `AdamW`);
- `traffic/<traffic>.json`: a traffic mix, the parameters that its
  driver (`drivers/<driver>.py`) reads;
- `workloads/<cell>.json`: what belongs to one cell alone (an arrival
  rate, the limits of its correctness check);
- `metrics/<metric>.py`: `read(rec)` turns a run's record into one
  metric, or None where the record has nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Iterable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no process of the benchmark may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tpu")
# the architecture of a config file that names none
DEFAULT_ARCH = "mistral"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Registry:
    """The cells and metrics of `BENCHMARK.json`, with the files they
    name under `base` (the benchmark's folder)."""

    def __init__(self, base: Path = HERE):
        self.base = Path(base)
        self.manifest = load_json(self.base.parent / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        own = self.base / "workloads" / f"{name}.json"
        extra = load_json(own) if own.exists() else {}
        traffic = load_json(self.base / "traffic" / f"{w['traffic']}.json")
        params = {**traffic, **extra.get("params", {})}
        return {"name": name, "config_name": w["config"],
                "chips": int(w["chips"]), "traffic": w["traffic"],
                "config": self.config(w["config"]), "params": params,
                "limits": dict(extra.get("limits", {}))}

    def config(self, name: str) -> dict:
        """A config file, its architecture module loaded from `base`."""
        for c in self.manifest["configs"]:
            if c["name"] == name:
                conf = load_json(self.base.parent / c["file"])
                arch_named(arch_name(conf), self.base)
                return conf
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics_for(self, cell: str, per_layer: bool) -> List[dict]:
        """The metrics a run of `cell` reports: its end-to-end ones with
        `--trace 0`, its per-layer ones with `--trace 1`."""
        key = "per_layer" if per_layer else "end_to_end"
        return [m for m in self.manifest[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """`read(rec)` of `metrics/<metric>.py`."""
        return load_module(self.base / "metrics" / f"{metric}.py",
                           f"gpubench_metric_{metric}").read

    def driver(self, kind: str):
        return load_module(self.base / "drivers" / f"{kind}.py",
                           f"gpubench_driver_{kind}")


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (`mfu.train.py`)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole: `ray_tpu_torch` is not
    `ray_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names
                   if m.split(".")[0] in FORBIDDEN_MODULES})


# ---------------------------------------------------------------- stats
def percentile(values: List[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (p in 0..100) of `values`."""
    if not values:
        return None
    v = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(v)))
    return v[k - 1]


# --------------------------------------------------------- the model
def seed_of(seed: int) -> int:
    """The run's seed as a torch and numpy seed (both take it below
    2**63; the driver's seeds may be a little over 2**31, or negative)."""
    return int(seed) % (1 << 63)


def arch_name(config: dict) -> str:
    return config.get("architecture", DEFAULT_ARCH)


def arch_named(name: str, base: Path = HERE):
    """`arch/<name>.py` under `base`; once loaded, by its name alone (a
    registry over another folder loads its own first)."""
    return load_module(Path(base) / "arch" / f"{name}.py",
                       f"gpubench_arch_{name}")


def arch(config: dict):
    """The architecture module that a config file names."""
    return arch_named(arch_name(config))


def reference(config: dict):
    """The plain reference of a config file's architecture."""
    return importlib.import_module(
        f"gpubench.reference.{arch(config).reference}")


def dims(config: dict):
    """The sizes of a config file (`arch.dims`), read without the
    program, tagged with the architecture's name (the weights and the
    counts take these)."""
    d = arch(config).dims(config)
    d.architecture = arch_name(config)
    return d


def model_config(config: dict):
    """The port's config object for a config file
    (`arch.program_config`)."""
    cfg = arch(config).program_config(config)
    if cfg.head_dim != dims(config).head_dim:
        raise ValueError("the program's head_dim is not the config's")
    return cfg


def device_record(dev, count: int, peak_bytes: int) -> dict:
    import torch
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": kind, "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def check(value: float, limit: float, why: str = "") -> dict:
    """One compared number beside its limit; a number that is missing or
    not finite fails (`why` says why it is missing)."""
    ok = value is not None and math.isfinite(value) and value <= limit
    out = {"value": value, "limit": limit, "ok": bool(ok)}
    if why:
        out["why"] = why
    return out
