"""Import hygiene, compared by whole top-level names: a run loads no
module of JAX or of the JAX package (`ray_tpu`; the port's name,
`ray_tpu_torch`, begins with it and is not it), and the reference loads
nothing of the port. Each check runs in a fresh process."""
import json
import os
import subprocess
import sys

import pytest

from tiny import ROOT

from gpubench import core


def fresh(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), **env})


def test_forbidden_names_are_compared_whole():
    assert core.forbidden_loaded(["ray_tpu_torch", "ray_tpu_torch.ops",
                                  "jaxtyping", "flax_like"]) == []
    assert core.forbidden_loaded(["ray_tpu.serve", "jax", "jaxlib.xla",
                                  "flax"]) == ["flax", "jax", "jaxlib.xla",
                                               "ray_tpu.serve"]


@pytest.mark.parametrize("cell", ["mistral-7b.chat",
                                  "mixtral-8x7b.train"])
def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'gpubench/tests')\n"
        "from tiny import tiny_cell, run_tiny\n"
        f"rec, out = run_tiny(tiny_cell({cell!r}), seconds=1.0,"
        " trace=True)\n"
        "print(json.dumps({'correct': out['correct'], 'mods': sorted(\n"
        "    {m.split('.')[0] for m in sys.modules})}))\n")
    p = fresh(code)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "ray_tpu_torch" in got["mods"]
    assert not {"jax", "jaxlib", "flax", "ray_tpu"} & set(got["mods"])


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import gpubench.reference.decoder, gpubench.judge\n"
            "import gpubench.weights, gpubench.load, gpubench.counts\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = fresh(code)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = p.stdout
    assert "'torch'" in mods
    assert "ray_tpu" not in mods and "jax" not in mods


def test_without_a_card_a_run_prints_no_result():
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "mistral-7b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the program is missing: the run fails and prints nothing."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "mistral-7b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
