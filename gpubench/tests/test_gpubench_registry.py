"""The harness is driven by data: a configuration, its architecture, a
cell, a traffic mix and a per-layer metric are each a new file that it
finds by name. Throwaway cells, built in a temporary copy, run with no
edit to a file that is there."""
import json
import shutil

import torch

from tiny import ROOT, TINY

import gpubench.run as runner
from gpubench import core


def test_a_new_cell_is_found_by_name(tmp_path):
    base = tmp_path / "gpubench"
    shutil.copytree(ROOT / "gpubench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a configuration: a file of sizes
    conf = json.loads((base / "configs" / "mistral-7b.json").read_text())
    conf.update(TINY, num_hidden_layers=3)
    conf["serving"]["max_batch"] = 2
    (base / "configs" / "toy-3l.json").write_text(json.dumps(conf))
    manifest["configs"].append({
        "name": "toy-3l", "source": "https://example.org/toy",
        "file": "gpubench/configs/toy-3l.json", "reduced": [], "why": "t"})
    # a traffic mix: data for a driver that is there
    (base / "traffic" / "trickle.json").write_text(json.dumps({
        "driver": "serve_open", "rate_per_s": 3.0,
        "prompt_tokens": {"dist": "uniform", "min": 8, "max": 20},
        "output_tokens": {"dist": "uniform", "min": 2, "max": 6},
        "sample_tokens": 20}))
    # a cell, with what is its own
    (base / "workloads" / "toy-3l.trickle.json").write_text(json.dumps(
        {"params": {"wait_first_s": 10}, "limits": {"logit_gap": 0.6}}))
    manifest["workloads"].append({
        "name": "toy-3l.trickle", "config": "toy-3l", "traffic": "trickle",
        "chips": 1, "why": "t"})
    # an end-to-end metric and a per-layer metric: a reader each
    (base / "metrics" / "ttft_p50_ms.py").write_text(
        "from gpubench.readers import p_ms\n"
        "def read(rec):\n    return p_ms(rec['ttft_s'], 50)\n")
    manifest["end_to_end"].append({
        "name": "ttft_p50_ms", "unit": "ms", "better": "lower",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["toy-3l.trickle"]})
    (base / "metrics" / "requests_due.trickle.py").write_text(
        "def read(rec):\n    return float(len(rec['requests']))\n")
    manifest["per_layer"].append({
        "name": "requests_due.trickle", "unit": "requests",
        "better": "higher", "source": "host_clock", "layer": "Serve engine",
        "moves": "ttft_p50_ms", "workloads": ["toy-3l.trickle"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    reg = core.Registry(base=base)
    cell = reg.cell("toy-3l.trickle")
    assert cell["params"]["rate_per_s"] == 3.0
    assert cell["config"]["num_hidden_layers"] == 3
    dev = torch.device("cpu")
    import time
    rec = reg.driver("serve_open").run(cell, 11, 1.5, True, dev,
                                       time.perf_counter())
    out = runner.result(reg, cell, rec, True, dev)
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests_due.trickle"]["value"] == 4.0
    e2e = runner.result(reg, cell, rec, False, dev)["metrics"]
    assert set(e2e) == {"setup_s", "ttft_p50_ms"}


PROBE = '''"""A test architecture: Mistral's, each hook asked for recorded."""
from gpubench import core

_base = core.arch_named("mistral")
CALLS = set()


def dims(config):
    CALLS.add("dims")
    return _base.dims(config)


def leaf_specs(dims):
    CALLS.add("leaf_specs")
    return _base.leaf_specs(dims)


def program_config(config):
    CALLS.add("program_config")
    return _base.program_config(config)


def __getattr__(name):
    if name == "reference":
        CALLS.add("reference")
        return _base.reference
    raise AttributeError(name)
'''


def test_a_new_architecture_comes_in_new_files(tmp_path):
    """A config that names an architecture of its own, in a temporary
    copy: the architecture's file, the config, its cell and the manifest's
    entries are all that is added. A closed-loop chat run through it is
    correct, every hook ran, and no file that was there changed."""
    from tiny import run_tiny, tiny_cell
    base = tmp_path / "gpubench"
    shutil.copytree(ROOT / "gpubench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "arch" / "probe.py").write_text(PROBE)
    conf = json.loads((base / "configs" / "mistral-7b.json").read_text())
    conf.update(TINY, architecture="probe")
    (base / "configs" / "probe-2l.json").write_text(json.dumps(conf))
    (base / "workloads" / "probe-2l.chat.json").write_text(json.dumps(
        {"params": {}, "limits": {"logit_gap": 0.75}}))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "probe-2l", "source": "https://example.org/probe",
        "file": "gpubench/configs/probe-2l.json", "reduced": [], "why": "t"})
    manifest["workloads"].append({
        "name": "probe-2l.chat", "config": "probe-2l", "traffic": "chat",
        "chips": 1, "why": "t"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    reg = core.Registry(base=base)
    cell = tiny_cell("probe-2l.chat", reg)
    probe = core.arch(cell["config"])
    assert probe.__file__ == str(base / "arch" / "probe.py")
    rec, out = run_tiny(cell, seconds=1.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert probe.CALLS == {"dims", "leaf_specs", "program_config",
                           "reference"}
    assert all(p.read_bytes() == raw for p, raw in before.items())
