"""The port's examples (`ray_tpu_torch/examples/`, the twins of the repo
root's `examples/`), each run as ``python -m
ray_tpu_torch.examples.<name>`` in a subprocess on the CPU, with the
line that shows it did its work.

Three examples take longer than a tier-1 case may (10 s) and run whole
only under `slow`, each with a fast sibling in tier 1 through the same
code: `ppo_cartpole` (up to 250 iterations, until CartPole's return
reaches 450; the sibling runs 2, `--iters 2`), `multi_agent_ppo` (40
iterations; the sibling 2) and `tune_pbt` (~15 s: its two sweeps each
run alone through the example's own `pbt_sweep` and `distributed_sweep`,
the PBT sweep with 4 steps a trial).
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case -> (example, its arguments, a line the run must print)
EXAMPLES = {
    "core_tasks_actors": ("core_tasks_actors", [],
                          "placement group ready: True"),
    "data_pipeline": ("data_pipeline", ["--device", "cpu"],
                      "batch 3: tokens (64, 16) torch.int32 on cpu"),
    "train_sft": ("train_sft", ["--device", "cpu"],
                  "'step': 4} checkpoint: Checkpoint("),
    "tune_sweep": ("tune_sweep", [], "best config: {'lr': 0.9}"),
    "serve_inference": ("serve_inference", [],
                        "http: {'result': {'label': 'short'"),
    "serve_streaming": ("serve_streaming", [], "status: {'llm'"),
    "serve_composition": ("serve_composition", [],
                          "deployments: ['Ingress', 'LengthModel'"),
    "serve_multi_app": ("serve_multi_app", [],
                        "/shout after delete -> STILL HERE"),
    "data_relational": ("data_relational", [], "top-3 v:"),
    "data_streaming_stages": ("data_streaming_stages", [], "rows: 4000"),
    "dag_collective": ("dag_collective", [], "ok"),
    "ppo_cartpole": ("ppo_cartpole", ["--device", "cpu", "--iters", "2"],
                     "iter   0 return"),
    "multi_agent_ppo": ("multi_agent_ppo",
                        ["--device", "cpu", "--iters", "2"],
                        "iter   0 left="),
}
FULL = {
    "ppo_cartpole": ("ppo_cartpole", ["--device", "cpu"], "solved at iter"),
    "multi_agent_ppo": ("multi_agent_ppo", ["--device", "cpu"],
                        "iter  35 left="),
    "tune_pbt": ("tune_pbt", ["--device", "cpu"], "world_size: 2"),
}
# tune_pbt's sweeps, each alone: (its call, a line the run must print)
PBT_SWEEPS = {
    "pbt": ("t.pbt_sweep(4, d)", "PBT exploits:"),
    "distributed": ("t.distributed_sweep(True, d)", "world_size: 2"),
}


def _run(args, want, timeout):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("RAY_TPU_TORCH_SESSION", None)
    out = subprocess.run(
        [sys.executable, *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert want in out.stdout, out.stdout[-2000:]


@pytest.mark.parametrize("case", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(case):
    name, args, want = EXAMPLES[case]
    _run(["-m", f"ray_tpu_torch.examples.{name}", *args], want,
         timeout=120)


@pytest.mark.parametrize("sweep", sorted(PBT_SWEEPS))
def test_tune_pbt_sweep_on_the_cpu(sweep):
    call, want = PBT_SWEEPS[sweep]
    code = ("import tempfile, ray_tpu_torch\n"
            "from ray_tpu_torch.examples import tune_pbt as t\n"
            "ray_tpu_torch.init(num_cpus=4)\n"
            f"d = tempfile.mkdtemp()\n{call}\nray_tpu_torch.shutdown()\n")
    _run(["-c", code], want, timeout=120)


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(FULL))
def test_example_full_run_on_the_cpu(case):
    name, args, want = FULL[case]
    _run(["-m", f"ray_tpu_torch.examples.{name}", *args], want,
         timeout=1200)


def test_every_example_is_run():
    names = {f[:-3] for f in os.listdir(
        os.path.join(REPO, "ray_tpu_torch", "examples"))
        if f.endswith(".py") and f != "__init__.py"}
    assert names == {name for name, _, _ in EXAMPLES.values()} | {"tune_pbt"}
    jax_names = {f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                 if f.endswith(".py")}
    assert names == jax_names
