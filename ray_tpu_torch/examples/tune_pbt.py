"""Population-based training + distributed trials with ray_tpu_torch.tune.

Four concurrent trials optimize a synthetic curve; PBT exploits the top
quantile (checkpoint inheritance + mutated lr). Then each trial of a
second sweep is a 2-worker TorchTrainer group (on the card the two
workers share it; ``--device cpu`` keeps them on the CPU).
Reference analogue: tune/schedulers/pbt.py + trial placement groups.

Run: python -m ray_tpu_torch.examples.tune_pbt [--device cpu]
"""
import argparse
import tempfile
import time

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import (Checkpoint, RunConfig, ScalingConfig,
                                 TorchConfig, TorchTrainer)
from ray_tpu_torch.train.session import make_temp_checkpoint_dir


def pbt_trainable(config):
    from ray_tpu_torch import tune as rt
    start, ckpt = 0, rt.get_checkpoint()
    if ckpt is not None:
        start = int(ckpt.load_state()["step"])
    for step in range(start, config["steps"]):
        time.sleep(0.3)                  # let the population overlap
        d = make_temp_checkpoint_dir()
        c = Checkpoint.from_state(d, {"step": step + 1})
        rt.report({"score": float(config["lr"]), "step": step}, c)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (default) for the "
                         "distributed trials")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps of each PBT trial")
    args = ap.parse_args(argv)
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    tmp = tempfile.mkdtemp()
    pbt_sweep(args.steps, tmp)
    distributed_sweep(args.device == "cpu", tmp)
    ray_tpu_torch.shutdown()


def pbt_sweep(steps, tmp):
    sched = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": tune.uniform(0.0, 1.0)}, seed=0)
    grid = tune.Tuner(
        pbt_trainable,
        param_space={"lr": tune.grid_search([0.05, 0.1, 0.6, 0.9]),
                     "steps": steps},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=4,
                                    scheduler=sched),
        run_config=RunConfig(name="pbt_demo", storage_path=tmp),
    ).fit()
    print("PBT exploits:", sched.num_exploits)
    for t in grid.trials:
        print(f"  {t.trial_id} lr={t.config['lr']:.3f} "
              f"perturbations={t.num_perturbations}")


def distributed_sweep(cpu, tmp):
    """Each trial is a 2-worker group."""
    def loop(config):
        from ray_tpu_torch import train as rt
        ctx = rt.get_context()
        for step in range(4):
            rt.report({"loss": 1.0 / (1 + step * config["lr"]),
                       "world": ctx.get_world_size()})

    trainer = TorchTrainer(
        loop, train_loop_config={"lr": 0.0},
        scaling_config=ScalingConfig(
            num_workers=2,
            resources_per_worker=None if cpu else {"CPU": 1, "GPU": 0.5}),
        backend_config=TorchConfig(platform="cpu" if cpu else None))
    grid2 = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([0.01, 5.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1),
        run_config=RunConfig(name="dist_demo", storage_path=tmp),
    ).fit()
    best = grid2.get_best_result()
    print("distributed-trial best:", best.metrics["config"],
          "world_size:", best.metrics["world"])


if __name__ == "__main__":
    main()
