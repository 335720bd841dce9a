"""ASHA lr sweep over trial actors.

Run: python -m ray_tpu_torch.examples.tune_sweep
"""
import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.tune.tuner import TuneConfig


def trainable(config):
    from ray_tpu_torch import tune as rt_tune
    x = 1.0
    for step in range(8):
        x *= (1.0 - config["lr"])          # toy objective -> 0
        rt_tune.report({"loss": abs(x), "step": step})


def main():
    ray_tpu_torch.init(num_cpus=4)
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.9, 0.5, 0.1, 0.01])},
        tune_config=TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=2,
            scheduler=tune.ASHAScheduler(metric="loss", mode="min",
                                         max_t=8, grace_period=2)),
    ).fit()
    best = grid.get_best_result()
    print("best config:", best.metrics["config"], "loss:",
          best.metrics["loss"])
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
