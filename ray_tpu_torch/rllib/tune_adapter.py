"""Algorithms as Tune trainables.

Port of `ray_tpu/rllib/tune_adapter.py`, a copy.

Parity: reference rllib/algorithms/algorithm.py:227 — Algorithm IS a
tune.Trainable (setup builds from the config, step = train(), save/
load_checkpoint = get/set_state) — re-shaped to this stack's function-
trainable contract: ``tune_trainable(ConfigCls)`` returns a function
the Tuner runs in a trial actor, with hyperparameters arriving through
the trial config dict, metrics flowing through ``train.report``, and
fault tolerance via checkpointed algorithm state.

Usage::

    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.tune_adapter import tune_trainable

    tuner = tune.Tuner(
        tune_trainable(PPOConfig),
        param_space={"lr": tune.grid_search([1e-4, 3e-4]),
                     "env": "CartPole-v1",
                     "_num_iterations": 10},
        tune_config=tune.TuneConfig(metric="episode_return_mean",
                                    mode="max"))
    results = tuner.fit()
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Type

# trial-control keys the adapter consumes (not algorithm hyperparams)
_ITER_KEY = "_num_iterations"
_CKPT_EVERY_KEY = "_checkpoint_every"


def tune_trainable(config_cls: Type) -> Callable[[Dict[str, Any]], None]:
    """Wrap an algorithm config class (PPOConfig, DQNConfig, ...) as a
    Tune function trainable. Every trial-config key that names a field
    of the config dataclass is applied to it; ``_num_iterations``
    bounds the training loop (default 10) and ``_checkpoint_every``
    controls state checkpoints (default every 5 iterations, enabling
    trial resume and PBT exploitation)."""

    def trainable(config: Dict[str, Any]) -> None:
        from ray_tpu_torch import train
        from ray_tpu_torch.train import Checkpoint

        cfg = config_cls()
        for k, v in config.items():
            if k.startswith("_"):
                continue
            if not hasattr(cfg, k):
                raise ValueError(
                    f"{config_cls.__name__} has no field {k!r}")
            setattr(cfg, k, v)
        algo = cfg.build()
        try:
            start = 0
            ckpt = train.get_checkpoint()
            if ckpt is not None:
                with open(os.path.join(ckpt.as_directory(),
                                       "algo_state.pkl"), "rb") as f:
                    algo.set_state(pickle.load(f))
                start = algo.iteration
            iters = int(config.get(_ITER_KEY, 10))
            every = int(config.get(_CKPT_EVERY_KEY, 5))
            import numpy as np
            for i in range(start, iters):
                metrics = {
                    k: (v.item() if isinstance(
                        v, (np.floating, np.integer, np.bool_)) else v)
                    for k, v in algo.train().items()}
                out_ckpt = None
                if (i + 1) % every == 0 or i + 1 == iters:
                    import tempfile
                    # the rtt_ckpt_ prefix opts into the train worker's
                    # post-report temp-dir reclamation
                    d = tempfile.mkdtemp(prefix="rtt_ckpt_")
                    with open(os.path.join(d, "algo_state.pkl"),
                              "wb") as f:
                        pickle.dump(algo.get_state(), f)
                    out_ckpt = Checkpoint.from_directory(d)
                train.report(dict(metrics), checkpoint=out_ckpt)
        finally:
            algo.stop()

    trainable.__name__ = f"{config_cls.__name__}_trainable"
    return trainable
