"""ray_tpu_torch.tune: hyperparameter sweeps over trial actors.

Port of `ray_tpu/tune/__init__.py`.

Parity: reference python/ray/tune (Tuner, TuneConfig, grid_search,
ASHA). Inside a trainable use `ray_tpu_torch.tune.report` (alias of
ray_tpu_torch.train.report) and `ray_tpu_torch.tune.get_checkpoint`.
"""
from ray_tpu_torch.train.session import get_checkpoint, report  # noqa: F401
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler, FIFOScheduler, PopulationBasedTraining)
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator, Searcher, TPESearcher, choice, grid_search,
    loguniform, randint, uniform)
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    ResultGrid, Trial, TuneConfig, Tuner)

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "Trial", "ASHAScheduler",
    "FIFOScheduler", "PopulationBasedTraining", "grid_search", "choice",
    "uniform", "loguniform", "randint", "BasicVariantGenerator",
    "Searcher", "TPESearcher", "report", "get_checkpoint",
]
