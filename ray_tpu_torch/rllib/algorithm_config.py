"""Unified AlgorithmConfig: one builder surface for every algorithm.

Port of `ray_tpu/rllib/algorithm_config.py`, copied whole.

Parity: reference rllib/algorithms/algorithm_config.py — a single
config class whose fluent groups (`.environment() .env_runners()
.training() .resources() .evaluation() .debugging()`) configure any
algorithm, with unknown options rejected instead of silently ignored,
plus `.to_dict() / .copy() / .build()`. Per-algorithm configs
(PPOConfig, DQNConfig, ...) are dataclasses that inherit this base:
their FIELDS define the option vocabulary, the base supplies the
builder machinery, and ``algo_class`` (assigned next to each
algorithm class) makes ``.build()`` uniform.
"""
from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Optional


class AlgorithmConfig:
    """Fluent builder base shared by all algorithm configs."""

    #: the algorithm class `.build()` instantiates (assigned by each
    #: algorithm module next to the class definition)
    algo_class: Optional[type] = None

    # ------------------------------------------------------- builders
    def _apply(self, kw: Dict[str, Any], group: str) -> "AlgorithmConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(
                    f"unknown {type(self).__name__}.{group}() option "
                    f"{k!r}; valid fields: "
                    f"{sorted(vars(self))}")
            setattr(self, k, v)
        return self

    def environment(self, env: Optional[str] = None,
                    **kw) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        return self._apply(kw, "environment")

    def env_runners(self, **kw) -> "AlgorithmConfig":
        return self._apply(kw, "env_runners")

    def training(self, **kw) -> "AlgorithmConfig":
        return self._apply(kw, "training")

    def resources(self, **kw) -> "AlgorithmConfig":
        return self._apply(kw, "resources")

    def evaluation(self, **kw) -> "AlgorithmConfig":
        return self._apply(kw, "evaluation")

    def debugging(self, *, seed: Optional[int] = None,
                  **kw) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self._apply(kw, "debugging")

    # ------------------------------------------------------ lifecycle
    def to_dict(self) -> Dict[str, Any]:
        return dict(vars(self))

    def copy(self) -> "AlgorithmConfig":
        return _copy.deepcopy(self)

    def build(self):
        if self.algo_class is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no algo_class bound")
        return self.algo_class(self)
