"""ConnectorV2: composable transform pipelines on the env↔module edges
AND the learner edge.

Port of `ray_tpu/rllib/connectors.py`. Every connector stays numpy;
`GeneralAdvantageEstimation` asks the learner for values through
`compute_values`, which runs the module on the learner's device and
returns numpy.

Parity: reference rllib/connectors (env_to_module/, module_to_env/,
learner/ — ConnectorV2 pieces composed into ConnectorPipelineV2).
Re-shaped for this stack:
- env-side connectors are callables `(data, runner) -> data` over numpy
  batches, running on the env-runner hot path (obs connectors before
  policy inference, action connectors before env.step);
- learner-side connectors are callables `(batch_dict, learner) ->
  batch_dict` over the full time-major training batch, running in the
  Learner BEFORE its update (reference
  rllib/connectors/learner/general_advantage_estimation.py et al).

Built-ins mirror the reference's defaults: observation flattening,
running-stat normalization (the classic MeanStdFilter), observation
clipping, action clipping for Box spaces; learner-side GAE and
advantage standardization.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np


class Connector:
    """Base transform; subclass or wrap a function with FnConnector."""

    def __call__(self, data: np.ndarray, runner=None) -> np.ndarray:
        raise NotImplementedError

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class FnConnector(Connector):
    def __init__(self, fn: Callable[[np.ndarray], np.ndarray],
                 name: Optional[str] = None):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "fn")

    def __call__(self, data, runner=None):
        return self._fn(data)


class FlattenObs(Connector):
    """(N, *obs_shape) -> (N, prod(obs_shape))."""

    def __call__(self, data, runner=None):
        return np.asarray(data).reshape(len(data), -1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, data, runner=None):
        return np.clip(data, self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/std filter (reference MeanStdFilter connector).
    Stats update online during sampling and ride get/set_state so
    restored runners keep their normalization."""

    def __init__(self, eps: float = 1e-8, update: bool = True):
        self.eps = eps
        self.update = update
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, data, runner=None):
        batch = np.asarray(data, np.float64)
        if self._mean is None:
            self._mean = np.zeros(batch.shape[1:], np.float64)
            self._m2 = np.ones(batch.shape[1:], np.float64)
        if self.update and len(batch):
            # Chan's parallel Welford merge: one O(1)-numpy-call update
            # per batch (a per-row Python loop would sit on the sampling
            # hot path)
            n_b = float(len(batch))
            mean_b = batch.mean(axis=0)
            m2_b = ((batch - mean_b) ** 2).sum(axis=0)
            delta = mean_b - self._mean
            total = self._count + n_b
            self._mean = self._mean + delta * (n_b / total)
            self._m2 = (self._m2 + m2_b
                        + (delta ** 2) * (self._count * n_b / total))
            self._count = total
        var = (self._m2 / max(self._count, 1.0)) if self._count else \
            np.ones_like(self._mean)
        return ((batch - self._mean)
                / np.sqrt(var + self.eps)).astype(np.float32)

    def get_state(self) -> dict:
        return {"count": self._count,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state: dict) -> None:
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class ClipActions(Connector):
    """Clip continuous actions into the env's Box bounds."""

    def __call__(self, data, runner=None):
        if runner is not None and getattr(runner, "_continuous", False):
            return np.clip(data, runner._act_low, runner._act_high)
        return data


class ConnectorPipeline(Connector):
    """Ordered composition with the reference pipeline's edit API."""

    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    def __call__(self, data, runner=None):
        for c in self.connectors:
            data = c(data, runner)
        return data

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def insert_before(self, cls: type,
                      connector: Connector) -> "ConnectorPipeline":
        for i, c in enumerate(self.connectors):
            if isinstance(c, cls):
                self.connectors.insert(i, connector)
                return self
        raise ValueError(f"no connector of type {cls.__name__}")

    def insert_after(self, cls: type,
                     connector: Connector) -> "ConnectorPipeline":
        for i, c in enumerate(self.connectors):
            if isinstance(c, cls):
                self.connectors.insert(i + 1, connector)
                return self
        raise ValueError(f"no connector of type {cls.__name__}")

    def get_state(self) -> dict:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict) -> None:
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


# ----------------------------------------------------------------------
# Learner connectors: batch-level transforms before the learner's update
# (reference rllib/connectors/learner/).
# ----------------------------------------------------------------------
class LearnerConnector:
    """Transforms the full time-major training batch dict. Receives the
    Learner so connectors can query the module (value predictions)."""

    def __call__(self, batch: dict, learner=None) -> dict:
        raise NotImplementedError

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class LearnerConnectorPipeline(LearnerConnector):
    """Ordered composition with the same edit API as the env-side
    pipeline."""

    def __init__(self, connectors=None):
        self.connectors: List[LearnerConnector] = list(connectors or [])

    def __call__(self, batch: dict, learner=None) -> dict:
        for c in self.connectors:
            batch = c(batch, learner)
        return batch

    def append(self, c):
        self.connectors.append(c)
        return self

    def prepend(self, c):
        self.connectors.insert(0, c)
        return self

    def get_state(self) -> dict:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict) -> None:
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class GeneralAdvantageEstimation(LearnerConnector):
    """GAE as a learner connector (reference rllib/connectors/learner/
    general_advantage_estimation.py): queries the learner module's
    value function, then adds ``advantages`` and ``value_targets`` to
    the batch. Semantics mirror the learner's own GAE: ``terminateds`` cuts
    the bootstrap, ``dones`` (incl. truncation) cuts only the advantage
    chain — truncation still bootstraps off V(final obs)."""

    def __init__(self, gamma: Optional[float] = None,
                 lambda_: Optional[float] = None):
        # None = inherit from the learner's config at call time, so the
        # connector can never silently diverge from the algorithm's
        # gamma/gae_lambda (the reference constructs this connector
        # FROM the algorithm config for the same reason)
        self.gamma = gamma
        self.lambda_ = lambda_

    def __call__(self, batch: dict, learner=None) -> dict:
        cfg = getattr(learner, "config", None)
        gamma = (self.gamma if self.gamma is not None
                 else getattr(cfg, "gamma", 0.99))
        lambda_ = (self.lambda_ if self.lambda_ is not None
                   else getattr(cfg, "gae_lambda", 0.95))
        values = learner.compute_values(batch["obs"])     # (T+1, N)
        rewards = np.asarray(batch["rewards"], np.float32)
        terms = np.asarray(batch["terminateds"], np.float32)
        dones = np.asarray(batch["dones"], np.float32)
        T = rewards.shape[0]
        adv = np.zeros_like(rewards)
        carry = np.zeros_like(rewards[0])
        for t in range(T - 1, -1, -1):
            delta = (rewards[t]
                     + gamma * values[t + 1] * (1.0 - terms[t])
                     - values[t])
            carry = (delta
                     + gamma * lambda_ * (1.0 - dones[t])
                     * carry)
            adv[t] = carry
        batch = dict(batch)
        batch["advantages"] = adv
        batch["value_targets"] = adv + values[:-1]
        return batch


class StandardizeAdvantages(LearnerConnector):
    """Zero-mean/unit-variance advantages over VALID transitions only
    (mask-aware), matching the learner's own normalization."""

    def __init__(self, eps: float = 1e-8):
        self.eps = eps

    def __call__(self, batch: dict, learner=None) -> dict:
        adv = np.asarray(batch["advantages"], np.float32)
        mask = np.asarray(batch.get("mask",
                                    np.ones_like(adv)), np.float32)
        denom = max(float(mask.sum()), 1.0)
        mu = float((adv * mask).sum()) / denom
        var = float((np.square(adv - mu) * mask).sum()) / denom
        batch = dict(batch)
        batch["advantages"] = ((adv - mu)
                               / np.sqrt(var + self.eps)).astype(
                                   np.float32)
        return batch
