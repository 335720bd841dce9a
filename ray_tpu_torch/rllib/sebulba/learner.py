"""Sebulba learner: the IMPALA V-trace learner consuming ring shards,
with staleness accounting (r20).

Port of `ray_tpu/rllib/sebulba/learner.py`. Reuses the port's
IMPALALearner wholesale — the same V-trace update on the learner's
device (the card unless `device="cpu"`), the same column split over a
process group when `num_devices > 1`; `get_weights` returns host copies
for the publish — and adds the shard-
facing surface: `update_shard()` strips the ring metadata (runner /
seq / version), records policy staleness (learner version minus the
shard's behavior version — the quantity the ring depth bounds), and
keeps exact per-runner seq books so the chaos gates can assert no
shard was lost or double-counted across a failover.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.impala import (IMPALALearner,
                                                   IMPALALearnerConfig)
from ray_tpu_torch.rllib.sebulba.stats import RL_STATS

_BATCH_KEYS = ("obs", "actions", "logp", "rewards", "terminateds",
               "dones", "mask")


class SebulbaLearner(IMPALALearner):
    """IMPALALearner + shard metadata accounting."""

    def __init__(self, config: IMPALALearnerConfig,
                 staleness_window: int = 4096):
        super().__init__(config)
        self._staleness: deque = deque(maxlen=staleness_window)
        self.staleness_max = 0
        self.shards_consumed = 0
        self.steps_consumed = 0
        # runner index -> last consumed shard seq (contiguity book)
        self.runner_seq: Dict[int, int] = {}
        self.seq_gaps = 0

    # ------------------------------------------------------------- api
    def observe_shard(self, shard: Dict[str, Any]) -> int:
        """Book a shard's metadata; returns its staleness (versions)."""
        behavior = int(shard.get("version", self.version))
        staleness = max(0, self.version - behavior)
        self._staleness.append(staleness)
        self.staleness_max = max(self.staleness_max, staleness)
        runner = shard.get("runner")
        if runner is not None:
            seq = int(shard.get("seq", 0))
            prev = self.runner_seq.get(int(runner), 0)
            if seq != prev + 1:
                self.seq_gaps += 1
            self.runner_seq[int(runner)] = seq
        RL_STATS["staleness_last"] = staleness
        RL_STATS["staleness_max"] = max(RL_STATS["staleness_max"],
                                        staleness)
        return staleness

    def update_shard(self, shard: Dict[str, Any]) -> Dict[str, float]:
        """observe + one V-trace update on the shard's batch slice."""
        staleness = self.observe_shard(shard)
        batch = {k: shard[k] for k in _BATCH_KEYS}
        metrics = self.update(batch)
        self.shards_consumed += 1
        steps = int(shard.get("steps", shard["mask"].sum()))
        self.steps_consumed += steps
        RL_STATS["shards_consumed"] += 1
        RL_STATS["steps_consumed"] += steps
        RL_STATS["learner_updates"] += 1
        RL_STATS["learner_version"] = self.version
        metrics["staleness"] = float(staleness)
        return metrics

    def staleness_quantiles(self) -> Dict[str, float]:
        if not self._staleness:
            return {"staleness_p50": 0.0, "staleness_p95": 0.0,
                    "staleness_max": float(self.staleness_max)}
        arr = np.asarray(self._staleness, np.float64)
        return {"staleness_p50": float(np.percentile(arr, 50)),
                "staleness_p95": float(np.percentile(arr, 95)),
                "staleness_max": float(self.staleness_max)}
