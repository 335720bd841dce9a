"""Replay buffers: uniform ring + proportional prioritized.

Parity: reference rllib/utils/replay_buffers/ (ReplayBuffer,
PrioritizedReplayBuffer with sum-tree proportional sampling +
importance weights). Storage is columnar numpy (transitions as dicts of
arrays), so sampled batches feed the learner's update without a format
hop: the buffer lives on the host, and the learner moves a sampled batch
to its device as it moves a rollout batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

Batch = Dict[str, np.ndarray]


class ReplayBuffer:
    """Uniform FIFO ring buffer over transition rows."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)
        self._added = 0

    def __len__(self) -> int:
        return self._size

    def _ensure(self, batch: Batch) -> None:
        if self._cols is None:
            self._cols = {
                k: np.empty((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in batch.items()}

    def add(self, batch: Batch) -> np.ndarray:
        """Add rows (dict of (n, ...) arrays); returns their slots."""
        n = len(next(iter(batch.values())))
        self._ensure(batch)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, col in self._cols.items():
            col[idx] = batch[k]
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self.capacity, self._size + n)
        self._added += n
        return idx

    def sample(self, batch_size: int) -> Batch:
        if self._size == 0:
            raise ValueError("cannot sample an empty buffer")
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: col[idx] for k, col in self._cols.items()}

    def stats(self) -> Dict[str, int]:
        return {"size": self._size, "capacity": self.capacity,
                "added_lifetime": self._added}


class _SumTree:
    """Flat-array binary sum tree for O(log n) prefix sampling."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        size = 1
        while size < capacity:
            size *= 2
        self._leaf0 = size
        self._tree = np.zeros(2 * size, np.float64)

    def set(self, idx: np.ndarray, values: np.ndarray) -> None:
        pos = np.asarray(idx) + self._leaf0
        self._tree[pos] = values
        pos //= 2
        # bubble sums up; vectorised per level (duplicates collapse via
        # recompute from children rather than += races)
        while np.any(pos >= 1):
            pos = np.unique(pos[pos >= 1])
            self._tree[pos] = (self._tree[2 * pos]
                               + self._tree[2 * pos + 1])
            pos = pos // 2
            if pos.size and pos[0] == 0:
                break

    @property
    def total(self) -> float:
        return float(self._tree[1])

    def prefix_find(self, values: np.ndarray) -> np.ndarray:
        """For each v in [0, total), find the leaf whose cumulative range
        contains it."""
        pos = np.ones(len(values), np.int64)
        v = values.astype(np.float64).copy()
        while pos[0] < self._leaf0:
            left = 2 * pos
            left_sum = self._tree[left]
            go_right = v >= left_sum
            v = np.where(go_right, v - left_sum, v)
            pos = np.where(go_right, left + 1, left)
        return pos - self._leaf0


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization: P(i) ∝ p_i^alpha, importance weights
    w_i = (N P(i))^-beta / max w (reference
    rllib/utils/replay_buffers/prioritized_replay_buffer.py)."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha, self.beta, self.eps = alpha, beta, eps
        self._tree = _SumTree(capacity)
        self._max_priority = 1.0

    def add(self, batch: Batch,
            priorities: Optional[np.ndarray] = None) -> np.ndarray:
        idx = super().add(batch)
        if priorities is None:
            priorities = np.full(len(idx), self._max_priority)
        self._tree.set(idx, np.power(np.abs(priorities) + self.eps,
                                     self.alpha))
        return idx

    def sample(self, batch_size: int) -> Batch:
        if self._size == 0:
            raise ValueError("cannot sample an empty buffer")
        total = self._tree.total
        targets = self._rng.random(batch_size) * total
        idx = self._tree.prefix_find(targets)
        idx = np.minimum(idx, self._size - 1)
        probs = self._tree._tree[idx + self._tree._leaf0] / max(
            total, 1e-12)
        weights = np.power(self._size * np.maximum(probs, 1e-12),
                           -self.beta)
        weights = (weights / weights.max()).astype(np.float32)
        out = {k: col[idx] for k, col in self._cols.items()}
        out["weights"] = weights
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        self._max_priority = max(self._max_priority,
                                 float(np.max(np.abs(priorities))))
        self._tree.set(np.asarray(idx),
                       np.power(np.abs(priorities) + self.eps,
                                self.alpha))
