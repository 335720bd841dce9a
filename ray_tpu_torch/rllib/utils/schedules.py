"""Value schedules (reference rllib/utils/schedules/): epsilon decay,
lr warmup etc. All pure functions of the global timestep."""
from __future__ import annotations

from typing import List, Tuple


class ConstantSchedule:
    def __init__(self, value: float):
        self._v = value

    def value(self, t: int) -> float:
        return self._v

    __call__ = value


class LinearSchedule:
    """Linear interpolation from initial_p to final_p over
    schedule_timesteps, then flat."""

    def __init__(self, schedule_timesteps: int, final_p: float,
                 initial_p: float = 1.0):
        self.T = schedule_timesteps
        self.initial_p = initial_p
        self.final_p = final_p

    def value(self, t: int) -> float:
        frac = min(max(t, 0) / self.T, 1.0)
        return self.initial_p + frac * (self.final_p - self.initial_p)

    __call__ = value


class PiecewiseSchedule:
    """Linear interpolation between (t, value) endpoints; outside the
    range, clamps to the outermost values."""

    def __init__(self, endpoints: List[Tuple[int, float]]):
        if len(endpoints) < 2:
            raise ValueError("need >= 2 endpoints")
        self.endpoints = sorted(endpoints)

    def value(self, t: int) -> float:
        eps = self.endpoints
        if t <= eps[0][0]:
            return eps[0][1]
        if t >= eps[-1][0]:
            return eps[-1][1]
        for (t0, v0), (t1, v1) in zip(eps, eps[1:]):
            if t0 <= t < t1:
                frac = (t - t0) / (t1 - t0)
                return v0 + frac * (v1 - v0)
        return eps[-1][1]

    __call__ = value
