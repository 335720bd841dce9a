"""Scheduling strategies (reference python/ray/util/scheduling_strategies.py).

Consumed by api._apply_scheduling via duck-typed class names, so these
plain dataclasses are the full contract.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclasses.dataclass
class SpreadSchedulingStrategy:
    """Best-effort spread across nodes (reference \"SPREAD\")."""


# ---- node-label scheduling (reference NodeLabelSchedulingStrategy +
# label match expressions, python/ray/util/scheduling_strategies.py) ----
class In:
    def __init__(self, *values: str):
        self.values = [str(v) for v in values]

    def spec(self) -> tuple:
        return ("in", self.values)


class NotIn:
    def __init__(self, *values: str):
        self.values = [str(v) for v in values]

    def spec(self) -> tuple:
        return ("not_in", self.values)


class Exists:
    def spec(self) -> tuple:
        return ("exists",)


class DoesNotExist:
    def spec(self) -> tuple:
        return ("absent",)


@dataclasses.dataclass
class NodeLabelSchedulingStrategy:
    """Schedule onto nodes by label: `hard` constraints filter candidate
    nodes; `soft` constraints express preference among the survivors.
    Values may be match operators (In/NotIn/Exists/DoesNotExist) or a
    plain string (sugar for In(value))."""
    hard: Optional[dict] = None
    soft: Optional[dict] = None

    def normalized(self) -> tuple:
        return (_normalize(self.hard), _normalize(self.soft))


def _normalize(constraints: Optional[dict]) -> dict:
    out = {}
    for key, op in (constraints or {}).items():
        if isinstance(op, str):
            op = In(op)
        if not hasattr(op, "spec"):
            raise ValueError(
                f"label constraint for {key!r} must be a string or one "
                f"of In/NotIn/Exists/DoesNotExist, got {op!r}")
        out[str(key)] = op.spec()
    return out


def labels_match(labels: dict, constraints: dict) -> bool:
    """Evaluate normalized constraints against a node's label dict."""
    for key, op in constraints.items():
        val = labels.get(key)
        kind = op[0]
        if kind == "in":
            if val is None or val not in op[1]:
                return False
        elif kind == "not_in":
            if val is not None and val in op[1]:
                return False
        elif kind == "exists":
            if val is None:
                return False
        elif kind == "absent":
            if val is not None:
                return False
        else:
            raise ValueError(f"unknown label operator {kind!r}")
    return True


DEFAULT = "DEFAULT"
