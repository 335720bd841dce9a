"""State API: list/get/summarize cluster entities, with filters.

A copy of `ray_tpu/util/state.py`.

Parity: reference python/ray/util/state/api.py (`ray list actors/tasks/
nodes/objects/placement-groups` with `--filter key=value`, `ray get`,
`ray summary tasks/actors/objects`) — served straight from the
controller tables; also exposed as a CLI:
``python -m ray_tpu_torch.util.state list actors --filter state=ALIVE``.

Filters are (key, op, value) triples with ops ``=``, ``!=``, ``<``,
``<=``, ``>``, ``>=`` and ``contains`` (reference StateApiClient filter
predicates), applied to the listed records.
"""
from __future__ import annotations

import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import context as _context

Filter = Tuple[str, str, Any]

_OPS = {"=": operator.eq, "==": operator.eq, "!=": operator.ne,
        "<": operator.lt, "<=": operator.le, ">": operator.gt,
        ">=": operator.ge,
        "contains": lambda a, b: b in str(a)}


def _op(op: str, **kw) -> Any:
    return _context.get_ctx().state_op(op, **kw)


def _apply_filters(rows: List[Dict],
                   filters: Optional[Sequence[Filter]]) -> List[Dict]:
    if not filters:
        return rows
    preds = []
    for key, fop, value in filters:
        if fop not in _OPS:
            raise ValueError(f"unknown filter op {fop!r}; "
                             f"one of {sorted(_OPS)}")
        preds.append((key, _OPS[fop], value))
    out = []
    for r in rows:
        ok = True
        for key, fn, value in preds:
            have = r.get(key)
            try:
                # numeric filter values compare numerically even though
                # CLI-provided values arrive as strings
                if isinstance(have, (int, float)) and \
                        not isinstance(value, (int, float)):
                    value_c = type(have)(value)
                else:
                    value_c = value
                if not fn(have, value_c):
                    ok = False
                    break
            except (TypeError, ValueError):
                ok = False
                break
        if ok:
            out.append(r)
    return out


def list_actors(filters: Optional[Sequence[Filter]] = None) -> List[Dict]:
    return _apply_filters(_op("list_actors"), filters)


def list_tasks(filters: Optional[Sequence[Filter]] = None,
               limit: int = 1000) -> List[Dict]:
    return _apply_filters(_op("list_tasks", limit=limit), filters)


def list_nodes(filters: Optional[Sequence[Filter]] = None) -> List[Dict]:
    return _apply_filters(_op("list_nodes"), filters)


def list_placement_groups(
        filters: Optional[Sequence[Filter]] = None) -> List[Dict]:
    return _apply_filters(_op("list_placement_groups"), filters)


def list_workers(filters: Optional[Sequence[Filter]] = None) -> List[Dict]:
    """Worker-manager table: every pooled worker process across the
    cluster (reference `ray list workers` / GcsWorkerManager)."""
    return _apply_filters(_op("list_workers"), filters)


def usage_stats() -> Dict[str, Any]:
    """Cluster usage rollup: uptime, node/worker counts, task + actor
    state summaries, resources, object store (reference usage-stats
    aggregation, shaped for the dashboard)."""
    return _op("usage_stats")


def _get_by_id(rows: List[Dict], key: str, value: str) -> Optional[Dict]:
    for r in rows:
        if r.get(key) == value:
            return r
    return None


def get_actor(actor_id: str) -> Optional[Dict]:
    return _get_by_id(_op("list_actors"), "actor_id", actor_id)


def get_task(task_id: str) -> Optional[Dict]:
    return _get_by_id(_op("list_tasks", limit=100000), "task_id", task_id)


def get_node(node_id: str) -> Optional[Dict]:
    return _get_by_id(_op("list_nodes"), "node_id", node_id)


def get_placement_group(pg_id: str) -> Optional[Dict]:
    return _get_by_id(_op("list_placement_groups"), "id", pg_id) or \
        _get_by_id(_op("list_placement_groups"), "pg_id", pg_id)


def summarize_tasks() -> Dict[str, int]:
    return _op("summarize_tasks")


def summarize_actors() -> Dict[str, int]:
    """Actor count per state (reference `ray summary actors`)."""
    counts: Dict[str, int] = {}
    for a in _op("list_actors"):
        counts[a.get("state", "UNKNOWN")] = counts.get(
            a.get("state", "UNKNOWN"), 0) + 1
    return counts


def summarize_objects() -> Dict[str, Any]:
    """Object-store rollup (reference `ray summary objects`)."""
    return _op("object_store_stats")


def object_store_stats() -> Dict:
    return _op("object_store_stats")


def cluster_resources() -> Dict[str, float]:
    return _op("cluster_resources")


def available_resources() -> Dict[str, float]:
    return _op("available_resources")


_LISTERS = {
    "actors": list_actors,
    "tasks": list_tasks,
    "nodes": list_nodes,
    "placement-groups": list_placement_groups,
    "workers": list_workers,
}


def _main() -> None:     # pragma: no cover - thin CLI shim over the API
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="ray_tpu_torch.util.state",
        description="Inspect a ray_tpu_torch runtime (from the driver process)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list")
    p_list.add_argument("entity", choices=sorted(_LISTERS))
    p_list.add_argument("--filter", action="append", default=[],
                        help="key=value / key!=value / key>=value / "
                             "'key contains value'")
    sub.add_parser("summary")
    sub.add_parser("resources")
    args = parser.parse_args()

    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    if args.cmd == "list":
        filters = []
        for f in args.filter:
            for op_tok in (" contains ", "!=", ">=", "<=", "=", ">",
                           "<"):
                if op_tok in f:
                    k, v = f.split(op_tok, 1)
                    filters.append((k.strip(), op_tok.strip(), v.strip()))
                    break
            else:
                raise SystemExit(f"bad --filter {f!r}")
        print(json.dumps(_LISTERS[args.entity](filters=filters or None),
                         indent=1, default=str))
    elif args.cmd == "summary":
        print(json.dumps(summarize_tasks(), indent=1))
    else:
        print(json.dumps({"total": cluster_resources(),
                          "available": available_resources()}, indent=1))


if __name__ == "__main__":
    _main()
