"""What the metric readers share: a metric file (`metrics/<name>.py`)
holds one `read(rec)` that picks these over the record its driver left.
Each returns None where the record has nothing to read (no trace, no
span of the kind, no device time), and the harness then leaves the
metric out of the line; a share is never made up as 0."""
from __future__ import annotations

from typing import Optional

from gpubench import core, counts
from gpubench.trace import per_span


def share(least_s: float, device_s: float) -> Optional[float]:
    """least_s / device_s in %, or None without device time."""
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s


def idle_share(rec: dict) -> Optional[float]:
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def decode_roofline(rec: dict) -> Optional[float]:
    """The decode steps' least time (weights and each row's own K/V at
    HBM bandwidth, or their FLOPs at peak, whichever binds) over their
    device time inside the decode spans. A span's fields after its rows
    and contexts are its rows' sums of min(context, W), one for each
    window W of a windowed model."""
    t = rec.get("trace")
    if not t:
        return None
    least = busy = 0.0
    for (rows, ctx, *reach), sec in per_span(t, "model.decode"):
        c = counts.decode_step_counts(rec["model"], rows, ctx, reach)
        least += counts.least_s(c["flops"], c["bytes"])
        busy += sec
    return share(least, busy)


def flash_bwd_roofline(rec: dict) -> Optional[float]:
    """The causal backward's least time at the training shape, once for
    each dK/dV launch, over the device time of both backward kernels
    (dK/dV and dQ) in the trace."""
    t = rec.get("trace")
    if not t:
        return None
    m, a = rec["model"], rec["attention"]
    calls = sum(1 for k in t["kernels"] if "flash_bwd_dkdv" in k[0])
    busy = sum(k[2] for k in t["kernels"] if "flash_bwd" in k[0])
    f = a["batch"] * counts.attn_bwd_flops(m["heads"], m["head_dim"],
                                           counts.causal_pairs(a["seq"]))
    b = counts.attn_bwd_bytes(a["seq"], m["heads"], m["kv_heads"],
                              m["head_dim"], a["batch"])
    return share(calls * counts.least_s(f, b), busy)


def p_ms(values, p: float) -> Optional[float]:
    v = core.percentile(values, p)
    return None if v is None else 1e3 * v
