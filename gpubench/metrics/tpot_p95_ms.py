"""tpot_p95_ms: 95th percentile of every gap between two tokens of a
request, as the consumer saw them, over the window (ms)."""
from gpubench.readers import p_ms


def read(rec):
    return p_ms(rec.get("gaps_s", []), 95)
