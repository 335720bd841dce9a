"""decode_attn_roofline.chat: the paged decode attention kernels' least
time over their device time, inside the decode spans (%). Least time:
each active row's own K/V read and its new k / v written, q read and O
written (bf16), every layer, at 3.35 TB/s, from the span's rows and the
sum of their contexts; device time: the kernels whose name holds
`paged_decode` launched within `model.decode`. None where no such kernel
ran (a program without it)."""
from gpubench.counts import BF16, PEAK_HBM_BYTES_S
from gpubench.readers import share
from gpubench.trace import per_span


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    m = rec["model"]
    least = busy = 0.0
    for (rows, ctx), sec in per_span(t, "model.decode",
                                     name_has="paged_decode"):
        kv = 2 * BF16 * m["kv_heads"] * m["head_dim"] * (ctx + rows)
        qo = 2 * BF16 * m["heads"] * m["head_dim"] * rows
        least += m["layers"] * (kv + qo) / PEAK_HBM_BYTES_S
        busy += sec
    return share(least, busy)
