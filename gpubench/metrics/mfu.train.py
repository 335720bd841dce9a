"""mfu.train: model FLOPs a token (6 x the active weights, causal
attention at the sequence length; no recomputation, no dispatch) times
the tokens a second of the untraced part of the window, over 989 TF/s
(%)."""
from gpubench.counts import PEAK_BF16_FLOPS


def read(rec):
    if rec.get("kind") != "train" or not rec.get("trace"):
        return None
    return 100.0 * rec["flops_per_token"] * rec["rate_untraced"] \
        / PEAK_BF16_FLOPS
