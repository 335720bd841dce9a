"""train_tok_s: tokens of every step completed in the window, over the
window, which ends on a synchronize (tokens/s)."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    return rec["tokens"] / rec["window_s"]
