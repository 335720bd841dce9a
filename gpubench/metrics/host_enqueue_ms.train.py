"""host_enqueue_ms.train: the host's time until train_step returns,
before any synchronize, as the mean over the untraced steps (ms)."""


def read(rec):
    e = rec.get("enqueue_s")
    if rec.get("kind") != "train" or not e or not rec.get("trace"):
        return None
    return 1e3 * sum(e) / len(e)
