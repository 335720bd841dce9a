"""setup_s: process start to the first measured request or step (s)."""


def read(rec):
    return rec["setup_s"]
