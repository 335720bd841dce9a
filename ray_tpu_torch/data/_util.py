"""Shared helpers for background producer threads."""
from __future__ import annotations

import queue as _queue
import threading


def put_unless_closed(q: "_queue.Queue", item, closed: threading.Event,
                      poll_s: float = 0.1) -> bool:
    """Bounded-queue put that aborts when `closed` is set — so an
    abandoned consumer retires its producer thread instead of stranding
    it in a full-queue put forever. Returns False when closed."""
    while not closed.is_set():
        try:
            q.put(item, timeout=poll_s)
            return True
        except _queue.Full:
            continue
    return False
