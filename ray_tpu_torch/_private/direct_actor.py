"""Peer-dialed connections (the port's copy of `dial_cached`).

Port of `dial_cached` of `ray_tpu/_private/direct_actor.py`; the direct
actor call plane itself waits for the runtime slice.
"""
from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import protocol


def dial_cached(cache: dict, lock, addr: tuple, handler=None,
                on_close=None) -> Optional[protocol.Connection]:
    """Shared endpoint-connection cache: return the live cached
    connection for ``addr`` or dial a fresh one; a concurrent dial keeps
    the winner already in the cache and closes the loser. None when the
    endpoint refuses.

    ``handler``/``on_close`` customize the dialed connection for planes
    that receive server-PUSHED frames on it (the serve/llm token
    stream); the default drops unsolicited frames."""
    with lock:
        c = cache.get(addr)
        if c is not None and not c.closed:
            return c
    try:
        c = protocol.connect(addr, handler or (lambda conn, m: None),
                             on_close=on_close,
                             name=f"direct-{addr[0]}:{addr[1]}")
    except OSError:
        return None
    with lock:
        existing = cache.get(addr)
        if existing is not None and not existing.closed:
            c.close()
            return existing
        cache[addr] = c
    return c
