"""Remote-driver connectivity (the Ray Client analogue).

The counterpart of `ray_tpu/util/client.py`. The head's listener already
speaks a complete driver-equivalent protocol to its workers
(submit/get/put/wait/actor/kv/state ops), so a remote client IS a
`WorkerContext` over TCP: the same wire messages, no proxy server, no
separate pickler. Usage::

    import ray_tpu_torch
    ray_tpu_torch.init(address="10.0.0.5:6379")   # head started with
                                                  # bind_host="0.0.0.0"
    # full API: remote/get/put/wait/actors/PGs/kv/state

The client process imports no torch until one of its own values needs
it: a task that uses the card runs in a worker on the head's side.
"""
from __future__ import annotations

import uuid

from ray_tpu_torch._private import context as _context
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.worker_main import WorkerContext


class ClientContext(WorkerContext):
    """A driver living in another process or host, speaking the worker
    wire protocol to the head. `is_driver` stays False so function
    pickles ship inline with the first submission (the head's function
    store dedups by content hash)."""

    def __init__(self, conn: protocol.Connection, client_id: str,
                 address: str):
        super().__init__(conn, client_id)
        self.address = address

    def is_connected(self) -> bool:
        return not self.conn.closed

    def disconnect(self) -> None:
        try:
            self.conn.close()
        finally:
            if _context.maybe_ctx() is self:
                _context.set_ctx(None)


def connect(address: str) -> ClientContext:
    """Connect this process to a remote head as a driver. The head must
    listen on a reachable interface (init(bind_host=...) /
    RAY_TPU_BIND_HOST)."""
    existing = _context.maybe_ctx()
    if existing is not None:
        raise RuntimeError(
            "already initialized in this process; call shutdown()/"
            "disconnect() first")
    host, port = address.rsplit(":", 1)
    client_id = "client_" + uuid.uuid4().hex[:8]
    conn = protocol.connect((host, int(port)), lambda c, m: None,
                            name=f"client-{client_id}")
    ctx = ClientContext(conn, client_id, address)
    _context.set_ctx(ctx)
    return ctx


def disconnect() -> None:
    ctx = _context.maybe_ctx()
    if isinstance(ctx, ClientContext):
        ctx.disconnect()
