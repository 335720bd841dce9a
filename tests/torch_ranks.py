"""A pool of gloo rank processes for the port's multi-rank tests.

Each test file that needs several ranks makes one `RankPool` for its
module: the processes import torch once and then run case after case.
One process imports torch and the port's parallel stack and forks the
ranks (an import a rank, all at once beside six busy test workers, took
seconds longer), and the pool waits for them only at its first `run`,
so a module's first tests overlap their start.
`pool.run(n, fn, *args)` runs `fn(*args)` on the first `n` ranks, joined
in a gloo process group of `n` (formed anew whenever `n` changes), and returns the results by rank; an exception on any rank fails the
call with that rank's traceback. `fn` and its arguments travel by
cloudpickle, by value for the calling test module, so the ranks never
import the test module (nor JAX with it).

Run as a script, this file is one rank's loop.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Client, Listener, wait

import cloudpickle

_AUTH = b"rank-pool"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    def __init__(self, size: int, timeout: float = 60.0):
        self.size, self.timeout = size, timeout
        # a backlog for every rank: they all dial at once, and a dropped
        # SYN backs off for seconds (the default backlog is 1)
        self._listener = Listener(("127.0.0.1", 0), authkey=_AUTH,
                                  backlog=max(8, size))
        self._start()

    def _start(self):
        host, port = self._listener.address
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=repo + (os.pathsep + path if path else ""))
        self._zygote = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), host, str(port),
             str(self.size)], env=env)
        self._conns = None
        self._pids = []

    def _connect(self):
        if self._conns is not None:
            return
        conns = {}
        # Listener.accept takes no timeout: bound it on its socket
        self._listener._listener._socket.settimeout(self.timeout)
        while len(conns) < self.size:
            conn = self._listener.accept()
            rank, pid = conn.recv()
            conns[rank] = conn
            self._pids.append(pid)
        self._conns = [conns[r] for r in range(self.size)]
        self._world = (0, 0)         # (ranks, generation) of the group

    def run(self, n: int, fn, *args):
        if n > self.size:
            raise ValueError(f"{n} ranks asked of a pool of {self.size}")
        module = sys.modules.get(getattr(fn, "__module__", ""))
        by_value = module is not None and module.__name__ != "__main__"
        if by_value:
            cloudpickle.register_pickle_by_value(module)
        try:
            blob = cloudpickle.dumps((fn, args))
        finally:
            if by_value:
                cloudpickle.unregister_pickle_by_value(module)
        self._connect()
        if self._world[0] != n:
            self._world = (n, self._world[1] + 1)
        port = _free_port()
        conns = self._conns[:n]
        for conn in conns:
            conn.send((self._world, port, blob))
        results, deadline = {}, time.monotonic() + self.timeout
        while len(results) < n:
            ready = wait([c for c in conns if id(c) not in results],
                         max(0.0, deadline - time.monotonic()))
            if not ready:
                self._restart()
                raise TimeoutError(f"ranks {sorted(set(range(n)) - {conns.index(c) for c in conns if id(c) in results})} "
                                   f"gave no result in {self.timeout} s")
            for conn in ready:
                ok, value = conn.recv()
                if not ok:
                    self._restart()   # the others may wait in a collective
                    raise AssertionError(f"rank {conns.index(conn)} of {n} "
                                         f"failed:\n{value}")
                results[id(conn)] = value
        return [results[id(c)] for c in conns]

    def _stop(self):
        for conn in self._conns or ():
            try:
                conn.send(None)
            except OSError:
                pass
        try:
            self._zygote.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._restart_kill()

    def _restart_kill(self):
        for pid in self._pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self._zygote.kill()
        self._zygote.wait()

    def _restart(self):
        self._restart_kill()
        self._start()

    def close(self):
        if self._conns is None:       # never used: its ranks still start
            self._connect()
        self._stop()
        self._listener.close()


def _rank_main(host: str, port: int, rank: int) -> None:
    import torch.distributed as dist
    conn = Client((host, port), authkey=_AUTH)
    conn.send((rank, os.getpid()))
    world = None
    while True:
        msg = conn.recv()
        if msg is None:
            break
        (n, generation), store_port, blob = msg
        try:
            if world != generation:
                if dist.is_initialized():
                    dist.destroy_process_group()
                dist.init_process_group(
                    "gloo", init_method=f"tcp://127.0.0.1:{store_port}",
                    rank=rank, world_size=n)
                world = generation
            fn, args = cloudpickle.loads(blob)
            conn.send((True, fn(*args)))
        except Exception:
            conn.send((False, traceback.format_exc()))
    if dist.is_initialized():
        dist.destroy_process_group()


def _zygote_main(host: str, port: int, size: int) -> None:
    """Import torch and the port's parallel stack once (5 s of imports on
    a slow host), then fork the ranks (before any of them has made a
    thread or a process group) and wait for them."""
    import torch.distributed  # noqa: F401

    import ray_tpu_torch.dryrun  # noqa: F401  (models, ops, parallel)
    children = []
    for rank in range(size):
        pid = os.fork()
        if pid == 0:
            try:
                _rank_main(host, port, rank)
            finally:
                os._exit(0)
        children.append(pid)
    for pid in children:
        os.waitpid(pid, 0)


if __name__ == "__main__":
    _zygote_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
