"""Lock-order-inversion detector (SURVEY §5.2 race-detection parity —
the TSan-deadlock-detector analogue for the pure-Python runtime).

The port's twin of `tests/test_debug_sync.py`, case for case.
"""
import os
import subprocess
import sys
import threading

import pytest


def _fresh_detector(monkeypatch, mode="raise"):
    monkeypatch.setenv("RAY_TPU_DEBUG_LOCKS", mode)
    from ray_tpu_torch._private import debug_sync
    debug_sync.reset_lock_graph()
    return debug_sync


def test_inversion_detected_without_deadlock(monkeypatch):
    """A->B in one thread and B->A in another is flagged at acquisition
    time even though no actual deadlock happens this run."""
    ds = _fresh_detector(monkeypatch)
    a = ds.make_lock("A")
    b = ds.make_lock("B")

    with a:
        with b:
            pass

    err = []

    def reverse():
        try:
            with b:
                with a:
                    pass
        except ds.LockOrderInversion as e:
            err.append(e)

    t = threading.Thread(target=reverse)
    t.start()
    t.join(10)
    assert err, "reverse-order acquisition was not flagged"
    assert "lock-order inversion" in str(err[0])
    assert ds.lock_report()["inversions"]


def test_consistent_order_and_reentrancy_clean(monkeypatch):
    ds = _fresh_detector(monkeypatch)
    a = ds.make_lock("A2", reentrant=True)
    b = ds.make_lock("B2")
    for _ in range(3):
        with a:
            with a:          # reentrant: no self-edge
                with b:
                    pass
    # same order from another thread: fine
    t = threading.Thread(target=lambda: a.acquire() and (
        b.acquire(), b.release(), a.release()))
    t.start()
    t.join(10)
    assert not ds.lock_report()["inversions"]


def test_condition_wait_releases_held_stack(monkeypatch):
    """While cv.wait() sleeps, the lock must not count as held — a
    notifier taking other locks then this one is NOT an inversion."""
    ds = _fresh_detector(monkeypatch)
    lk = ds.make_lock("CVL", reentrant=True)
    cv = threading.Condition(lk)
    other = ds.make_lock("OTHER")
    ready = threading.Event()
    woke = threading.Event()

    def waiter():
        with cv:
            ready.set()
            cv.wait(10)
        woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    assert ready.wait(10)
    with other:              # OTHER -> CVL order
        with cv:
            cv.notify_all()
    assert woke.wait(10)
    # reverse order CVL -> OTHER would now be an inversion; the wait
    # path above must not have produced one by itself
    assert not ds.lock_report()["inversions"]
    t.join(10)


def test_disabled_returns_plain_locks(monkeypatch):
    monkeypatch.delenv("RAY_TPU_DEBUG_LOCKS", raising=False)
    from ray_tpu_torch._private import debug_sync
    lk = debug_sync.make_lock("X")
    assert type(lk).__name__ == "lock"          # threading.Lock


_DRIVER = r"""
import os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
import ray_tpu_torch
ray_tpu_torch.init(num_cpus=4)

@ray_tpu_torch.remote
def add(a, b):
    return a + b

@ray_tpu_torch.remote
def outer(n):
    return sum(ray_tpu_torch.get([add.remote(i, 1) for i in range(n)]))

@ray_tpu_torch.remote
class C:
    def __init__(self):
        self.v = 0
    def inc(self):
        self.v += 1
        return self.v

assert ray_tpu_torch.get([add.remote(i, i) for i in range(8)]) == [
    2 * i for i in range(8)]
assert ray_tpu_torch.get(outer.remote(3), timeout=120) == 6
c = C.remote()
assert ray_tpu_torch.get([c.inc.remote() for _ in range(5)]) == [1, 2, 3, 4, 5]
ref = ray_tpu_torch.put({"x": 1})
assert ray_tpu_torch.get(ref) == {"x": 1}
ray_tpu_torch.shutdown()

from ray_tpu_torch._private.debug_sync import lock_report
rep = lock_report()
print("EDGES", sum(len(v) for v in rep["edges"].values()))
print("INVERSIONS", len(rep["inversions"]))
for inv in rep["inversions"]:
    print(inv["cycle"])
"""


def test_runtime_is_inversion_free_under_detector(tmp_path):
    """Run a real driver (tasks, nested tasks, actors, objects) with
    the detector in warn mode: the exercised runtime paths must hold
    the core locks in a consistent global order."""
    script = tmp_path / "driver.py"
    script.write_text(_DRIVER)
    env = dict(os.environ)
    env["RAY_TPU_DEBUG_LOCKS"] = "warn"
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, str(script)], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "INVERSIONS 0" in out.stdout, (out.stdout, out.stderr[-2000:])
    # the detector actually watched something
    edges = [ln for ln in out.stdout.splitlines()
             if ln.startswith("EDGES")]
    assert edges and int(edges[0].split()[1]) > 0
