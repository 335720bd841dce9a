"""Reusable fault-injection harness for chaos tests (r14, r17): the
port's copy of `tests/chaos.py`, on `ray_tpu_torch`'s protocol.

Drives the failure modes elastic training must survive, against both
cluster topologies:

- in-process nodes (``ray_tpu_torch.cluster_utils.Cluster``): ``kill_node``
  SIGKILLs the node's worker subprocesses and stops its heartbeat —
  the health monitor must *detect* the death (tier-1 friendly).
- real node-agent subprocesses (``NodeAgentProcess``): ``kill_agent``
  SIGKILLs the agent by pid — the full multi-process death path
  (connection loss, heartbeat staleness, delegated-lease resubmit).

r17 adds PROTOCOL-LEVEL network faults (the gray-failure class SIGKILL
cannot reach): ``partition(rt, node_id)`` parks every frame between
the head and one node in both directions while the TCP stream stays up
(TCP-faithful: a partition makes traffic late, not gone) — the node
keeps executing, believes its sends landed, and after ``heal()`` the
parked frames replay; if the death timeout elapsed meanwhile they
arrive under a stale incarnation and get fenced, while a short blip
delivers everything late and loses nothing. ``slow_link`` delays
frames, ``blackhole`` truly drops one direction, ``drop_frames`` drops
probabilistically under the seeded RNG (RAY_TPU_CHAOS_SEED). All of it
requires RAY_TPU_CHAOS=1 in the HEAD process before init; with it
unset the layer does not exist and the wire is byte-identical.

Faults can fire immediately or on a delay/trigger so tests can kill
things "mid-epoch" deterministically: ``after(delay, fn)`` schedules
on a timer thread, ``when(predicate, fn)`` polls a condition (e.g.
"the trainer recorded step 3") and fires once it holds.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


def kill_agent(agent) -> None:
    """SIGKILL a NodeAgentProcess — unannounced multi-process node
    death; detection is connection loss + heartbeat staleness."""
    agent.kill()


def kill_node(cluster, node_id: str) -> None:
    """Abrupt in-process node death (workers SIGKILLed, heartbeat
    stops, nobody told): the health monitor must notice."""
    cluster.remove_node(node_id, graceful=False)


def drop_worker(rt, node_id: str, worker_id: str) -> None:
    """SIGKILL one worker process on a node (narrower than node
    death): actor/task recovery paths, node stays alive."""
    sched = rt.cluster.scheduler_for_node(node_id)
    if sched is not None:
        sched.kill_worker(worker_id)


def preemption_notice(autoscaler, node_id: str,
                      deadline_s: Optional[float] = None) -> None:
    """Deliver a preemption notice through the provider hook — the
    path a real cloud's metadata watcher takes."""
    autoscaler._provider.on_preemption_notice(node_id, deadline_s)


# ---- protocol-level network faults (r17; RAY_TPU_CHAOS=1) ----
def _chaos():
    from ray_tpu_torch._private import protocol
    net = protocol.chaos_net()
    if net is None:
        raise RuntimeError(
            "network fault injection needs RAY_TPU_CHAOS=1 set before "
            "the head initializes (CONFIG.reload() after setting it)")
    return net


def partition(rt, node_id: str) -> None:
    """Symmetric protocol-level partition between this process (the
    head runtime `rt`) and `node_id`: every frame either way is PARKED
    (TCP retransmission semantics: late, not lost), the TCP stream
    survives (close is deferred — a partitioned link delivers no FIN),
    and the node keeps running blind. Past `heartbeat_timeout_s` the
    head declares it dead and re-places its work; after heal() the
    zombie's parked frames replay and are FENCED by their stale
    incarnation instead of double-counting, while a blip shorter than
    the suspicion threshold delivers everything late and costs
    nothing."""
    del rt
    _chaos().set_rule(node_id, "partition", "both")


def blackhole(rt, node_id: str, direction: str = "both") -> None:
    """Drop every frame to ("out"), from ("in"), or both ways for one
    node — the asymmetric variants model one-way link loss."""
    del rt
    _chaos().set_rule(node_id, "blackhole", direction)


def slow_link(rt, node_id: str, delay_s: float = 0.05,
              direction: str = "both") -> None:
    """Add fixed per-frame latency on the head<->node link: inbound
    frames relay through a delay thread (order preserved), outbound
    writes stall the emitter (real backpressure)."""
    del rt
    _chaos().set_rule(node_id, "delay", direction, delay_s=delay_s)


def drop_frames(rt, node_id: str, p: float = 0.5,
                direction: str = "both") -> None:
    """Drop each frame with probability `p` from the seeded RNG
    (RAY_TPU_CHAOS_SEED): deterministic flaky-link replay."""
    del rt
    _chaos().set_rule(node_id, "drop", direction, p=p)


def heal(rt=None, node_id: Optional[str] = None) -> None:
    """Remove one node's fault rules (or all of them): frames flow
    again on the surviving connections."""
    del rt
    from ray_tpu_torch._private import protocol
    net = protocol._CHAOS_NET
    if net is not None:
        net.clear(node_id)


def after(delay_s: float, fn: Callable, *args, **kwargs) -> threading.Thread:
    """Fire `fn(*args, **kwargs)` after `delay_s` on a daemon thread —
    the 'delayed preemption notice' / 'kill mid-epoch' scheduler."""
    def _run():
        time.sleep(delay_s)
        try:
            fn(*args, **kwargs)
        except Exception:
            import traceback
            traceback.print_exc()
    t = threading.Thread(target=_run, name="chaos-after", daemon=True)
    t.start()
    return t


def when(predicate: Callable[[], bool], fn: Callable, *args,
         poll_s: float = 0.05, timeout_s: float = 60.0,
         **kwargs) -> threading.Thread:
    """Fire `fn` once `predicate()` first returns True (polled every
    `poll_s`); gives chaos tests a deterministic 'mid-epoch' trigger
    (e.g. kill after the trainer recorded step k). Times out silently
    — the test's own assertions catch a fault that never fired."""
    def _run():
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if predicate():
                    break
            except Exception:
                pass
            time.sleep(poll_s)
        else:
            return
        try:
            fn(*args, **kwargs)
        except Exception:
            import traceback
            traceback.print_exc()
    t = threading.Thread(target=_run, name="chaos-when", daemon=True)
    t.start()
    return t


def wait_for(predicate: Callable[[], bool], timeout_s: float = 30.0,
             poll_s: float = 0.05) -> bool:
    """Block until `predicate()` holds; True on success, False on
    timeout (assert on the return value)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if predicate():
                return True
        except Exception:
            pass
        time.sleep(poll_s)
    return False
