"""In-process multi-node cluster harness.

A copy of `ray_tpu/cluster_utils.py`: nodes and agents take `num_gpus`
and publish a `GPU` resource where the JAX harness takes `num_tpus` and
publishes `TPU`.

Parity: reference python/ray/cluster_utils.py:135 (Cluster/add_node) —
multiple per-node schedulers (each owning real worker subprocesses) run
inside the driver process, so scheduling, spillback, placement groups,
and node-failure recovery are exercised without real multi-host
infrastructure. `kill_node` simulates abrupt node death that the health
monitor must detect, mirroring the reference's killer-actor fault
pattern (_private/test_utils.py:1433).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private import context as _context


class Cluster:
    """Drives the ClusterTaskManager of the active runtime."""

    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None):
        import ray_tpu_torch
        args = dict(head_node_args or {})
        self._rt = ray_tpu_torch.init(**args) if initialize_head else (
            _context.get_ctx())

    @property
    def _cluster(self):
        return self._rt.cluster

    def add_node(self, num_cpus: float = 1.0,
                 num_gpus: float = 0.0,
                 resources: Optional[Dict[str, float]] = None,
                 max_workers: Optional[int] = None,
                 labels: Optional[Dict[str, str]] = None) -> str:
        """Add a simulated node; returns its node_id."""
        res = {"CPU": float(num_cpus)}
        if num_gpus:
            res["GPU"] = float(num_gpus)
        if resources:
            res.update({k: float(v) for k, v in resources.items()})
        rec = self._cluster.add_node(res, max_workers=max_workers,
                                     labels=labels)
        return rec.node_id

    def remove_node(self, node_id: str) -> None:
        """Graceful removal: drain + recover the node's work."""
        self._cluster.remove_node(node_id, graceful=True)

    def kill_node(self, node_id: str) -> None:
        """Abrupt death: workers SIGKILLed, heartbeat stops; the health
        monitor detects and recovers (reference RayletKiller pattern)."""
        self._cluster.remove_node(node_id, graceful=False)

    def list_nodes(self) -> List[dict]:
        return self._rt.controller.list_nodes()

    def alive_node_ids(self) -> List[str]:
        return [n.node_id for n in self._cluster.alive_nodes()]

    def wait_for_nodes(self, n: int, timeout: float = 10.0) -> bool:
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self._cluster.alive_nodes()) >= n:
                return True
            time.sleep(0.05)
        return False


class NodeAgentProcess:
    """A REAL node-agent subprocess joined to the active head over TCP —
    the honest multi-host topology (vs Cluster's in-process nodes).
    Reference analogue: `ray start --address=<head>` spawning a raylet
    that registers with the remote GCS (gcs_node_manager.h:62)."""

    def __init__(self, head_address: Optional[tuple] = None,
                 num_cpus: float = 2.0, num_gpus: float = 0.0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 max_workers: Optional[int] = None,
                 node_id: Optional[str] = None):
        import json
        import os
        import subprocess
        import sys
        import uuid
        if head_address is None:
            head_address = _context.get_ctx().address
        self.node_id = node_id or ("node_" + uuid.uuid4().hex[:8])
        args = [sys.executable, "-m", "ray_tpu_torch._private.node_agent",
                "--head", f"{head_address[0]}:{head_address[1]}",
                "--num-cpus", str(num_cpus), "--num-gpus", str(num_gpus),
                "--bind", "127.0.0.1", "--advertise", "127.0.0.1",
                "--node-id", self.node_id]
        if resources:
            args += ["--resources", json.dumps(resources)]
        if labels:
            args += ["--labels", json.dumps(labels)]
        if max_workers is not None:
            args += ["--max-workers", str(max_workers)]
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        self.proc = subprocess.Popen(args, env=env)

    def kill(self) -> None:
        """Abrupt agent death (SIGKILL): the head's failure detection
        must notice via connection loss / heartbeat staleness."""
        try:
            self.proc.kill()
        except Exception:
            pass

    def terminate(self) -> None:
        try:
            self.proc.terminate()
        except Exception:
            pass

    def wait(self, timeout: Optional[float] = 10.0) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except Exception:
            self.kill()
