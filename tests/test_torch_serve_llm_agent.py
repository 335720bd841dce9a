"""`serve_llm` with its replica on a node agent, on the CPU, against the
JAX package.

The head owns no GPU and two CPUs; a node agent process
(`cluster_utils.NodeAgentProcess`) joins with a custom resource, and the
replica asks for that resource, so Serve places it on the agent. The
weights are `put` on the head: the replica's `get` relays them through
the object plane into the agent's store. Its greedy tokens must equal
the JAX `EngineCore`'s at `tiny()` on the same weights, carried across
by `params_from_jax`, exactly: both run plain f32 on the CPU. The fast
sibling sends an agent-side actor a multi-tensor ref `put` on the head
and holds each tensor's checksum to the head's.

The runtime fixture is this file's own; the port's runtime is shut down
when each test ends.
"""
import threading
import time

import jax
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.models.config import tiny as jtiny
from ray_tpu.models.transformer import Transformer as JTransformer
from ray_tpu.serve.llm.engine import EngineCore as JEngineCore
from ray_tpu_torch import bench, serve
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.object_transfer import OBJECT_PLANE_STATS
from ray_tpu_torch.cluster_utils import NodeAgentProcess
from ray_tpu_torch.models.config import tiny
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve import llm

PROMPTS = {"a": ([1, 2, 3, 4, 5, 6, 7], 9),
           "b": (list(range(30, 52)), 5),
           "c": ([200], 7)}
AGENT = {"agent_a": 1.0}
INLINE = 4096


@pytest.fixture()
def head_and_agent(monkeypatch):
    """A head with no GPU and two CPUs, and one node agent process that
    holds the `agent_a` resource; (runtime, agent's node id). A low inline
    limit, which the agent inherits, sends `tiny()`'s matrices out of band,
    as llama3-8b's are."""
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    monkeypatch.setenv("RAY_TPU_INLINE_THRESHOLD_BYTES", str(INLINE))
    CONFIG.reload()
    rt = ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    agent = None
    try:
        agent = NodeAgentProcess(num_cpus=2, resources=AGENT)
        deadline = time.monotonic() + 30
        while not (rt.cluster.get_node(agent.node_id) is not None
                   and rt.cluster.get_node(agent.node_id).alive):
            assert time.monotonic() < deadline, "the agent never registered"
            time.sleep(0.05)
        yield rt, agent.node_id
    finally:
        try:
            serve.shutdown()
        finally:
            if agent is not None:
                agent.terminate()
                agent.wait(10)
            ray_tpu_torch.shutdown()
            monkeypatch.delenv("RAY_TPU_INLINE_THRESHOLD_BYTES")
            CONFIG.reload()


def _actor_nodes(rt) -> dict:
    """Each live actor's node, by actor id, from the head's own books."""
    where = {w["worker_id"]: w["node_id"]
             for w in rt.state_op("list_workers")}
    return {a["actor_id"]: where.get(a["worker_id"])
            for a in rt.state_op("list_actors") if a["state"] == "ALIVE"}


@pytest.fixture(scope="module")
def weights():
    jparams = JTransformer(jtiny()).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             tiny(), device="cpu")
    return jparams, params


def _out_of_band_bytes(tree) -> int:
    sizes = [t.numel() * t.element_size() for t in bench.leaves(tree)]
    return sum(n for n in sizes if n >= INLINE)


def test_an_agent_actor_gets_a_weights_ref_put_on_the_head(head_and_agent,
                                                           weights):
    """Every tensor of a multi-tensor ref `put` on the head reaches an
    actor on the agent with the head's bytes."""
    rt, agent_node = head_and_agent
    _, params = weights

    def checksums(tree, path=""):
        """sha256 of each tensor's bytes, by its path in the tree (a
        function of the test, so it travels to the worker by value)."""
        import hashlib

        import torch
        if isinstance(tree, (dict, list, tuple)):
            items = (tree.items() if isinstance(tree, dict)
                     else enumerate(tree))
            return {k: v for key, sub in items
                    for k, v in checksums(sub, f"{path}/{key}").items()}
        return {path: hashlib.sha256(
            tree.contiguous().view(torch.uint8).numpy()).hexdigest()}

    @ray_tpu_torch.remote(resources={"agent_a": 0.5})
    class Holder:
        """An actor on the agent that `get`s the ref it is handed."""

        def checksums(self, refs):
            import os
            return (os.environ["RAY_TPU_NODE_ID"],
                    checksums(ray_tpu_torch.get(refs[0])))

    ref = ray_tpu_torch.put(params)
    holder = Holder.remote()
    served = OBJECT_PLANE_STATS["serve_bytes"]
    node, got = ray_tpu_torch.get(holder.checksums.remote([ref]),
                                  timeout=60)
    assert node == agent_node != rt.head_node_id
    assert got == checksums(params)
    assert len(got) > 1
    # the tensors crossed from the head's store through the object plane
    big = _out_of_band_bytes(params)
    assert big > 0 and OBJECT_PLANE_STATS["serve_bytes"] - served >= big


def test_serve_llm_replica_on_an_agent_matches_jax_engine(head_and_agent,
                                                          weights):
    """The replica runs on the agent's node, and its greedy tokens equal
    the JAX EngineCore's on the same weights, exactly."""
    rt, agent_node = head_and_agent
    jparams, params = weights
    before = set(_actor_nodes(rt))
    served = OBJECT_PLANE_STATS["serve_bytes"]
    ref = ray_tpu_torch.put(params)
    handle = llm.serve_llm(name="on-agent", model="tiny", weights=ref,
                           num_replicas=1, device="cpu", num_pages=64,
                           page_size=8, max_batch=4,
                           ray_actor_options={"resources": {"agent_a": 1.0}})
    del ref
    streams = {rid: handle.generate(p, max_tokens=n, timeout_s=60)
               for rid, (p, n) in PROMPTS.items()}
    got = {}

    def run(rid, s):
        got[rid] = s.tokens()

    threads = [threading.Thread(target=run, args=item)
               for item in streams.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)

    # the one replica is the one new actor on the agent's node; the
    # Serve controller stays on the head
    new = {a: n for a, n in _actor_nodes(rt).items() if a not in before}
    assert sorted(new.values()).count(agent_node) == 1, new
    assert all(n == rt.head_node_id for n in new.values() if n != agent_node)
    (st,) = handle.stats()
    assert st["finished"] == len(PROMPTS)
    assert (OBJECT_PLANE_STATS["serve_bytes"] - served
            >= _out_of_band_bytes(params) > 0)

    core = JEngineCore(jtiny(), jparams, num_pages=64, page_size=8,
                       max_batch=4)
    for rid, (p, n) in PROMPTS.items():
        core.submit(p, max_tokens=n, rid=rid)
    want = {}
    while core.has_work:
        for ev in core.step():
            if ev["token"] is not None:
                want.setdefault(ev["rid"], []).append(ev["token"])
    assert got == want
    assert all(len(got[rid]) == n for rid, (_, n) in PROMPTS.items())
