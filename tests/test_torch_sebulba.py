"""Sebulba RL subsystem (r20): actor/learner split invariants, on the
port.

The twin of `tests/test_sebulba.py`, case for case, with the same
asserts, limits and `slow` mark, on `ray_tpu_torch.rllib.sebulba`. The
learners run on the CPU by name (`device="cpu"`); weights are the
learner's state dict.

Tier-1 (fast, in-process): inference-actor admission batching (N
concurrent callers -> fewer forwards than requests), weight-version
monotonicity (stale publishes dropped, force overrides for restore
fencing), ring-depth-bounds-staleness on the full local data path,
failover-mid-episode exact step accounting (the env never steps twice
for one decision), learner parity vs the single-process IMPALA
learner, and the ring telemetry counters the metrics plane mirrors.
The multi-process e2e (real actors over two node agents, direct-plane
acting, chaos-free) is slow-marked — its fast sibling is the local
trainer path below.
"""
import os
import threading
import time

import numpy as np
import pytest

import torch

from ray_tpu_torch._private.config import CONFIG

OBS_DIM, NUM_ACTIONS = 4, 2


@pytest.fixture
def rl_env():
    """Clean RL knobs + zeroed counters around each test."""
    from ray_tpu_torch.rllib.sebulba import stats
    keys = ("RAY_TPU_RL_RING_DEPTH", "RAY_TPU_RL_INFER_MAX_BATCH",
            "RAY_TPU_RL_INFER_WAIT_MS", "RAY_TPU_RL_STEP_DELAY_S",
            "RAY_TPU_RL_PUBLISH_INTERVAL")
    saved = {k: os.environ.pop(k, None) for k in keys}
    CONFIG.reload()
    stats.reset()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    CONFIG.reload()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread, so this file's
    learners leave the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_inference(seed=0, **kw):
    from ray_tpu_torch.rllib.sebulba import InferenceActor
    return InferenceActor(OBS_DIM, NUM_ACTIONS, (16,), seed=seed, **kw)


def test_admission_batching(rl_env):
    """N concurrent act() callers coalesce into shared forward passes:
    one policy evaluation serves many callers (the r19 admission idiom
    on the RL plane)."""
    os.environ["RAY_TPU_RL_INFER_WAIT_MS"] = "40"
    CONFIG.reload()
    srv = _mk_inference()
    try:
        n_callers, rows = 8, 4
        results = [None] * n_callers
        barrier = threading.Barrier(n_callers)

        def call(i):
            barrier.wait()
            obs = np.random.default_rng(i).normal(
                size=(rows, OBS_DIM)).astype(np.float32)
            results[i] = srv.act(obs)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n_callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        st = srv.stats()
        assert st["requests"] == n_callers
        assert st["forwards"] < st["requests"], st
        assert st["max_batch"] >= 2, st
        assert st["batched_obs"] == n_callers * rows
        for actions, logp, version in results:
            assert actions.shape == (rows,) and logp.shape == (rows,)
            assert version == -1      # factory weights, never published
    finally:
        srv.close()


def test_weight_version_monotonicity(rl_env):
    """Out-of-order publishes can never roll a policy back; `force`
    (checkpoint-restore fencing) is the one sanctioned override."""
    srv = _mk_inference()
    try:
        w = srv.module.state_dict()
        assert srv.set_weights(w, 1) == 1
        assert srv.set_weights(w, 3) == 3
        assert srv.set_weights(w, 2) == 3       # stale: dropped
        assert srv.policy_version == 3
        assert srv.stats()["stale_weight_drops"] == 1
        out = srv.act(np.zeros((2, OBS_DIM), np.float32))
        assert out[2] == 3                      # callers see the clock
        assert srv.set_weights(w, 2, force=True) == 2   # restore fence
    finally:
        srv.close()


def test_ring_depth_bounds_staleness(rl_env):
    """The tentpole invariant: ring depth is the policy-staleness
    bound. One runner, depth 2, publish every update -> no consumed
    shard may be more than depth+2 versions behind (depth in-ring + 1
    being produced + 1 publish lag)."""
    from ray_tpu_torch.rllib.sebulba import Sebulba, SebulbaConfig
    depth = 2
    cfg = SebulbaConfig(
        local=True, num_env_runners=1, num_inference_actors=1,
        num_envs_per_runner=4, rollout_length=8, ring_depth=depth,
        publish_interval=1, num_updates_per_iteration=10, seed=0,
        device="cpu")
    tr = cfg.build()
    try:
        m = tr.train()
        assert m["num_learner_updates"] == 10
        assert m["seq_gaps"] == 0
        assert tr.learner.staleness_max <= depth + 2, \
            f"staleness {tr.learner.staleness_max} > depth+2"
        # flow control held: the ring never overfilled
        from ray_tpu_torch.experimental.wire_channel import ring_stats
        assert ring_stats()["occupancy_max"] <= depth + 1
    finally:
        tr.stop()


class _Flaky:
    """Local inference proxy that dies after `fail_after` calls."""

    def __init__(self, inner, fail_after):
        self._inner = inner
        self._calls = 0
        self.fail_after = fail_after

    def act(self, obs):
        self._calls += 1
        if self._calls > self.fail_after:
            raise RuntimeError("inference actor down")
        return self._inner.act(obs)


def test_failover_exact_step_accounting(rl_env):
    """Mid-episode failover re-asks the SAME observation on the next
    handle — the env steps exactly once per decision, so shard seqs
    stay contiguous and act attempts = successes + failures."""
    from ray_tpu_torch.rllib.sebulba import (SebulbaEnvRunner,
                                             SebulbaRunnerConfig)
    primary = _mk_inference(seed=0)
    survivor = _mk_inference(seed=1)
    flaky = _Flaky(primary, fail_after=10)
    cfg = SebulbaRunnerConfig(num_envs=4, rollout_length=8,
                              ring_depth=2, seed=0)
    runner = SebulbaEnvRunner(cfg, 0, [flaky, survivor])
    try:
        shards = [runner.collect_shard() for _ in range(3)]
        T = cfg.rollout_length
        assert [s["seq"] for s in shards] == [1, 2, 3]
        st = runner.stats()
        assert st["failovers"] >= 1                 # the kill landed
        # every decision cost exactly one successful act: attempts
        # beyond 3*T are precisely the failed ones that were retried
        assert st["act_calls"] == 3 * T + st["failovers"]
        for s in shards:
            assert s["steps"] == int(s["mask"].sum())
            assert s["actions"].shape == (T, cfg.num_envs)
    finally:
        runner.stop()
        primary.close()
        survivor.close()


def test_learner_parity_vs_impala(rl_env):
    """SebulbaLearner's update_shard is the IMPALA V-trace update:
    same seed + same batch -> bitwise-identical parameter trees."""
    from ray_tpu_torch.rllib.algorithms.impala import (IMPALALearner,
                                                       IMPALALearnerConfig)
    from ray_tpu_torch.rllib.sebulba import SebulbaLearner
    lc = IMPALALearnerConfig(obs_dim=OBS_DIM, num_actions=NUM_ACTIONS,
                             hidden=(16,), seed=7, device="cpu")
    ref = IMPALALearner(lc)
    seb = SebulbaLearner(lc)
    rng = np.random.default_rng(3)
    T, N = 8, 4
    batch = {
        "obs": rng.normal(size=(T + 1, N, OBS_DIM)).astype(np.float32),
        "actions": rng.integers(0, NUM_ACTIONS,
                                size=(T, N)).astype(np.int32),
        "logp": rng.normal(size=(T, N)).astype(np.float32) * 0.1 - 0.7,
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "terminateds": np.zeros((T, N), np.float32),
        "dones": np.zeros((T, N), np.float32),
        "mask": np.ones((T, N), np.float32),
    }
    shard = dict(batch, runner=0, seq=1, steps=T * N, version=0)
    m_ref = ref.update(batch)
    m_seb = seb.update_shard(shard)
    assert m_seb["staleness"] == 0.0
    assert seb.shards_consumed == 1 and seb.steps_consumed == T * N
    for a, b in zip(ref.params.values(), seb.params.values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=0)
    assert m_ref["policy_loss"] == pytest.approx(m_seb["policy_loss"])


def test_ring_telemetry_counters(rl_env):
    """Satellite 1: occupancy + stall counters — ring pressure is the
    staleness signal, and it must be visible (CH_STATS + ring_stats,
    mirrored as ray_tpu_channel gauges at scrape time)."""
    from ray_tpu_torch.experimental import wire_channel as wc
    before = dict(wc.CH_STATS)
    ch = wc.serve_channel(n_readers=1, depth=1, label="tlm")
    w = ch.writer()
    rd = ch.reader(0)
    try:
        w.write(np.arange(8, dtype=np.float32))
        assert wc.ring_stats()["occupancy"] == 1     # unacked in-ring
        got = [None]
        t = threading.Thread(     # depth 1: second write must block
            target=lambda: (w.write(b"second"), got.__setitem__(0, 1)))
        t.start()
        time.sleep(0.15)
        assert got[0] is None                        # still blocked
        rd.read(timeout=5.0)                         # ack frees a slot
        t.join(timeout=5.0)
        assert got[0] == 1
        rd.read(timeout=5.0)
        assert wc.CH_STATS["writes"] - before["writes"] == 2
        assert wc.CH_STATS["reads"] - before["reads"] == 2
        assert wc.CH_STATS["writer_block_ns"] > before["writer_block_ns"]
        assert wc.CH_STATS["reader_wait_ns"] >= before["reader_wait_ns"]
        deadline = time.monotonic() + 5.0    # acks land asynchronously
        while (wc.ring_stats()["occupancy"] != 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert wc.ring_stats()["occupancy"] == 0
        # the metrics plane renders them as ray_tpu_channel series
        from ray_tpu_torch._private import metrics_plane as mp
        if mp.enabled():
            dump = mp.local_dump()["metrics"]
            assert "ray_tpu_channel" in dump
    finally:
        rd.release()
        w.release()
        ch.destroy()


@pytest.mark.slow
def test_sebulba_e2e_cluster():
    """Full split over two node agents: 4 env-runner actors on one
    node act against 2 inference actors on the other over the direct
    plane; the driver learner consumes rings and publishes versioned
    weights. Fast sibling: test_ring_depth_bounds_staleness."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    from ray_tpu_torch.rllib.sebulba import Sebulba, SebulbaConfig
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=0, resources={"head": 4.0})
    agents = [NodeAgentProcess(num_cpus=4, resources={"rl_infer": 10.0}),
              NodeAgentProcess(num_cpus=4, resources={"rl_env": 10.0})]
    tr = None
    try:
        deadline = time.monotonic() + 30
        while (time.monotonic() < deadline
               and len(rt.cluster.alive_nodes()) < 3):
            time.sleep(0.1)
        assert len(rt.cluster.alive_nodes()) >= 3
        cfg = SebulbaConfig(
            num_env_runners=4, num_inference_actors=2,
            num_envs_per_runner=4, rollout_length=8,
            num_updates_per_iteration=8, device="cpu",
            inference_options={"num_cpus": 0,
                               "resources": {"rl_infer": 1.0},
                               "max_concurrency": 16},
            runner_options={"num_cpus": 0,
                            "resources": {"rl_env": 1.0}})
        tr = cfg.build()
        m = tr.train()
        assert m["num_learner_updates"] == 8
        assert m["seq_gaps"] == 0
        assert m["staleness_max"] <= (CONFIG.rl_ring_depth + 2) * 4
        stats = ray_tpu_torch.get([h.stats.remote() for h in tr._infer])
        assert sum(s["forwards"] for s in stats) <= \
            sum(s["requests"] for s in stats)
        assert all(s["policy_version"] == tr.learner.version
                   or s["policy_version"] >= 0 for s in stats)
    finally:
        if tr is not None:
            tr.stop()
        for a in agents:
            a.terminate()
        for a in agents:
            a.wait(10)
        ray_tpu_torch.shutdown()
