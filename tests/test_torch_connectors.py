"""The port's connectors, held to the RL-core cases of
`tests/test_connectors_offline.py` case for case.

The twin of its connector cases (pipelines, NormalizeObs, connectors in
the env runner) and of its GAE learner-connector case, with the same
asserts, limits and `slow` mark, on `ray_tpu_torch.rllib`, and of its
offline cases (BC, MARWIL, CQL) and its profile case, on
`ray_tpu_torch.util.tracing`, and of its Tune case (a PPO lr sweep,
with the learners on the CPU). The runtime fixture is this file's own
and shuts down at the module's end.
"""
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.connectors import (ClipObs, ConnectorPipeline,
                                            FlattenObs, FnConnector,
                                            NormalizeObs)
from ray_tpu_torch.rllib.env.env_runner import (EnvRunnerConfig,
                                                SingleAgentEnvRunner)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread, so this file's
    learners leave the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


# ----------------------------------------------------------- connectors
def test_pipeline_composition_and_editing():
    p = ConnectorPipeline([FlattenObs(), ClipObs(-1, 1)])
    p.append(FnConnector(lambda x: x * 2, name="double"))
    p.insert_before(ClipObs, FnConnector(lambda x: x + 100, name="big"))
    # order: flatten -> +100 -> clip -> *2
    out = p(np.zeros((2, 2, 2)))
    assert out.shape == (2, 4)
    np.testing.assert_array_equal(out, np.full((2, 4), 2.0))
    with pytest.raises(ValueError):
        p.insert_after(NormalizeObs, FlattenObs())


def test_normalize_obs_running_stats_and_state():
    n = NormalizeObs()
    rng = np.random.default_rng(0)
    data = rng.normal(5.0, 3.0, size=(500, 4))
    for chunk in np.split(data, 10):
        out = n(chunk)
    # after enough data the output is ~standardized
    out = n(data[:100])
    assert abs(float(out.mean())) < 0.3
    assert abs(float(out.std()) - 1.0) < 0.3
    # state rides get/set (restored runners keep their filter)
    n2 = NormalizeObs()
    n2.set_state(n.get_state())
    np.testing.assert_allclose(n2(data[:8]), n(data[:8]), atol=1e-6)


def test_env_runner_shape_changing_connector():
    """Buffers follow the TRANSFORMED obs shape (FlattenObs etc.)."""
    widen = FnConnector(lambda x: np.concatenate([x, x], axis=-1),
                        name="widen")
    r = SingleAgentEnvRunner(EnvRunnerConfig(
        env="CartPole-v1", num_envs=2, rollout_length=8, seed=0,
        env_to_module=[widen]))
    batch = r.sample()
    assert batch["obs"].shape == (9, 2, 8)      # 4 -> 8 features
    r.stop()


def test_env_runner_boundary_obs_transformed_once():
    """Stateful connectors see each raw obs exactly once: the stored
    bootstrap row of batch k IS batch k+1's first row."""
    n = NormalizeObs()
    r = SingleAgentEnvRunner(EnvRunnerConfig(
        env="CartPole-v1", num_envs=2, rollout_length=8, seed=0,
        env_to_module=[n]))
    b1 = r.sample()
    count_after = n._count
    # 8 steps x 2 envs of NEW obs + the initial obs batch = 18 rows
    assert count_after == (8 + 1) * 2
    b2 = r.sample()
    np.testing.assert_array_equal(b2["obs"][0], b1["obs"][-1])
    assert n._count == count_after + 8 * 2      # no double-counting
    r.stop()


def test_env_runner_with_connectors():
    """Obs connectors transform what the policy sees AND what the batch
    stores; learner/runner stay consistent."""
    shift = FnConnector(lambda x: x + 1000.0, name="shift")
    r = SingleAgentEnvRunner(EnvRunnerConfig(
        env="CartPole-v1", num_envs=2, rollout_length=8, seed=0,
        env_to_module=[shift]))
    batch = r.sample()
    assert batch["obs"].min() > 500.0       # stored obs are transformed
    r.stop()


def test_env_runner_normalize_connector_learns_stats():
    r = SingleAgentEnvRunner(EnvRunnerConfig(
        env="CartPole-v1", num_envs=2, rollout_length=32, seed=0,
        env_to_module=[NormalizeObs()]))
    r.sample()
    state = r.get_state()
    assert state["connectors"]["env_to_module"][0]["count"] > 0
    r2 = SingleAgentEnvRunner(EnvRunnerConfig(
        env="CartPole-v1", num_envs=2, rollout_length=32, seed=1,
        env_to_module=[NormalizeObs()]))
    r2.set_state(state)
    assert r2._env_to_module.connectors[0]._count > 0
    r2.stop()


# ------------------------------------------------------------ offline RL
def _heuristic_cartpole_policy(obs: np.ndarray) -> np.ndarray:
    """Angle+velocity balance heuristic (~200+ mean return)."""
    return (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int32)


def test_bc_clones_heuristic_policy(tmp_path):
    """Record transitions from a scripted expert, clone with BC, and
    match its behavior in-env (reference offline BC learning test)."""
    from ray_tpu_torch.rllib.offline import BCConfig, record_transitions
    path = record_transitions("CartPole-v1",
                              _heuristic_cartpole_policy,
                              str(tmp_path / "expert"),
                              num_steps=4000, seed=1)
    algo = (BCConfig().environment("CartPole-v1")
            .offline_data(path)
            .training(num_batches_per_iteration=60, lr=3e-3,
                      seed=0, device="cpu").build())
    first = algo.train()
    assert np.isfinite(first["bc_loss"])
    for _ in range(5):
        last = algo.train()
    assert last["bc_loss"] < first["bc_loss"]
    ev = algo.evaluate(num_episodes=5)
    assert ev["episode_return_mean"] >= 150, ev


# --------------------------------------------------------------- tracing
@pytest.mark.slow    # ~20s (r16 tier-1 budget); annotate/profile
# mechanics stay tier-1 in test_tracing_plane (annotate-lands-in-
# recorder + timeline export)
def test_tracing_profile_and_annotate(tmp_path):
    from ray_tpu_torch.util import tracing
    logdir = str(tmp_path / "tb")

    @tracing.annotate_fn("matmul_step")
    def step(x):
        return (x @ x).sum()

    with tracing.profile(logdir):
        with tracing.annotate("outer"):
            float(step(torch.ones((32, 32))))
    # a trace capture landed on disk
    found = []
    for root, _dirs, files in os.walk(logdir):
        found += [f for f in files if "trace" in f or f.endswith(".pb")
                  or f.endswith(".json.gz")]
    assert found, f"no trace files under {logdir}"


@pytest.mark.slow        # ~13s learning soak; BC clone gate keeps
                         # offline training in tier-1
def test_marwil_beats_noisy_dataset(tmp_path):
    """MARWIL's advantage weighting upweights the expert's actions in a
    MIXED dataset (50% random actions) where plain BC would clone the
    noise too (reference marwil learning tests)."""
    from ray_tpu_torch.rllib.offline import MARWILConfig, record_transitions
    rng = np.random.default_rng(0)

    def noisy_expert(obs):
        a = _heuristic_cartpole_policy(obs)
        flip = rng.random(len(a)) < 0.5
        return np.where(flip, rng.integers(0, 2, len(a)), a).astype(
            np.int32)

    path = record_transitions("CartPole-v1", noisy_expert,
                              str(tmp_path / "mixed"),
                              num_steps=6000, seed=2)
    algo = (MARWILConfig().environment("CartPole-v1")
            .offline_data(path)
            .training(beta=2.0, num_batches_per_iteration=60,
                      seed=0, device="cpu").build())
    for _ in range(10):
        m = algo.train()
    assert np.isfinite(m["marwil_loss"])
    ev = algo.evaluate(num_episodes=5)
    # random policy gets ~20; cloning 50%-noise data ~50-80; the
    # advantage weight must recover clearly better behavior
    assert ev["episode_return_mean"] >= 100, ev


@pytest.mark.slow    # ~12s (r16 tier-1 budget); offline-learning
# gates keep tier-1 siblings: test_bc_clones_heuristic_policy +
# test_marwil_beats_noisy_dataset
def test_cql_learns_from_offline_data(tmp_path):
    """Discrete CQL: TD + conservative penalty trains a usable greedy
    policy from recorded data (reference cql learning tests)."""
    from ray_tpu_torch.rllib.offline import CQLConfig, record_transitions
    path = record_transitions("CartPole-v1",
                              _heuristic_cartpole_policy,
                              str(tmp_path / "expert_cql"),
                              num_steps=6000, seed=3)
    algo = (CQLConfig().environment("CartPole-v1")
            .offline_data(path)
            .training(num_batches_per_iteration=60, seed=0,
                      device="cpu").build())
    for _ in range(10):
        m = algo.train()
    assert np.isfinite(m["td_loss"]) and np.isfinite(m["cql_loss"])
    ev = algo.evaluate(num_episodes=5)
    assert ev["episode_return_mean"] >= 100, ev


@pytest.mark.slow        # ~29s jit parity; the non-jit GAE path
                         # stays in tier-1
def test_learner_connector_gae_matches_in_jit(ray_cluster):
    """GAE as a learner connector (reference rllib/connectors/learner/
    general_advantage_estimation.py) produces the same learning signal
    as the learner's own GAE: identical seeds + batches give closely
    matching update metrics."""
    import numpy as np

    from ray_tpu_torch.rllib.connectors import (GeneralAdvantageEstimation,
                                                StandardizeAdvantages)
    from ray_tpu_torch.rllib.core.learner import (PPOLearner,
                                                  PPOLearnerConfig)

    rng = np.random.default_rng(0)
    T, N, D = 16, 8, 4
    batch = {
        "obs": rng.normal(size=(T + 1, N, D)).astype(np.float32),
        "actions": rng.integers(0, 2, size=(T, N)).astype(np.int32),
        "logp": np.full((T, N), -0.69, np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "terminateds": np.zeros((T, N), np.float32),
        "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
        "mask": np.ones((T, N), np.float32),
    }
    base = dict(obs_dim=D, num_actions=2, hidden=(16,), seed=7,
                num_epochs=1, num_minibatches=2, device="cpu")
    l_jit = PPOLearner(PPOLearnerConfig(**base))
    l_conn = PPOLearner(PPOLearnerConfig(
        **base,
        learner_connectors=[
            GeneralAdvantageEstimation(gamma=0.99, lambda_=0.95),
            StandardizeAdvantages()]))
    m_jit = l_jit.update({k: v.copy() for k, v in batch.items()})
    m_conn = l_conn.update({k: v.copy() for k, v in batch.items()})
    for key in ("policy_loss", "vf_loss", "entropy"):
        assert abs(m_jit[key] - m_conn[key]) < 1e-3, (
            key, m_jit[key], m_conn[key])
    # and the params moved identically (same data, same advantages)
    for a, b in zip(l_jit.params.values(), l_conn.params.values()):
        assert np.allclose(a.detach().numpy(), b.detach().numpy(),
                           atol=1e-4)


@pytest.mark.slow        # ~17s; PPO learning and Tune sweeps each
                         # keep their own tier-1 gates (870s budget,
                         # ROADMAP.md)
def test_ppo_as_tune_trainable_lr_sweep(ray_cluster):
    """Algorithms register as Tune trainables (reference Algorithm IS a
    Trainable, algorithm.py:227): a PPO lr grid sweep runs through
    tune.fit and reports per-trial metrics."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import PPOConfig, tune_trainable

    tuner = tune.Tuner(
        tune_trainable(PPOConfig),
        param_space={
            "lr": tune.grid_search([3e-4, 1e-3]),
            "env": "CartPole-v1",
            "num_envs_per_env_runner": 8,
            "rollout_length": 32,
            "num_epochs": 2,
            "num_minibatches": 2,
            "device": "cpu",
            "_num_iterations": 3,
        },
        tune_config=tune.TuneConfig(metric="episode_return_mean",
                                    mode="max"))
    results = tuner.fit()
    assert len(results) == 2
    lrs = set()
    for r in results:
        assert r.metrics is not None
        assert r.metrics["training_iteration"] == 3
        lrs.add(r.config["lr"])
    assert lrs == {3e-4, 1e-3}
    best = results.get_best_result()
    assert best.metrics["episode_return_mean"] is not None
