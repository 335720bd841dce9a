"""The port's RL algorithms, held to `tests/test_rllib.py` case for case.

The twin of its remaining cases (V-trace, IMPALA, DQN, SAC, APPO, C51,
noisy nets, DreamerV3 and the unified config surface) with the same
asserts, limits and `slow` marks, on `ray_tpu_torch.rllib`. Learners
run on the CPU by name (`device="cpu"`); the envs are gymnasium's, as in
the JAX tests. The runtime fixtures are this file's own, on the port's
runtime, and shut it down at the module's end. Beside the twins: the
rule that gymnasium is imported only in the env seam, and IMPALA's
learner as a group of two gloo ranks.
"""
import ast
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture()
def fresh_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=4)
    yield rt
    ray_tpu_torch.shutdown()


# --------------------------------------------------------------- vtrace
def test_vtrace_reduces_to_gae_on_policy():
    """With on-policy data and clips >=1, v-trace advantages equal
    GAE(lambda=1) targets: vs_t = discounted return-to-go of deltas."""
    from ray_tpu_torch.rllib.algorithms import vtrace_returns
    T, N = 12, 3
    rng = np.random.default_rng(1)
    values = torch.as_tensor(rng.normal(size=(T + 1, N)), dtype=torch.float32)
    rewards = torch.as_tensor(rng.normal(size=(T, N)), dtype=torch.float32)
    terms = np.zeros((T, N), np.float32)
    terms[5, 1] = 1.0                       # one terminated episode
    dones = terms.copy()
    logp = torch.as_tensor(rng.normal(size=(T, N)), dtype=torch.float32)
    vs, pg_adv, rho = vtrace_returns(
        values, rewards, torch.as_tensor(terms), torch.as_tensor(dones),
        logp, logp, 0.99, 1.0, 1.0)         # on-policy: rho = 1
    np.testing.assert_allclose(rho.numpy(), 1.0, atol=1e-6)
    # reference recursion in plain numpy
    v = values.numpy()
    delta = rewards.numpy() + 0.99 * (1 - terms) * v[1:] - v[:-1]
    adv = np.zeros((T + 1, N), np.float32)
    for t in range(T - 1, -1, -1):
        adv[t] = delta[t] + 0.99 * (1 - dones[t]) * adv[t + 1]
    np.testing.assert_allclose(vs.numpy(), v[:-1] + adv[:-1],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.slow    # ~10s (r16 tier-1 budget); IMPALA keeps its
# tier-1 siblings (vtrace math, learner updates, actor-manager
# suite); the cartpole learning gate was already slow-marked
def test_impala_async_pipeline_runs(ray_cluster):
    """Structural test: 2 async runners keep the queue fed; updates
    consume off-policy batches; weights version advances."""
    from ray_tpu_torch.rllib.algorithms import IMPALAConfig
    algo = (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_length=16)
            .training(num_updates_per_iteration=4, device="cpu").build())
    try:
        m1 = algo.train()
        m2 = algo.train()
        assert m2["training_iteration"] == 2
        assert m2["num_learner_updates"] == 8
        # every runner received fresh weights at least once (the exact
        # count depends on sample/update interleaving)
        assert m2["num_weight_broadcasts"] >= 2
        assert m2["num_env_steps_sampled_lifetime"] > (
            m1["num_env_steps_sampled_lifetime"])
        assert "mean_rho" in m2 and m2["mean_rho"] > 0
    finally:
        algo.stop()


@pytest.mark.slow
def test_impala_cartpole_learning_gate(fresh_cluster):
    """IMPALA with 4 async env runners must learn CartPole to >=450
    (reference rllib/tuned_examples/impala/cartpole_impala.py gate),
    exercising stale-weights sampling + v-trace correction end to end.

    Async learning depends on real sample/update interleaving, which
    host load perturbs — one retry with a different seed keeps the gate
    meaningful without being load-flaky (the reference's tuned examples
    run on dedicated CI machines for the same reason)."""
    from ray_tpu_torch.rllib.algorithms import IMPALAConfig
    best = 0.0
    for seed in (1, 7):
        algo = (IMPALAConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=4, num_envs_per_env_runner=8,
                             rollout_length=32)
                .training(lr=6e-4, ent_coef=0.01,
                          num_updates_per_iteration=16, seed=seed,
                          device="cpu")
                .build())
        try:
            for i in range(200):
                m = algo.train()
                r = m.get("episode_return_mean", float("nan"))
                if r == r:
                    best = max(best, r)
                if best >= 450:
                    break
        finally:
            algo.stop()
        if best >= 450:
            break
    assert best >= 450, f"IMPALA failed to learn CartPole: best={best}"


def test_impala_learner_group_of_two_ranks(ray_cluster):
    """`num_devices=2`: IMPALA's learner is a group of two gloo learner
    actors, each taking half the batch's columns; its updates count and
    its weights reach the runners."""
    from ray_tpu_torch.rllib.algorithms import IMPALAConfig
    algo = (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                         rollout_length=8)
            .training(num_updates_per_iteration=2, num_devices=2,
                      device="cpu").build())
    try:
        m = algo.train()
        assert m["num_learner_updates"] == 2
        assert np.isfinite(m["policy_loss"]) and m["mean_rho"] > 0
        w = algo.learner.get_weights()
        runner_w = algo.env_runner_group.manager.foreach_actor(
            "get_weights").values()[0]
        assert set(w) == set(runner_w)
    finally:
        algo.stop()


# ------------------------------------------------------------------ dqn
def test_dqn_update_reduces_td_loss():
    """Double-DQN update drives TD loss down on replayed experience
    (structural, off the learning gate's critical path)."""
    from ray_tpu_torch.rllib.algorithms import DQNConfig
    algo = (DQNConfig().environment("CartPole-v1")
            .training(num_envs_per_env_runner=4,
                      rollout_steps_per_iteration=64,
                      learning_starts=100, train_batch_size=32,
                      num_updates_per_iteration=8, seed=2,
                      device="cpu").build())
    try:
        m1 = algo.train()
        assert m1["buffer_size"] > 0
        losses = []
        for _ in range(6):
            m = algo.train()
            if np.isfinite(m["td_loss"]):
                losses.append(m["td_loss"])
        assert losses and np.isfinite(losses).all()
        assert m["num_updates_lifetime"] > 0
        assert 0.0 <= m["epsilon"] <= 1.0
    finally:
        algo.stop()


@pytest.mark.slow
def test_dqn_cartpole_learning_gate(fresh_cluster):
    """DQN must clear 200 mean return on CartPole (a meaningful
    off-policy learning signal within CI budget; the reference's full
    gate trains far longer)."""
    from ray_tpu_torch.rllib.algorithms import DQNConfig
    best = 0.0
    for seed in (0, 3):
        algo = (DQNConfig().environment("CartPole-v1")
                .training(num_envs_per_env_runner=8,
                          rollout_steps_per_iteration=64,
                          num_updates_per_iteration=32,
                          epsilon_timesteps=8000, lr=5e-4,
                          seed=seed, device="cpu").build())
        try:
            for i in range(150):
                m = algo.train()
                r = m.get("episode_return_mean", float("nan"))
                if r == r:
                    best = max(best, r)
                if best >= 200:
                    break
        finally:
            algo.stop()
        if best >= 200:
            break
    assert best >= 200, f"DQN failed to learn CartPole: best={best}"


# --------------------------------------------------------------- SAC
@pytest.mark.slow        # ~31s; DQN/IMPALA update gates keep the
                         # learner-update path in tier-1
def test_sac_update_moves_critic_and_alpha():
    """One SAC update step: critic loss finite, alpha autotunes, target
    nets move by polyak tau toward the online critics."""
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig
    algo = SACConfig().training(hidden=(32, 32),
                                learning_starts=0,
                                random_steps=10_000,
                                num_updates_per_iteration=4,
                                rollout_steps_per_iteration=40,
                                train_batch_size=32, device="cpu").build()
    t_before = {k: v.clone() for k, v in algo.target.state_dict().items()}
    alpha_before = float(torch.exp(algo.log_alpha.detach()))
    m = algo.train()
    assert np.isfinite(m["critic_loss"])
    assert np.isfinite(m["actor_loss"])
    assert m["alpha"] != alpha_before        # autotune stepped
    t_after = algo.target.state_dict()
    moved = [float((t_before[k] - t_after[k]).abs().max()) for k in t_before]
    assert max(moved) > 0.0
    algo.stop()


@pytest.mark.slow
def test_sac_pendulum_learning_gate():
    """Parity with reference rllib/tuned_examples/sac/pendulum_sac.py:
    SAC must clearly solve the hang-up phase (mean return > -600 from a
    ~-1400 random-policy start)."""
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig
    algo = SACConfig().environment("Pendulum-v1").training(
        hidden=(128, 128), seed=0, device="cpu").build()
    best = -float("inf")
    for i in range(70):
        m = algo.train()
        r = m.get("episode_return_mean", float("nan"))
        if r == r:
            best = max(best, r)
        if best > -600:
            break
    algo.stop()
    assert best > -600, f"SAC failed to learn Pendulum: best={best}"


def test_dqn_dueling_and_nstep_shapes():
    """Dueling head: Q = V + A - mean(A) (mean-zero advantage); n-step
    runner rows carry shortened horizons at episode ends."""
    from ray_tpu_torch.rllib.algorithms.dqn import (DQNConfig, QEnvRunner,
                                                    QModule)
    from ray_tpu_torch.rllib.core.rl_module import to_numpy_params
    m = QModule(4, 2, (16,), dueling=True,
                generator=torch.Generator().manual_seed(0))
    obs = np.ones((3, 4), np.float32)
    with torch.no_grad():
        q = m(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(q, m.forward_np(
        to_numpy_params(m, m.state_dict()), obs), rtol=1e-5)
    # V + A - mean(A): recenter check — subtracting the action-mean of
    # Q recovers the advantage's mean-zero structure
    a_centered = q - q.mean(-1, keepdims=True)
    assert np.allclose(a_centered.mean(-1), 0.0, atol=1e-6)

    cfg = DQNConfig().training(n_step=3, num_envs_per_env_runner=4,
                               seed=0)
    runner = QEnvRunner(cfg)
    batch = runner.sample(40)
    assert set(batch) >= {"obs", "actions", "rewards", "new_obs",
                          "terminateds", "nsteps"}
    ns = batch["nsteps"]
    assert ns.max() == 3
    assert ((ns == 1) | (ns == 2) | (ns == 3)).all()
    # shortened horizons exist only at episode boundaries: every such
    # row's window reaches the episode's final transition, which (in
    # short CartPole episodes, no truncation) is a termination
    short = ns < 3
    assert short.any()
    assert (batch["terminateds"][short] == 1.0).all()
    runner.stop()


def test_appo_clipped_loss_and_target_refresh():
    """APPO learner: clipped surrogate on v-trace advantages; the
    target network refreshes every target_network_update_freq
    updates."""
    from ray_tpu_torch.rllib.algorithms.appo import (APPOLearner,
                                                     APPOLearnerConfig)
    ln = APPOLearner(APPOLearnerConfig(
        obs_dim=4, num_actions=2, hidden=(16,),
        target_network_update_freq=2, seed=0, device="cpu"))
    T, N = 8, 4
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.normal(size=(T + 1, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
        "logp": np.full((T, N), -0.7, np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "terminateds": np.zeros((T, N), np.float32),
        "dones": np.zeros((T, N), np.float32),
        "mask": np.ones((T, N), np.float32),
    }
    t0 = {k: v.clone() for k, v in ln.target.state_dict().items()}
    m1 = ln.update(batch)                    # version 1: no refresh yet
    assert np.isfinite(m1["policy_loss"]) and m1["kl_to_target"] >= 0
    assert all(torch.allclose(t0[k], v)
               for k, v in ln.target.state_dict().items())
    ln.update(batch)                         # version 2: refresh
    assert not all(torch.allclose(t0[k], v)
                   for k, v in ln.target.state_dict().items())


def test_appo_config_builds_appo(ray_cluster):
    """`APPOConfig().build()` is APPO, with APPO's learner (ROADMAP queue
    3, item 22: the JAX `IMPALAConfig.build` returns IMPALA for both
    configs)."""
    from ray_tpu_torch.rllib.algorithms.appo import (APPO, APPOConfig,
                                                     APPOLearner)
    algo = APPOConfig().environment("CartPole-v1").env_runners(
        num_env_runners=1, num_envs_per_env_runner=2,
        rollout_length=8).training(device="cpu").build()
    try:
        assert type(algo) is APPO
        assert type(algo.learner) is APPOLearner
        assert "kl_to_target" in algo.train()
    finally:
        algo.stop()


@pytest.mark.slow
def test_appo_cartpole_learning_gate(fresh_cluster):
    """Parity with reference rllib/tuned_examples/appo/cartpole_appo.py:
    async clipped-surrogate learning reaches >=300 on CartPole."""
    from ray_tpu_torch.rllib.algorithms.appo import APPOConfig
    algo = APPOConfig().environment("CartPole-v1").env_runners(
        num_env_runners=2, num_envs_per_env_runner=16).training(
            seed=0, device="cpu").build()
    best = 0.0
    for _ in range(150):
        m = algo.train()
        r = m.get("episode_return_mean", float("nan"))
        if r == r:
            best = max(best, r)
        if best >= 300:
            break
    algo.stop()
    assert best >= 300, f"APPO failed to learn CartPole: best={best}"


@pytest.fixture(scope="module")
def jax_c51_start():
    """The JAX C51 gate's DQN parameters at seed 0
    (`module.init(PRNGKey(seed))`), as a numpy nest."""
    import jax

    from ray_tpu.rllib.algorithms.dqn import QModule as JaxQModule
    return jax.device_get(JaxQModule(
        4, 2, (64, 64), dueling=True, num_atoms=51, v_min=0.0,
        v_max=200.0).init(jax.random.PRNGKey(0)))


def test_c51_distributional_dqn_learning_gate(fresh_cluster,
                                              jax_c51_start):
    """Distributional C51 + dueling + double-Q + n-step + prioritized
    replay learns CartPole (reference rllib/algorithms/dqn rainbow
    components), from the JAX test's own start (ROADMAP queue 3, item
    21: the asserted rise holds for that start, and for 2 of 10 seeds
    in either package). Deterministic seed; noisy-net exploration has
    its own behavior test below (its extra target noise needs bigger
    budgets than a CI gate for a return gate)."""
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig
    from ray_tpu_torch.rllib.core.rl_module import from_jax_params
    cfg = DQNConfig().environment("CartPole-v1").training(
        num_atoms=51, v_min=0.0, v_max=200.0, dueling=True,
        n_step=3, learning_starts=300, num_envs_per_env_runner=8,
        num_updates_per_iteration=8, train_batch_size=64, seed=0,
        device="cpu")
    algo = cfg.build()
    start = from_jax_params(algo.module, jax_c51_start)
    algo.module.load_state_dict(start)
    algo.target.load_state_dict(start)
    try:
        rets = [algo.train()["episode_return_mean"] for _ in range(40)]
    finally:
        algo.stop()
    early = np.nanmean(rets[5:12])
    late = np.nanmean(rets[-6:])
    assert late > early + 8, (early, late)


@pytest.mark.slow        # ~30s exploration soak
def test_noisy_net_exploration_and_updates(fresh_cluster):
    """NoisyNet: factorized parameter noise IS the exploration —
    different noise samples give different greedy actions with no
    epsilon, the mu-only path is deterministic, and updates move the
    sigma parameters (reference rainbow noisy layers)."""
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, QModule
    from ray_tpu_torch.rllib.core.rl_module import to_numpy_params
    m = QModule(obs_dim=4, num_actions=2, hidden=(32,), noisy=True,
                num_atoms=51, v_min=0.0, v_max=200.0, dueling=True,
                generator=torch.Generator().manual_seed(0))
    params = to_numpy_params(m, m.state_dict())
    assert "w_sig" in params["adv"][0] and "w_sig" in params["val"][0]
    obs = np.random.default_rng(0).normal(size=(64, 4)).astype(
        np.float32)
    rng = np.random.default_rng(1)
    qs = [m.forward_np(params, obs, rng=rng) for _ in range(8)]
    # noise actually perturbs decisions across samples...
    acts = np.stack([q.argmax(-1) for q in qs])
    assert (acts != acts[0]).any(), "noise never changed a decision"
    # ...while the mu-only (eval) path is deterministic
    assert np.allclose(m.forward_np(params, obs),
                       m.forward_np(params, obs))

    # a full noisy C51 training step moves sigma parameters
    cfg = DQNConfig().environment("CartPole-v1").training(
        num_atoms=51, v_min=0.0, v_max=200.0, noisy=True, dueling=True,
        learning_starts=100, num_envs_per_env_runner=8,
        num_updates_per_iteration=4, train_batch_size=32, seed=0,
        device="cpu")
    algo = cfg.build()
    try:
        sig0 = algo.module.adv[0].w_sig.detach().clone().numpy()
        for _ in range(4):
            algo.train()
        sig1 = algo.module.adv[0].w_sig.detach().clone().numpy()
        assert not np.allclose(sig0, sig1), "sigma params never trained"
    finally:
        algo.stop()


@pytest.mark.slow        # ~32s learning gate (full default suite runs
                         # it; tier-1's 870s budget does not — see
                         # ROADMAP.md)
def test_dreamerv3_world_model_and_imagination_gate(fresh_cluster):
    """DreamerV3 on CartPole (reference rllib/algorithms/dreamerv3
    structure: RSSM + imagination-trained actor-critic). CI-scale gate:
    the world model converges (loss halves), imagined rollouts produce
    growing returns as the actor optimizes through the model, and the
    actor's entropy falls (it IS learning from imagination). Full real-
    return gates need training budgets beyond a unit test on this box
    (as in the reference's own smoke-scale dreamerv3 CI tests)."""
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3Config
    cfg = DreamerV3Config().environment("CartPole-v1").training(
        num_envs=8, rollout_length=32, num_updates_per_iteration=8,
        units=64, deter_dim=64, embed_dim=32,
        actor_lr=3e-3, critic_lr=1e-3, wm_lr=6e-4, ent_coef=1e-3,
        imag_starts=192, seed=0, device="cpu")
    algo = cfg.build()
    try:
        stats = [algo.train() for _ in range(12)]
        # checkpoint round-trip
        state = algo.get_state()
        algo.set_state(state)
        after = algo.train()
        assert after["training_iteration"] == 13
    finally:
        algo.stop()
    wm_first = stats[0]["wm_loss"]
    wm_last = np.mean([s["wm_loss"] for s in stats[-3:]])
    assert wm_last < 0.75 * wm_first, (wm_first, wm_last)
    assert np.mean([s["imag_return_mean"] for s in stats[-3:]]) > 2.0
    assert stats[-1]["actor_entropy"] < 0.65, stats[-1]["actor_entropy"]


# ------------------------------------------------ unified AlgorithmConfig
def test_unified_algorithm_config_surface():
    """Every algorithm config shares one builder base (reference
    algorithm_config.py): fluent groups, unknown-option rejection,
    copy/to_dict, algo_class-driven build."""
    from ray_tpu_torch.rllib import AlgorithmConfig
    from ray_tpu_torch.rllib.algorithms.appo import APPOConfig
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3Config
    from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig
    from ray_tpu_torch.rllib.offline import (BCConfig, CQLConfig,
                                             MARWILConfig)

    configs = [PPOConfig, DQNConfig, SACConfig, IMPALAConfig,
               APPOConfig, DreamerV3Config, BCConfig, MARWILConfig,
               CQLConfig]
    for C in configs:
        c = C()
        assert isinstance(c, AlgorithmConfig)
        out = c.environment("CartPole-v1").training(seed=3).debugging(
            seed=4)
        assert out is c and c.env == "CartPole-v1" and c.seed == 4
        dup = c.copy()
        dup.training(seed=9)
        assert c.seed == 4                  # deep copy
        assert dup.to_dict()["seed"] == 9
        with pytest.raises(ValueError, match="unknown"):
            c.training(definitely_not_an_option=1)
    # build() goes through algo_class uniformly
    algo = PPOConfig().environment("CartPole-v1").env_runners(
        num_envs_per_env_runner=2, rollout_length=8).training(
            device="cpu").build()
    try:
        assert type(algo).__name__ == "PPO"
    finally:
        algo.stop()


# ----------------------------------------------------- import hygiene
def test_gymnasium_only_in_the_env_seam():
    """Every import of gymnasium (or gym) in the port lies in
    `rllib/env/env_runner.py::make_env`, the branch that makes a
    gymnasium id's vector env: the chip machine has no gymnasium, and
    every runner and algorithm takes an env callable through that
    seam."""
    found = []
    root = os.path.join(REPO, "ray_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            for fn in [None] + [n for n in ast.walk(tree) if isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
                body = tree if fn is None else fn
                for node in ast.walk(body):
                    names = ([a.name for a in node.names]
                             if isinstance(node, ast.Import) else
                             [node.module or ""]
                             if isinstance(node, ast.ImportFrom) else [])
                    if any(n.split(".")[0] in ("gymnasium", "gym")
                           for n in names):
                        found.append((os.path.relpath(path, REPO),
                                      fn.name if fn else None,
                                      node.lineno))
    inner = {(p, ln) for p, fn, ln in found if fn is not None}
    where = {(p, fn) for p, fn, ln in found if fn is not None}
    assert where == {("ray_tpu_torch/rllib/env/env_runner.py",
                      "make_env")}, found
    # nothing at module level or in another function
    assert {(p, ln) for p, _, ln in found} == inner, found


# ------------------------------------------------------------- devices
def _learners():
    from ray_tpu_torch.rllib.algorithms import (APPOLearner, DQNConfig,
                                                DreamerV3Config,
                                                IMPALALearner,
                                                IMPALALearnerConfig,
                                                SACConfig)
    from ray_tpu_torch.rllib.algorithms.appo import APPOLearnerConfig
    from ray_tpu_torch.rllib.offline import BCConfig, CQLConfig, MARWILConfig
    from ray_tpu_torch.rllib.sebulba import SebulbaLearner, TorchPolicy
    small = dict(obs_dim=4, num_actions=2, hidden=(8,))
    return {
        "impala": lambda: IMPALALearner(IMPALALearnerConfig(**small)),
        "appo": lambda: APPOLearner(APPOLearnerConfig(**small)),
        "sebulba": lambda: SebulbaLearner(IMPALALearnerConfig(**small)),
        "dqn": lambda: DQNConfig().build(),
        "sac": lambda: SACConfig().build(),
        "dreamerv3": lambda: DreamerV3Config(num_envs=1).build(),
        "bc": lambda: BCConfig(input_path="rows").build(),
        "marwil": lambda: MARWILConfig(input_path="rows").build(),
        "cql": lambda: CQLConfig(input_path="rows").build(),
        "torch_policy": lambda: TorchPolicy(4, 2, (8,)),
    }


@pytest.mark.parametrize("name", sorted(_learners()))
def test_learners_refuse_a_missing_card(name):
    """A learner asked for the card (`device` None, the default) raises
    where there is none: the CPU runs only by name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _learners()[name]()
