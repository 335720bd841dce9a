"""The port's RL algorithms held to the JAX package on the CPU.

Inputs come from numpy seeds, JAX parameters are carried into the port
(`from_jax_params`), every random draw of an update is the JAX one (its
key split as the JAX code splits it, the normals or Gumbel noise read
from it and passed to the port), and both sides run in f32:
- `vtrace_returns`, off-policy with clipping and on-policy, where it is
  GAE with λ = 1 (atol 1e-5);
- IMPALA's and APPO's loss and gradients against the JAX learners' own
  `loss_fn` (read from their update's closure; rtol 1e-5, atol 1e-6),
  and whole updates (every metric within 1e-4 × (1 + |m|), every
  parameter within 1e-5), APPO's across its target refresh; IMPALA on 2
  gloo ranks, each with half the columns, against one learner (the JAX
  dp case's limits: metrics 1e-4 × (1 + |m|), parameters 1e-6);
- `QModule`'s Q-values and C51 logits in every mode (dueling or not,
  scalar or C51, noisy or not, the noisy heads fed the JAX draws) and
  its numpy forward with the same rng (atol 1e-5);
- the C51 target distribution against a plain per-atom projection in
  numpy, with atoms landing on the top atom (lo == hi), on the bottom
  one, on an inner atom and past v_max (atol 1e-6), and the per-sample
  cross-entropy and DQN TD errors against the JAX losses (atol 1e-5);
  whole DQN updates, scalar double-Q with importance weights and
  n-steps, and C51 + dueling + noisy (the parameter limits above);
- n-step rows of `QEnvRunner`, epsilon-greedy and noisy, from one env
  trace: bit-equal;
- SAC's squashed sample and log-prob (atol 1e-5), and one whole update
  (critic, actor, alpha, polyak; the limits above);
- DreamerV3's GRU step, `_kl`, symlog/symexp (atol 1e-6), one
  world-model loss with its stats, features and gradients from the JAX
  draws, and the behaviour losses on imagination from the JAX draws with
  their λ-returns and gradients (rtol 1e-4, atol 1e-5: 15 recurrent
  steps in f32);
- the BC, MARWIL (population std) and CQL (logsumexp) losses and one
  update each (the limits above);
- Sebulba's learner against the port's IMPALA learner on the same ring
  shards (bit-equal), both against the JAX IMPALA learner (the limits
  above);
- `chip_smoke.PendulumVec` against `gym.make_vec("Pendulum-v1")` over
  3,000 seeded steps with autoresets: bit-equal.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.core.rl_module import (from_jax_params,
                                                to_numpy_params)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import RankPool  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread, so this file's
    learners leave the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _jax_inner(obj, name):
    """A function of the JAX object's update, from its closure."""
    update = obj._build_update()
    return dict(zip(update.__code__.co_freevars,
                    update.__closure__))[name].cell_contents


def _close(got, want, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _metrics_close(m_port, m_jax):
    for k, v in m_jax.items():
        if k == "update_time_s":
            continue
        v = float(v)
        assert abs(float(m_port[k]) - v) < 1e-4 * (1 + abs(v)), (
            k, v, m_port[k])


def _params_close(module, state_dict, jax_params, atol=1e-5, skip=()):
    want = from_jax_params(module, jax.device_get(jax_params))
    for k in want:
        if k.startswith(skip):
            continue
        np.testing.assert_allclose(state_dict[k].detach().cpu().numpy(),
                                   want[k].numpy(), atol=atol, err_msg=k)


def _grads_close(module, grads: dict, jax_grads, rtol=1e-5, atol=1e-6):
    """Port gradients by state-dict name against the JAX gradient nest,
    laid out as the module's parameters."""
    want = from_jax_params(module, jax.device_get(jax_grads))
    for k, g in grads.items():
        if k in want:
            _close(g.detach().numpy(), want[k].numpy(), rtol, atol, k)


# --------------------------------------------------------------- vtrace
def _time_major(seed=0, T=12, N=6, D=4, A=3):
    """A time-major batch with terminations, truncations, masked filler
    steps and off-policy behaviour log-probs."""
    rng = np.random.default_rng(seed)
    terms = (rng.random((T, N)) < 0.06).astype(np.float32)
    dones = np.maximum(terms, (rng.random((T, N)) < 0.08)
                       .astype(np.float32))
    mask = np.ones((T, N), np.float32)
    mask[1:] = 1.0 - dones[:-1]
    mask[:, 0] = 1.0 - (rng.random(T) < 0.4)   # columns' masks differ
    return {
        "obs": rng.normal(size=(T + 1, N, D)).astype(np.float32),
        "actions": rng.integers(0, A, (T, N)).astype(np.int32),
        "logp": (np.log(np.full((T, N), 1.0 / A, np.float32))
                 + 0.3 * rng.normal(size=(T, N)).astype(np.float32)),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "terminateds": terms,
        "dones": dones,
        "mask": mask,
    }


@pytest.mark.parametrize("on_policy,clips", [(False, (1.0, 1.0)),
                                             (False, (0.8, 0.9)),
                                             (True, (1.0, 1.0))])
def test_vtrace_returns_match_the_jax_package(on_policy, clips):
    from ray_tpu.rllib.algorithms.impala import vtrace_returns as jax_vtrace
    from ray_tpu_torch.rllib.algorithms import vtrace_returns
    b = _time_major(seed=1)
    rng = np.random.default_rng(2)
    T, N = b["rewards"].shape
    values = rng.normal(size=(T + 1, N)).astype(np.float32)
    target = b["logp"] if on_policy else (
        b["logp"] + 0.5 * rng.normal(size=(T, N)).astype(np.float32))
    args = (values, b["rewards"], b["terminateds"], b["dones"], b["logp"],
            target)
    want = jax_vtrace(*map(jnp.asarray, args), 0.99, *clips)
    got = vtrace_returns(*map(t, args), 0.99, *clips)
    for g, w, name in zip(got, want, ("vs", "pg_adv", "rho")):
        _close(g.numpy(), w, 0, 1e-5, name)
    if on_policy:       # GAE with λ = 1: vs = values + advantages
        delta = (b["rewards"] + 0.99 * (1 - b["terminateds"]) * values[1:]
                 - values[:-1])
        adv = np.zeros((T + 1, N), np.float32)
        for i in range(T - 1, -1, -1):
            adv[i] = delta[i] + 0.99 * (1 - b["dones"][i]) * adv[i + 1]
        _close(got[0].numpy(), values[:-1] + adv[:-1], 0, 1e-5, "gae")


# -------------------------------------------------------- IMPALA, APPO
LEARNER = dict(obs_dim=4, num_actions=3, hidden=(8,), seed=3)


def _impala_pair(appo=False, **kw):
    if appo:
        from ray_tpu.rllib.algorithms.appo import APPOLearner as JL
        from ray_tpu.rllib.algorithms.appo import APPOLearnerConfig as JC
        from ray_tpu_torch.rllib.algorithms.appo import APPOLearner as TL
        from ray_tpu_torch.rllib.algorithms.appo import \
            APPOLearnerConfig as TC
    else:
        from ray_tpu.rllib.algorithms.impala import IMPALALearner as JL
        from ray_tpu.rllib.algorithms.impala import \
            IMPALALearnerConfig as JC
        from ray_tpu_torch.rllib.algorithms.impala import \
            IMPALALearner as TL
        from ray_tpu_torch.rllib.algorithms.impala import \
            IMPALALearnerConfig as TC
    jl = JL(JC(**{**LEARNER, **kw}))
    tl = TL(TC(**{**LEARNER, **kw}, device="cpu"))
    tl.set_weights(from_jax_params(tl.module, jax.device_get(jl.params)))
    if appo:
        tl.target.load_state_dict(from_jax_params(
            tl.module, jax.device_get(jl.target_params)))
    return jl, tl


@pytest.mark.parametrize("appo", [False, True])
def test_loss_and_gradients_match_the_jax_learner(appo):
    jl, tl = _impala_pair(appo)
    b = _time_major(seed=4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    loss_fn = _jax_inner(jl, "loss_fn")
    params = list(tl.module.parameters())
    tb = {k: t(v) for k, v in b.items()}
    denom = tb["mask"].sum().clamp_min(1.0)
    if appo:
        # a target network apart from the online one: the KL is not 0
        target = jax.tree_util.tree_map(
            lambda x: x + 0.5 * np.sin(np.arange(x.size)).reshape(x.shape),
            jl.params)
        tl.target.load_state_dict(from_jax_params(
            tl.module, jax.device_get(target)))
        (j_total, j_m), j_g = jax.value_and_grad(loss_fn, has_aux=True)(
            jl.params, target, jb)
    else:
        (j_total, j_m), j_g = jax.value_and_grad(loss_fn, has_aux=True)(
            jl.params, jb)
    total, metrics = tl._loss(tb, denom)
    grads = torch.autograd.grad(total, params)
    _close(float(total.detach()), float(j_total), 1e-5, 1e-6, "total")
    for name, v in zip(tl.METRICS, metrics.tolist()):
        _close(v, float(j_m[name]), 1e-5, 1e-6, name)
    if appo:
        assert float(j_m["kl_to_target"]) > 1e-4
    _grads_close(tl.module, dict(zip(
        [n for n, _ in tl.module.named_parameters()], grads)), j_g)


@pytest.mark.parametrize("appo", [False, True])
def test_updates_match_the_jax_learner(appo):
    """Three updates; APPO's target refreshes after the second."""
    kw = dict(target_network_update_freq=2) if appo else {}
    jl, tl = _impala_pair(appo, **kw)
    for i in range(3):
        b = _time_major(seed=10 + i)
        _metrics_close(tl.update(b), jl.update(b))
        _params_close(tl.module, tl.module.state_dict(), jl.params)
    assert tl.version == jl.version == 3
    if appo:
        _params_close(tl.module, tl.target.state_dict(), jl.target_params)


def _dp_impala_update(cfg, batches):
    from ray_tpu_torch.rllib.algorithms.impala import (IMPALALearner,
                                                       IMPALALearnerConfig)
    learner = IMPALALearner(IMPALALearnerConfig(**cfg, num_devices=2))
    ms = [learner.update(b) for b in batches]
    return ms, {k: v.numpy() for k, v in learner.get_weights().items()}


def test_impala_on_two_gloo_ranks_matches_one_learner(pool):
    from ray_tpu_torch.rllib.algorithms.impala import (IMPALALearner,
                                                       IMPALALearnerConfig)
    cfg = dict(LEARNER, device="cpu")
    single = IMPALALearner(IMPALALearnerConfig(**cfg))
    batches = [_time_major(seed=20 + i) for i in range(2)]
    # the two ranks' column halves hold different mask counts: an
    # average of their gradients would weigh their steps unequally
    halves = batches[0]["mask"].reshape(12, 2, 3).sum((0, 2))
    assert halves[0] != halves[1]
    m1 = [single.update(b) for b in batches]
    (m2, w2), _ = pool.run(2, _dp_impala_update, cfg, batches)
    for a, b in zip(m1, m2):
        for k in a:
            if k != "update_time_s":
                assert abs(a[k] - b[k]) < 1e-4 * (1 + abs(a[k])), k
    for k, v in single.get_weights().items():
        np.testing.assert_allclose(v.numpy(), w2[k], atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ DQN
def _jax_layer_noise(key, din, dout):
    k_in, k_out = jax.random.split(key)
    return (t(jax.random.normal(k_in, (din,))),
            t(jax.random.normal(k_out, (dout,))))


def _jax_head_noise(jm, key):
    """The raw normals the JAX `_head_out` draws from `key`, in the
    port's noise layout (None for a module without noisy heads)."""
    if not jm.noisy or key is None:
        return None
    din = jm.hidden[-1]
    A, K = jm.num_actions, jm.num_atoms
    if jm.dueling:
        ka, kv = jax.random.split(key)
        return {"adv": _jax_layer_noise(ka, din, A * K),
                "val": _jax_layer_noise(kv, din, K)}
    return {"q": _jax_layer_noise(key, din, A * K)}


QMODES = [dict(dueling=d, num_atoms=k, noisy=n)
          for d in (False, True) for k in (1, 11) for n in (False, True)]


@pytest.mark.parametrize("mode", QMODES, ids=lambda m: "-".join(
    f"{k}{int(v)}" for k, v in m.items()))
def test_qmodule_forward_matches_the_jax_package(mode):
    from ray_tpu.rllib.algorithms.dqn import QModule as JaxQModule
    from ray_tpu_torch.rllib.algorithms.dqn import QModule
    kw = dict(mode, v_min=-5.0, v_max=5.0)
    jm = JaxQModule(4, 3, (16, 16), **kw)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(5)))
    tm = QModule(4, 3, (16, 16), **kw)
    tm.load_state_dict(from_jax_params(tm, jp))
    obs = np.random.default_rng(6).normal(size=(7, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7) if mode["noisy"] else None
    noise = _jax_head_noise(jm, key)
    with torch.no_grad():
        _close(tm(t(obs), noise).numpy(), jm.forward(jp, obs, key), 0,
               1e-5, "q")
        if mode["num_atoms"] > 1:
            _close(tm.forward_dist(t(obs), noise).numpy(),
                   jm.forward_dist(jp, obs, key), 0, 1e-5, "dist")
    # the numpy forward on the port's nest, with the same rng draws
    np_port = to_numpy_params(tm, tm.state_dict())
    for rng_seed in (None, 8):
        rngs = [None if rng_seed is None else np.random.default_rng(rng_seed)
                for _ in range(2)]
        _close(tm.forward_np(np_port, obs, rngs[0]),
               jm.forward_np(jp, obs, rngs[1]), 0, 1e-5, "numpy")


def _projection(p_a, rewards, g_eff, terms, v_min, v_max, K):
    """C51's categorical projection, atom by atom."""
    z = np.linspace(v_min, v_max, K)
    dz = (v_max - v_min) / (K - 1)
    m = np.zeros_like(p_a, dtype=np.float64)
    for i in range(len(p_a)):
        for j in range(K):
            tz = np.clip(rewards[i] + g_eff[i] * (1 - terms[i]) * z[j],
                         v_min, v_max)
            bj = (tz - v_min) / dz
            lo, hi = int(np.floor(bj)), int(np.ceil(bj))
            if lo == hi:
                m[i, lo] += p_a[i, j]
            else:
                m[i, lo] += p_a[i, j] * (hi - bj)
                m[i, hi] += p_a[i, j] * (bj - lo)
    return m


def _dqn_batch(seed, B=32, c51=False):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.normal(size=(B, 4)).astype(np.float32),
         "actions": rng.integers(0, 2, B).astype(np.int32),
         "rewards": rng.normal(size=B).astype(np.float32),
         "new_obs": rng.normal(size=(B, 4)).astype(np.float32),
         "terminateds": (rng.random(B) < 0.2).astype(np.float32),
         "nsteps": rng.integers(1, 4, B).astype(np.float32),
         "weights": rng.uniform(0.2, 1.0, B).astype(np.float32)}
    if c51:
        # terminal rows whose targets land on the top atom (lo == hi),
        # past v_max, on the bottom atom and on an inner atom (dz = 20)
        b["terminateds"][:4] = 1.0
        b["rewards"][:4] = [200.0, 250.0, 0.0, 40.0]
        b["rewards"][4:] = np.abs(b["rewards"][4:]) * 30.0
    return b


def _dqn_pair(**kw):
    from ray_tpu.rllib.algorithms.dqn import DQN as JaxDQN
    from ray_tpu.rllib.algorithms.dqn import DQNConfig as JaxDQNConfig
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig
    cfg = dict(hidden=(16,), num_envs_per_env_runner=1, seed=2, **kw)
    jd = JaxDQN(JaxDQNConfig(**cfg))
    td = DQNConfig(**cfg, device="cpu").build()
    target = jax.tree_util.tree_map(lambda x: x * 0.9, jd.params)
    jd.target_params = target
    td.module.load_state_dict(from_jax_params(td.module,
                                              jax.device_get(jd.params)))
    td.target.load_state_dict(from_jax_params(td.module,
                                              jax.device_get(target)))
    return jd, td


DQN_MODES = [dict(double_q=True), dict(double_q=False),
             dict(num_atoms=11, v_min=0.0, v_max=200.0, dueling=True,
                  noisy=True)]


@pytest.mark.parametrize("mode", DQN_MODES, ids=("double", "max", "c51"))
def test_dqn_loss_and_update_match_the_jax_package(mode):
    jd, td = _dqn_pair(**mode)
    c51 = mode.get("num_atoms", 1) > 1
    b = _dqn_batch(9, c51=c51)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    key = jax.random.PRNGKey(11)
    noise = tuple(_jax_head_noise(jd.module, k)
                  for k in jax.random.split(key, 3))
    loss_fn = _jax_inner(jd, "loss_fn")
    j_loss, j_td = loss_fn(jd.params, jd.target_params, jb, key)
    tb = {k: t(v) for k, v in b.items()}
    if c51:
        loss, td_err = td._loss_c51(tb, noise)
        # the projected target against the per-atom projection, on the
        # JAX target distribution of the chosen action
        with torch.no_grad():
            m = td._c51_target(tb, noise).numpy()
        t_logits = jd.module.forward_dist(jd.target_params, jb["new_obs"],
                                          jax.random.split(key, 3)[1])
        p_next = np.asarray(jax.nn.softmax(t_logits, axis=-1))
        a_star = np.asarray(jnp.argmax(jd.module.forward(
            jd.params, jb["new_obs"], jax.random.split(key, 3)[2]), -1))
        want = _projection(p_next[np.arange(len(a_star)), a_star],
                           b["rewards"], 0.99 ** b["nsteps"],
                           b["terminateds"], 0.0, 200.0, 11)
        _close(m, want, 0, 1e-6, "projection")
        np.testing.assert_allclose(m.sum(-1), 1.0, atol=1e-6)
        assert m[0, -1] == pytest.approx(1.0, abs=1e-6)   # lo == hi
        assert m[2, 0] == pytest.approx(1.0, abs=1e-6)
    else:
        loss, td_err = td._loss_scalar(tb, noise)
    _close(float(loss), float(j_loss), 1e-5, 1e-6, "loss")
    _close(td_err.numpy(), j_td, 0, 1e-5, "per-sample")
    # one whole update each, from the same key
    jd.params, jd.opt_state, j_loss2, _ = jd._update_fn(
        jd.params, jd.target_params, jd.opt_state, jb, key)
    loss2, _ = td._update(b, noise)
    _close(float(loss2), float(j_loss2), 1e-5, 1e-6, "update loss")
    _params_close(td.module, td.module.state_dict(), jd.params)
    jd.stop()
    td.stop()


@pytest.mark.parametrize("noisy", [False, True])
def test_nstep_rows_are_bit_equal(noisy):
    from ray_tpu.rllib.algorithms.dqn import DQNConfig as JaxDQNConfig
    from ray_tpu.rllib.algorithms.dqn import QEnvRunner as JaxRunner
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, QEnvRunner
    cfg = dict(n_step=3, num_envs_per_env_runner=4, seed=4, hidden=(16,),
               noisy=noisy, dueling=noisy, epsilon_timesteps=200)
    jr = JaxRunner(JaxDQNConfig(**cfg))
    tr = QEnvRunner(DQNConfig(**cfg))
    tr.set_weights(from_jax_params(tr.module, jr.params))
    for _ in range(2):
        jb, tb = jr.sample(40), tr.sample(40)
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    np.testing.assert_equal(tr.get_metrics(), jr.get_metrics())
    jr.stop()
    tr.stop()


# ------------------------------------------------------------------ SAC
def _sac_pair():
    from ray_tpu.rllib.algorithms.sac import SAC as JaxSAC
    from ray_tpu.rllib.algorithms.sac import SACConfig as JaxSACConfig
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig
    cfg = dict(hidden=(16, 16), num_envs_per_env_runner=1, seed=1)
    js = JaxSAC(JaxSACConfig(**cfg))
    ts = SACConfig(**cfg, device="cpu").build()
    ts.module.load_state_dict(from_jax_params(ts.module,
                                              jax.device_get(js.params)))
    # target critics apart from the online ones
    js.target_q = jax.tree_util.tree_map(lambda x: x * 0.9, js.target_q)
    ts.target.load_state_dict(from_jax_params(ts.module, jax.device_get(
        {"pi": js.params["pi"], **js.target_q})))
    return js, ts


def test_sac_squashed_sample_matches_the_jax_package():
    js, ts = _sac_pair()
    obs = np.random.default_rng(3).normal(size=(9, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ja, jlogp = js.module.sample_action(js.params, obs, key)
    noise = t(jax.random.normal(key, (9, 1)))
    with torch.no_grad():
        a, logp = ts.module.sample_action(t(obs), noise)
    _close(a.numpy(), ja, 0, 1e-5, "action")
    _close(logp.numpy(), jlogp, 0, 1e-5, "logp")
    js.stop()
    ts.stop()


def test_sac_update_matches_the_jax_package():
    """Two updates: the critic, actor and alpha steps and the polyak
    target update, from the JAX keys' draws."""
    js, ts = _sac_pair()
    rng = np.random.default_rng(5)
    B = 32
    opts = (js._actor_opt, js._critic_opt, js._alpha_opt)
    for i in range(2):
        b = {"obs": rng.normal(size=(B, 3)).astype(np.float32),
             "actions": rng.uniform(-1, 1, (B, 1)).astype(np.float32),
             "rewards": rng.normal(size=B).astype(np.float32),
             "new_obs": rng.normal(size=(B, 3)).astype(np.float32),
             "terminateds": (rng.random(B) < 0.2).astype(np.float32)}
        key = jax.random.PRNGKey(20 + i)
        k1, k2 = jax.random.split(key)
        noise = torch.stack([t(jax.random.normal(k, (B, 1)))
                             for k in (k1, k2)])
        (js.params, js.target_q, js.log_alpha, opts, j_m) = js._update_fn(
            js.params, js.target_q, js.log_alpha, opts,
            {k: jnp.asarray(v) for k, v in b.items()}, key)
        from ray_tpu_torch.rllib.algorithms.sac import METRICS
        _metrics_close(dict(zip(METRICS, ts._update(b, noise).tolist())),
                       j_m)
        _params_close(ts.module, ts.module.state_dict(), js.params)
        # the target's critics (its policy is never read)
        _params_close(ts.module, ts.target.state_dict(),
                      {"pi": js.params["pi"], **js.target_q},
                      skip=("pi.",))
        _close(float(ts.log_alpha.detach()), float(js.log_alpha), 0, 1e-6)
    js.stop()
    ts.stop()


# ------------------------------------------------------------ DreamerV3
DREAMER = dict(num_envs=2, rollout_length=6, deter_dim=16,
               n_categoricals=4, n_classes=4, embed_dim=8, units=16,
               horizon=5, imag_starts=7, seed=0)


@pytest.fixture(scope="module")
def dreamer_pair():
    from ray_tpu.rllib.algorithms.dreamerv3 import DreamerV3 as JaxDreamer
    from ray_tpu.rllib.algorithms.dreamerv3 import \
        DreamerV3Config as JaxDreamerConfig
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3Config
    jd = JaxDreamer(JaxDreamerConfig(**DREAMER))
    td = DreamerV3Config(**DREAMER, device="cpu").build()
    td.model.load_state_dict(from_jax_params(td.model, jax.device_get(
        {"wm": jd.wm, "actor": jd.actor, "critic": jd.critic})))
    yield jd, td
    jd.stop()
    td.stop()


def _dreamer_grads(td, params, grads):
    names = {id(p): n for n, p in td.model.named_parameters()}
    return {names[id(p)]: g for p, g in zip(params, grads)}


def test_dreamer_pieces_match_the_jax_package(dreamer_pair):
    from ray_tpu.rllib.algorithms import dreamerv3 as jdm
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as tdm
    jd, td = dreamer_pair
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 7)).astype(np.float32) * 4
    _close(tdm.symlog(t(x)).numpy(), jdm.symlog(x), 0, 1e-6, "symlog")
    _close(tdm.symexp(t(x)).numpy(), jdm.symexp(x), 0, 1e-4, "symexp")
    _close(tdm.symexp(tdm.symlog(t(x))).numpy(), x, 0, 1e-4, "inverse")
    # the GRU step: gates in r, z, n order
    h = rng.normal(size=(3, 16)).astype(np.float32)
    inp = rng.normal(size=(3, 16 + 2)).astype(np.float32)
    with torch.no_grad():
        _close(td.wm.gru(t(h), t(inp)).numpy(),
               jdm._gru(jd.wm["gru"], h, inp), 0, 1e-6, "gru")
    # _kl on unimixed log-probs
    lhs = np.log(jax.nn.softmax(rng.normal(size=(3, 4, 4)), -1))
    rhs = np.log(jax.nn.softmax(rng.normal(size=(3, 4, 4)), -1))
    _close(td._kl(t(lhs), t(rhs)).numpy(), jd._kl(lhs, rhs), 0, 1e-6, "kl")
    # the straight-through sample is JAX's categorical draw
    logits = rng.normal(size=(3, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jz, jlg = jd._sample_z(logits, key)
    tz, tlg = td._sample_z(t(logits), t(jax.random.gumbel(key, (3, 4, 4))))
    _close(tz.detach().numpy(), jz, 0, 1e-6, "z")
    _close(tlg.detach().numpy(), jlg, 0, 1e-6, "unimix")


def _dreamer_batch(seed, T=6, N=2, D=4, A=2):
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    mask = np.ones((T, N), np.float32)
    mask[1:] = 1.0 - dones[:-1]
    return {"obs": rng.normal(size=(T + 1, N, D)).astype(np.float32),
            "actions": rng.integers(0, A, (T, N)).astype(np.int32),
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "terminateds": dones * (rng.random((T, N)) < 0.5),
            "dones": dones, "mask": mask}


def test_dreamer_world_model_loss_matches_the_jax_package(dreamer_pair):
    jd, td = dreamer_pair
    b = _dreamer_batch(2)
    T, N = b["actions"].shape
    key = jax.random.PRNGKey(5)
    wm_loss = _jax_inner(jd, "wm_loss")
    (j_loss, (j_feat, j_stats)), j_g = jax.jit(jax.value_and_grad(
        wm_loss, has_aux=True))(jd.wm, {k: jnp.asarray(v)
                                       for k, v in b.items()}, key)
    noise = torch.stack([t(jax.random.gumbel(k, (N, 4, 4)))
                         for k in jax.random.split(key, T)])
    loss, feat, stats = td._wm_loss({k: t(v) for k, v in b.items()}, noise)
    _close(float(loss), float(j_loss), 1e-5, 1e-6, "wm_loss")
    _close(feat.detach().numpy(), j_feat, 1e-4, 1e-5, "features")
    for k, v in stats.items():
        _close(float(v), float(j_stats[k]), 1e-5, 1e-6, k)
    params = list(td.wm.parameters())
    grads = torch.autograd.grad(loss, params)
    _grads_close(td.model, _dreamer_grads(td, params, grads),
                 {"wm": j_g, "actor": jd.actor, "critic": jd.critic},
                 rtol=1e-4, atol=1e-5)


def test_dreamer_behaviour_losses_match_the_jax_package(dreamer_pair):
    jd, td = dreamer_pair
    rng = np.random.default_rng(6)
    B, H = 7, DREAMER["horizon"]
    start = rng.normal(size=(B, 16 + 16)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    behavior = _jax_inner(jd, "behavior_losses")

    def jax_total(ac):
        a_loss, v_loss, scale, stats = behavior(
            jd.wm, ac[0], ac[1], jnp.asarray(start), 1.3, key)
        return a_loss + v_loss, (a_loss, v_loss, scale, stats)
    (_, (ja, jv, jscale, jstats)), (jga, jgc) = jax.jit(jax.value_and_grad(
        jax_total, has_aux=True))((jd.actor, jd.critic))
    act, zn = [], []
    for k in jax.random.split(key, H):
        ka, kz = jax.random.split(k)
        act.append(t(jax.random.gumbel(ka, (B, 2))))
        zn.append(t(jax.random.gumbel(kz, (B, 4, 4))))
    a_loss, v_loss, scale, stats = td._behavior_losses(
        t(start), torch.tensor(1.3), torch.stack(act), torch.stack(zn))
    _close(float(a_loss), float(ja), 1e-4, 1e-5, "actor_loss")
    _close(float(v_loss), float(jv), 1e-4, 1e-5, "critic_loss")
    _close(float(scale), float(jscale), 1e-4, 1e-5, "ret_scale")
    for k, v in stats.items():
        _close(float(v), float(jstats[k]), 1e-4, 1e-5, k)
    params = list(td.actor.parameters()) + list(td.critic.parameters())
    grads = torch.autograd.grad(a_loss + v_loss, params)
    _grads_close(td.model, _dreamer_grads(td, params, grads),
                 {"wm": jd.wm, "actor": jga, "critic": jgc},
                 rtol=1e-4, atol=1e-5)
    # the λ-returns against the JAX scan on the same values
    rew, disc, v = (rng.normal(size=(H, B)).astype(np.float32)
                    for _ in range(3))
    lam = DREAMER.get("gae_lambda", 0.95)

    def lam_step(carry, inp):
        r_t, d_t, v_t = inp
        ret = r_t + d_t * ((1 - lam) * v_t + lam * carry)
        return ret, ret
    _, want = jax.lax.scan(lam_step, v[-1], (rew[:-1], disc[:-1], v[1:]),
                           reverse=True)
    _close(td._lambda_returns(t(rew), t(disc), t(v)).numpy(), want, 0,
           1e-5, "lambda returns")


# ---------------------------------------------------------------- offline
@pytest.fixture(scope="module")
def offline_path(tmp_path_factory):
    from ray_tpu_torch.rllib.offline import record_transitions
    rng = np.random.default_rng(0)
    return record_transitions(
        "CartPole-v1", lambda obs: rng.integers(0, 2, len(obs)),
        str(tmp_path_factory.mktemp("offline") / "rows"), num_steps=300,
        num_envs=4, seed=0)


def _offline_batch(seed, B=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 4)).astype(np.float32),
            rng.integers(0, 2, B).astype(np.int32),
            (rng.normal(size=B) * 5).astype(np.float32),
            rng.normal(size=(B, 4)).astype(np.float32),
            (rng.random(B) < 0.2).astype(np.float32))


def test_bc_and_marwil_match_the_jax_package(offline_path):
    from ray_tpu.rllib import offline as jo
    from ray_tpu_torch.rllib import offline as to
    obs, actions, rtg, _, _ = _offline_batch(1)
    for J, T, Cj, Ct in ((jo.BC, to.BC, jo.BCConfig, to.BCConfig),
                         (jo.MARWIL, to.MARWIL, jo.MARWILConfig,
                          to.MARWILConfig)):
        ja = J(Cj(input_path=offline_path, hidden=(16,)))
        ta = T(Ct(input_path=offline_path, hidden=(16,), device="cpu"))
        ta.module.load_state_dict(from_jax_params(
            ta.module, jax.device_get(ja.params)))
        if J is jo.BC:
            ja.params, ja.opt_state, j_loss = ja._update_fn(
                ja.params, ja.opt_state, jnp.asarray(obs),
                jnp.asarray(actions))
            _close(float(ta._update(obs, actions)), float(j_loss), 1e-5,
                   1e-6, "bc loss")
        else:
            # a 16-row batch: the sample std is 3% above jnp.std's
            # population std, far outside the limits
            assert np.std(rtg, ddof=1) / np.std(rtg) > 1.03
            out = ja._update_fn(ja.params, ja.opt_state, jnp.asarray(obs),
                                jnp.asarray(actions), jnp.asarray(rtg))
            ja.params, ja.opt_state = out[:2]
            got = ta._update(obs, actions, rtg).tolist()
            for g, w, name in zip(got, out[2:], ("loss", "pi", "vf")):
                _close(g, float(w), 1e-5, 1e-6, name)
        _params_close(ta.module, ta.module.state_dict(), ja.params)


def test_cql_matches_the_jax_package(offline_path):
    from ray_tpu.rllib import offline as jo
    from ray_tpu_torch.rllib import offline as to
    ja = jo.CQL(jo.CQLConfig(input_path=offline_path, hidden=(16,)))
    ta = to.CQL(to.CQLConfig(input_path=offline_path, hidden=(16,),
                             device="cpu"))
    ja.target_params = jax.tree_util.tree_map(lambda x: x * 0.9,
                                              ja.params)
    ta.module.load_state_dict(from_jax_params(ta.module,
                                              jax.device_get(ja.params)))
    ta.target.load_state_dict(from_jax_params(
        ta.module, jax.device_get(ja.target_params)))
    batch = _offline_batch(2)
    out = ja._update_fn(ja.params, ja.target_params, ja.opt_state,
                        *map(jnp.asarray, batch))
    got = ta._update(*batch).tolist()
    for g, w, name in zip(got, out[2:], ("loss", "td", "cql")):
        _close(g, float(w), 1e-5, 1e-6, name)
    _params_close(ta.module, ta.module.state_dict(), out[0])


# --------------------------------------------------------------- Sebulba
def test_sebulba_learner_matches_impala_on_the_same_shards():
    from ray_tpu.rllib.algorithms.impala import IMPALALearner as JL
    from ray_tpu.rllib.algorithms.impala import IMPALALearnerConfig as JC
    from ray_tpu_torch.rllib.algorithms.impala import (IMPALALearner,
                                                       IMPALALearnerConfig)
    from ray_tpu_torch.rllib.sebulba import (InferenceActor,
                                             SebulbaEnvRunner,
                                             SebulbaLearner,
                                             SebulbaRunnerConfig)
    cfg = dict(obs_dim=4, num_actions=2, hidden=(16,), seed=7)
    jl = JL(JC(**cfg))
    start = from_jax_params(IMPALALearner(IMPALALearnerConfig(
        **cfg, device="cpu")).module, jax.device_get(jl.params))
    ref = IMPALALearner(IMPALALearnerConfig(**cfg, device="cpu"))
    seb = SebulbaLearner(IMPALALearnerConfig(**cfg, device="cpu"))
    ref.set_weights(start)
    seb.set_weights(start)
    srv = InferenceActor(4, 2, (16,), seed=0)
    runner = SebulbaEnvRunner(SebulbaRunnerConfig(
        num_envs=4, rollout_length=8, ring_depth=2, seed=0), 0, [srv])
    try:
        for _ in range(3):
            shard = runner.collect_shard()
            srv.set_weights(seb.get_weights(), seb.version)
            m_seb = seb.update_shard(shard)
            m_ref = ref.update({k: shard[k] for k in (
                "obs", "actions", "logp", "rewards", "terminateds",
                "dones", "mask")})
            m_jax = jl.update({k: shard[k] for k in (
                "obs", "actions", "logp", "rewards", "terminateds",
                "dones", "mask")})
            for k, v in ref.params.items():
                assert torch.equal(v, seb.params[k]), k
            assert m_seb["policy_loss"] == m_ref["policy_loss"]
            _metrics_close(m_ref, m_jax)
            _params_close(ref.module, ref.module.state_dict(), jl.params)
        assert seb.seq_gaps == 0 and seb.shards_consumed == 3
    finally:
        runner.stop()
        srv.close()


# ----------------------------------------------------------- the envs
def test_numpy_pendulum_matches_gymnasium():
    import gymnasium as gym

    import chip_smoke
    n = 8
    ref = gym.make_vec("Pendulum-v1", n, vectorization_mode="sync")
    env = chip_smoke.PendulumVec(n)
    o_ref, _ = ref.reset(seed=5)
    o_env, _ = env.reset(seed=5)
    np.testing.assert_array_equal(o_env, o_ref)
    rng = np.random.default_rng(1)
    truncs = 0
    for _ in range(3000):
        a = rng.uniform(-3.0, 3.0, (n, 1)).astype(np.float32)
        o_ref, r_ref, te_ref, tr_ref, _ = ref.step(a)
        o_env, r_env, te_env, tr_env, _ = env.step(a)
        np.testing.assert_array_equal(o_env, o_ref)
        assert o_env.dtype == o_ref.dtype and r_env.dtype == r_ref.dtype
        np.testing.assert_array_equal(r_env, r_ref)
        np.testing.assert_array_equal(te_env, te_ref)
        np.testing.assert_array_equal(tr_env, tr_ref)
        truncs += int(tr_ref.sum())
    assert truncs > 100
    ref.close()
