"""The port's Tune, held to `tests/test_tune.py` case for case.

The same searcher, scheduler and controller cases, with the same
asserts and `slow` marks, on `ray_tpu_torch.tune`. The tiny-transformer
ASHA sweep trains the port's `Transformer` with torch Adam on the CPU in
place of optax, and the distributed-trials case tunes a 2-worker
`TorchTrainer` in place of a `JaxTrainer`. The runtime fixtures are this
file's own and shut the port's runtime down at the module's end.
"""
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import CheckpointConfig, RunConfig
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP
from ray_tpu_torch.tune.tuner import ERROR, STOPPED, TERMINATED, TuneConfig


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


# ------------------------------------------------------------- search
def test_grid_search_cross_product():
    gen = tune.BasicVariantGenerator()
    cfgs = list(gen.variants({"a": tune.grid_search([1, 2, 3]),
                              "b": tune.grid_search(["x", "y"]),
                              "c": 42}))
    assert len(cfgs) == 6
    assert all(c["c"] == 42 for c in cfgs)
    assert {(c["a"], c["b"]) for c in cfgs} == {
        (a, b) for a in (1, 2, 3) for b in ("x", "y")}


def test_stochastic_domains_and_num_samples():
    gen = tune.BasicVariantGenerator(seed=7)
    cfgs = list(gen.variants({"lr": tune.loguniform(1e-5, 1e-1),
                              "h": tune.choice([32, 64]),
                              "n": tune.randint(0, 10),
                              "u": tune.uniform(-1, 1)}, num_samples=20))
    assert len(cfgs) == 20
    assert all(1e-5 <= c["lr"] <= 1e-1 for c in cfgs)
    assert {c["h"] for c in cfgs} <= {32, 64}
    assert len({c["lr"] for c in cfgs}) > 10       # actually sampling
    # deterministic under the same seed
    again = list(tune.BasicVariantGenerator(seed=7).variants(
        {"lr": tune.loguniform(1e-5, 1e-1), "h": tune.choice([32, 64]),
         "n": tune.randint(0, 10), "u": tune.uniform(-1, 1)},
        num_samples=20))
    assert [c["lr"] for c in again] == [c["lr"] for c in cfgs]


# ---------------------------------------------------------- scheduler
def test_asha_stops_bottom_of_rung():
    sched = tune.ASHAScheduler(metric="acc", mode="max", max_t=100,
                               grace_period=2, reduction_factor=4)
    # 8 trials reach rung t=2 in DESCENDING quality: later reporters
    # fall below the rung's top-1/rf cutoff and must stop.
    decisions = {}
    for i in range(8):
        decisions[i] = sched.on_result(f"t{i}", 2, {"acc": float(7 - i)})
    assert decisions[0] == CONTINUE          # too early to judge
    assert all(decisions[i] == STOP for i in range(3, 8)), decisions
    # a later strong arrival at the same rung continues
    assert sched.on_result("t9", 2, {"acc": 100.0}) == CONTINUE


def test_asha_max_t_budget():
    sched = tune.ASHAScheduler(metric="acc", mode="max", max_t=5,
                               grace_period=1)
    assert sched.on_result("t", 5, {"acc": 1.0}) == STOP


def test_asha_min_mode():
    sched = tune.ASHAScheduler(metric="loss", mode="min", max_t=100,
                               grace_period=1, reduction_factor=2)
    sched.on_result("a", 1, {"loss": 0.1})
    sched.on_result("b", 1, {"loss": 0.2})
    assert sched.on_result("c", 1, {"loss": 5.0}) == STOP
    assert sched.on_result("d", 1, {"loss": 0.01}) == CONTINUE


# ------------------------------------------------------- controller e2e
def make_quadratic_trainable():
    def trainable(config):
        from ray_tpu_torch import tune as rt_tune
        x = config["x"]
        for step in range(4):
            rt_tune.report({"score": -(x - 3.0) ** 2, "step": step})
    return trainable


def test_tuner_grid_sweep_best_result(ray_cluster, tmp_path):
    tuner = tune.Tuner(
        make_quadratic_trainable(),
        param_space={"x": tune.grid_search([0.0, 2.0, 3.0, 5.0])},
        tune_config=TuneConfig(metric="score", mode="max",
                               max_concurrent_trials=2),
        run_config=RunConfig(name="quad", storage_path=str(tmp_path)))
    grid = tuner.fit()
    assert len(grid) == 4
    assert grid.num_errors == 0
    assert all(t.status == TERMINATED for t in grid.trials)
    best = grid.get_best_result()
    assert best.metrics["config"]["x"] == 3.0
    assert best.metrics["score"] == 0.0


def test_tuner_trial_error_isolated(ray_cluster, tmp_path):
    def make_trainable():
        def trainable(config):
            from ray_tpu_torch import tune as rt_tune
            if config["x"] == 1:
                raise RuntimeError("bad trial")
            rt_tune.report({"score": float(config["x"])})
        return trainable

    grid = tune.Tuner(
        make_trainable(),
        param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="err", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 1
    assert grid.get_best_result().metrics["config"]["x"] == 2


@pytest.mark.slow        # ~40s: the heaviest tier-1 sink; ASHA e2e
                         # stays gated by the distributed-trials ASHA
                         # test below (tier-1 runs against an 870s
                         # wall-clock budget — see ROADMAP.md)
def test_tuner_asha_kills_underperformers_tiny_transformer(
        ray_cluster, tmp_path):
    """VERDICT r2 item 6 gate: lr sweep on the tiny transformer; ASHA
    stops hopeless lrs early; the best trial's checkpoint is returned
    and loadable."""
    def make_trainable():
        def trainable(config):
            import numpy as _np
            import torch

            from ray_tpu_torch import tune as rt_tune
            from ray_tpu_torch.models.config import tiny
            from ray_tpu_torch.models.transformer import Transformer
            from ray_tpu_torch.train import Checkpoint
            from ray_tpu_torch.train.session import make_temp_checkpoint_dir

            cfg = tiny(vocab_size=64)
            model = Transformer(cfg)
            params = model.init(0, "cpu")
            leaves = [p.requires_grad_() for p in
                      torch.utils._pytree.tree_leaves(params)]
            opt = torch.optim.Adam(leaves, lr=config["lr"])
            tokens = torch.as_tensor(_np.random.default_rng(1).integers(
                0, cfg.vocab_size, (4, 16)))

            for i in range(6):
                loss = model.loss(params, {"tokens": tokens})
                opt.zero_grad()
                loss.backward()
                opt.step()
                d = make_temp_checkpoint_dir()
                ckpt = Checkpoint.from_state(
                    d, {"params": torch.utils._pytree.tree_map(
                        lambda p: p.detach().numpy(), params),
                        "lr": _np.float64(config["lr"])})
                rt_tune.report({"loss": float(loss), "iter": i}, ckpt)
        return trainable

    tuner = tune.Tuner(
        make_trainable(),
        # 1e-300 can't learn anything; 1e-2 learns fast on the tiny model
        param_space={"lr": tune.grid_search([1e-300, 1e-300, 1e-300,
                                             1e-2])},
        tune_config=TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=2,
            scheduler=tune.ASHAScheduler(
                metric="loss", mode="min", max_t=6, grace_period=2,
                reduction_factor=2)),
        run_config=RunConfig(
            name="lr_sweep", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(
                num_to_keep=1, checkpoint_score_attribute="loss",
                checkpoint_score_order="min")))
    grid = tuner.fit()
    statuses = [t.status for t in grid.trials]
    assert statuses.count(STOPPED) >= 1, statuses   # ASHA killed some
    best = grid.get_best_result()
    assert best.metrics["config"]["lr"] == 1e-2
    assert best.checkpoint is not None
    state = best.checkpoint.load_state()
    assert float(state["lr"]) == 1e-2               # right trial's ckpt


def test_tuner_resume_from_experiment_state(ray_cluster, tmp_path):
    """Completed trials keep results on restore; unfinished re-run."""
    trainable = make_quadratic_trainable()
    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1.0, 3.0])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="res", storage_path=str(tmp_path)))
    grid = tuner.fit()
    exp_dir = grid.path

    # corrupt one trial back to PENDING, as if interrupted mid-flight
    import json
    import os
    sp = os.path.join(exp_dir, "experiment_state.json")
    state = json.load(open(sp))
    state["trials"][0]["status"] = "RUNNING"   # interrupted
    json.dump(state, open(sp, "w"))

    restored = tune.Tuner.restore(exp_dir, trainable)
    grid2 = restored.fit()
    assert len(grid2) == 2
    assert all(t.status == TERMINATED for t in grid2.trials)
    assert grid2.get_best_result().metrics["config"]["x"] == 3.0


# ------------------------------------------------------------------ PBT
def test_pbt_unit_exploit_decision():
    """Bottom-quantile trial exploits a top-quantile source; its config
    is a mutation of the source's."""
    sched = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        quantile_fraction=0.25,
        hyperparam_mutations={"lr": [0.001, 0.01, 0.1, 1.0]}, seed=1)
    for i, lr in enumerate([0.001, 0.01, 0.1, 1.0]):
        sched.on_trial_add(f"t{i}", {"lr": lr})
    # step 1: population fills, nobody perturbs yet (interval=2)
    for i, s in enumerate([0.0, 1.0, 2.0, 3.0]):
        assert sched.on_result(f"t{i}", 1, {"score": s}) == CONTINUE
    # step 2: the worst trial must exploit the best
    d = sched.on_result("t0", 2, {"score": 0.0})
    assert isinstance(d, tuple) and d[0] == "EXPLOIT"
    _, src, new_cfg = d
    assert src == "t3"
    assert new_cfg["lr"] in (0.1, 1.0)       # mutation of source's 1.0
    # the best trial does NOT exploit
    assert sched.on_result("t3", 2, {"score": 3.0}) == CONTINUE


def make_pbt_trainable():
    def trainable(config):
        import time as _time

        from ray_tpu_torch import tune as rt_tune
        from ray_tpu_torch.train import Checkpoint
        from ray_tpu_torch.train.session import make_temp_checkpoint_dir
        start, parent_lr = 0, None
        ckpt = rt_tune.get_checkpoint()
        if ckpt is not None:
            state = ckpt.load_state()
            start = int(state["step"])
            parent_lr = float(state["lr"])
        # 20 paced steps: under full-suite load worker spawns stagger
        # trial starts by seconds — the population must still overlap
        # long enough for at least one exploit decision
        for step in range(start, 20):
            # pace the loop so the whole population overlaps in time —
            # PBT needs concurrent trials to compare quantiles
            _time.sleep(0.5)
            d = make_temp_checkpoint_dir()
            c = Checkpoint.from_state(
                d, {"step": step + 1, "lr": float(config["lr"])})
            rt_tune.report(
                {"score": float(config["lr"]), "step": step,
                 "inherited_step": start,
                 "parent_lr": parent_lr if parent_lr is not None
                 else float("nan")}, c)
    return trainable


@pytest.mark.slow    # ~28s (r15 tier-1 budget); the exploit/
                     # inherit decision logic stays tier-1 via
                     # test_pbt_unit_exploit_decision
def test_pbt_e2e_perturbs_and_inherits_checkpoints(ray_cluster, tmp_path):
    """VERDICT r3 item 3 gate: a PBT run that perturbs lr and inherits
    checkpoints — exploited trials restart from the source's checkpoint
    (inherited_step > 0) with a mutated copy of its lr."""
    sched = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        quantile_fraction=0.25, resample_probability=0.0,
        hyperparam_mutations={"lr": tune.uniform(0.0, 1.0)}, seed=3)
    grid = tune.Tuner(
        make_pbt_trainable(),
        param_space={"lr": tune.grid_search([0.01, 0.02, 0.5, 1.0])},
        tune_config=TuneConfig(metric="score", mode="max",
                               max_concurrent_trials=4, scheduler=sched),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0
    assert sched.num_exploits >= 1
    exploited = [t for t in grid.trials if t.num_perturbations > 0]
    assert exploited, [t.to_json() for t in grid.trials]
    for t in exploited:
        # config was mutated: x0.8/1.2 of a top trial's lr, not the grid
        assert t.config["lr"] not in (0.01, 0.02)
        # checkpoint inheritance: the relaunched session restored the
        # source's checkpoint, so it started past step 0
        assert t.last_result["inherited_step"] > 0
        # and that checkpoint came from a high-lr (top-quantile) trial
        assert t.last_result["parent_lr"] >= 0.4


# ---------------------------------------------------------- TPE searcher
def test_tpe_searcher_converges_toward_optimum():
    """On score = -(x-3)^2 the TPE suggestions should concentrate near
    x=3 once past the random-initial phase."""
    s = tune.TPESearcher(n_initial=8, seed=0)
    s.set_space({"x": tune.uniform(0.0, 10.0)}, "score", "max")
    for i in range(40):
        tid = f"t{i}"
        cfg = s.suggest(tid)
        s.on_trial_complete(tid, {"score": -(cfg["x"] - 3.0) ** 2})
    late = [s.suggest(f"probe{i}")["x"] for i in range(10)]
    # concentrated near the optimum (random would average |x-3| ~ 3.0)
    assert np.mean([abs(x - 3.0) for x in late]) < 1.5, late


def test_tpe_searcher_categorical_and_loguniform():
    s = tune.TPESearcher(n_initial=6, seed=1)
    s.set_space({"lr": tune.loguniform(1e-5, 1e-1),
                 "act": tune.choice(["relu", "gelu", "tanh"])},
                "score", "max")
    # "gelu" with lr near 1e-2 is best
    for i in range(30):
        tid = f"t{i}"
        cfg = s.suggest(tid)
        import math as m
        score = -abs(m.log10(cfg["lr"]) + 2.0) + \
            (1.0 if cfg["act"] == "gelu" else 0.0)
        s.on_trial_complete(tid, {"score": score})
    late = [s.suggest(f"p{i}") for i in range(10)]
    gelu_frac = sum(1 for c in late if c["act"] == "gelu") / len(late)
    assert gelu_frac >= 0.5
    assert all(1e-5 <= c["lr"] <= 1e-1 for c in late)


@pytest.mark.slow    # ~29s (r15 tier-1 budget); TPE math stays
                     # tier-1 via the two tpe_searcher unit tests,
                     # tuner e2e via test_tuner_grid_sweep_best_result
def test_tuner_with_tpe_searcher(ray_cluster, tmp_path):
    grid = tune.Tuner(
        make_quadratic_trainable(),
        param_space={"x": tune.uniform(0.0, 6.0)},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=6,
                               max_concurrent_trials=2,
                               search_alg=tune.TPESearcher(
                                   n_initial=3, seed=5)),
        run_config=RunConfig(name="tpe", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0
    assert len(grid) == 6
    assert grid.get_best_result().metrics["score"] > -9.0


# ----------------------------------------------- distributed (group) trials
@pytest.mark.slow    # ~26s (r15 tier-1 budget); ASHA rung logic
                     # stays tier-1 via the three asha unit tests
def test_tuner_distributed_trials_torchtrainer_asha(ray_cluster, tmp_path):
    """VERDICT r3 item 3 gate: tune a 2-worker TorchTrainer under ASHA —
    each trial is a PG-placed worker group; ASHA stops the bad lr
    early; results prove both ranks ran."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def loop(config):
        from ray_tpu_torch import train as rt_train
        ctx = rt_train.get_context()
        # deterministic "training curve": good lr converges
        for step in range(6):
            loss = 1.0 / (1 + step * config["lr"])
            rt_train.report({"loss": loss, "step": step,
                             "world_size": ctx.get_world_size(),
                             "rank": ctx.get_world_rank()})

    trainer = TorchTrainer(
        loop, train_loop_config={"lr": 0.0},
        scaling_config=ScalingConfig(num_workers=2))
    grid = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([1e-6, 1e-6, 10.0])},
        tune_config=TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(
                metric="loss", mode="min", max_t=6, grace_period=2,
                reduction_factor=2)),
        run_config=RunConfig(name="dist", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0, [t.error for t in grid.trials]
    statuses = [t.status for t in grid.trials]
    assert statuses.count(STOPPED) >= 1, statuses
    best = grid.get_best_result()
    assert best.metrics["config"]["lr"] == 10.0
    assert best.metrics["world_size"] == 2      # really a 2-worker group


@pytest.mark.slow    # ~31s (r15 tier-1 budget); lazy-suggest is
                     # also exercised by the (slow) TPE tuner e2e;
                     # searcher feedback math stays tier-1 via
                     # test_tpe_searcher_converges_toward_optimum
def test_searcher_gets_feedback_before_late_suggestions(ray_cluster,
                                                        tmp_path):
    """suggest() must run lazily at trial launch so later suggestions
    see completed-trial observations (review regression: eager up-front
    generation made TPE pure random)."""
    class Recorder(tune.TPESearcher):
        def __init__(self):
            super().__init__(n_initial=2, seed=0)
            self.obs_at_suggest = []

        def suggest(self, tid):
            self.obs_at_suggest.append(len(self._obs))
            return super().suggest(tid)

    s = Recorder()
    tune.Tuner(
        make_quadratic_trainable(),
        param_space={"x": tune.uniform(0.0, 6.0)},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=5,
                               max_concurrent_trials=1, search_alg=s),
        run_config=RunConfig(name="lazy", storage_path=str(tmp_path)),
    ).fit()
    assert len(s.obs_at_suggest) == 5
    # sequential trials: the 5th suggestion has >=3 completed observations
    assert s.obs_at_suggest[-1] >= 3, s.obs_at_suggest
