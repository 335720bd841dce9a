"""Tuner + trial controller: concurrent trials, schedulers, searchers,
PBT, distributed (worker-group) trials, resume.

Port of `ray_tpu/tune/tuner.py`: a copy with `TorchTrainer` in place of
`JaxTrainer` and a `GPU` resource in place of `TPU` in
`resources_per_trial` (a trial actor gets `num_gpus`).

Parity: reference tune/execution/tune_controller.py (trial lifecycle
state machine + event loop), tune/tuner.py (Tuner.fit/restore),
tune/result_grid.py, tune/execution/placement_groups.py (trial PGs) —
re-shaped for this stack:

- a trial is either ONE RayTrainWorker actor (function trainables) or a
  whole PG-placed WorkerGroup (when the trainable is a TorchTrainer), so a
  multi-host SPMD trainer can be tuned with per-report scheduling
  decisions — the reference reaches this through Trainable-wrapping at
  base_trainer.py:567-623, here the controller drives the group
  directly;
- `ray_tpu_torch.train.report(metrics, checkpoint)` works unchanged inside any
  trainable; checkpoints ride the object store as tar bytes (no shared
  fs), which is also the PBT exploit/inherit transport;
- the controller multiplexes trials with `ray_tpu_torch.wait` instead of a
  callback event loop.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import Result
from ray_tpu_torch.tune.schedulers import (CONTINUE, EXPLOIT, STOP,
                                     FIFOScheduler)
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"   # ran to completion (or scheduler max_t)
STOPPED = "STOPPED"         # killed early by the scheduler
ERROR = "ERROR"


@dataclasses.dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 2
    scheduler: Any = None               # default FIFO
    search_alg: Optional[Searcher] = None
    seed: int = 0
    resources_per_trial: Optional[Dict[str, float]] = None
    trial_poll_timeout: float = 120.0


@dataclasses.dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = PENDING
    last_result: Dict[str, Any] = dataclasses.field(default_factory=dict)
    num_results: int = 0
    best_checkpoint_path: Optional[str] = None
    error: Optional[str] = None
    num_perturbations: int = 0

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Trial":
        return cls(**d)


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: str, mode: str,
                 path: str):
        self.trials = trials
        self._metric, self._mode = metric, mode
        self.path = path

    def __len__(self) -> int:
        return len(self.trials)

    def _trial_result(self, t: Trial) -> Result:
        ckpt = (Checkpoint(t.best_checkpoint_path)
                if t.best_checkpoint_path else None)
        return Result(metrics=dict(t.last_result), checkpoint=ckpt,
                      path=self.path, metrics_history=[],
                      error=t.error, config=dict(t.config))

    def __iter__(self):
        """Per-trial Results, reference ResultGrid iteration."""
        return (self._trial_result(t) for t in self.trials)

    def __getitem__(self, i: int) -> Result:
        return self._trial_result(self.trials[i])

    @property
    def num_errors(self) -> int:
        return sum(1 for t in self.trials if t.status == ERROR)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        sign = 1.0 if mode == "max" else -1.0
        best: Optional[Trial] = None
        best_v = -float("inf")
        for t in self.trials:
            if metric not in t.last_result:
                continue
            v = sign * float(t.last_result[metric])
            if v > best_v:
                best, best_v = t, v
        if best is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        r = self._trial_result(best)
        # kept in metrics for backwards compatibility with earlier
        # callers; Result.config is the structured home
        r.metrics.setdefault("config", dict(best.config))
        r.metrics.setdefault("trial_id", best.trial_id)
        return r


# ------------------------------------------------------------ runners
class _FnTrialRunner:
    """One RayTrainWorker actor running a function trainable."""

    def __init__(self, actor_cls, fn_bytes: bytes):
        self._actor_cls = actor_cls
        self._fn_bytes = fn_bytes
        self._actor = None

    def launch(self, config: Dict[str, Any],
               restore_bytes: Optional[bytes]) -> None:
        self._actor = self._actor_cls.remote(0, 1)
        self._actor.init_session.remote(
            self._fn_bytes, config, restore_bytes, None)

    def poll(self):
        """Submit one next_result round; returns the ref to wait on."""
        return self._actor.next_result.remote()

    def collect(self, ref, timeout: float):
        """-> (metrics, ckpt_bytes) or None (trainable finished)."""
        return ray_tpu_torch.get(ref, timeout=timeout)

    def stop(self) -> None:
        if self._actor is not None:
            try:
                ray_tpu_torch.kill(self._actor)
            except BaseException:
                pass
            self._actor = None


class _GroupTrialRunner:
    """A PG-placed WorkerGroup running a TorchTrainer's loop — the
    distributed-trial path (reference tune/execution/placement_groups.py:
    every trial owns a placement group sized to its worker group)."""

    def __init__(self, trainer):
        self._trainer = trainer
        self._group = None
        self._backend = None
        self._round_refs: List[Any] = []

    def launch(self, config: Dict[str, Any],
               restore_bytes: Optional[bytes]) -> None:
        from ray_tpu_torch.train.backend import Backend
        from ray_tpu_torch.train.worker_group import WorkerGroup
        tr = self._trainer
        scaling = tr._scaling
        group = WorkerGroup.from_scaling(scaling)
        group.start()
        try:
            backend: Backend = tr._backend_config.backend_cls()()
            backend.on_start(group, tr._backend_config)
            fn_bytes = cloudpickle.dumps(tr._fn)
            restore_arg = (ray_tpu_torch.put(restore_bytes)
                           if restore_bytes is not None else None)
            shard_bytes = tr._dataset_shards(group.world_size)
            ray_tpu_torch.get([
                w.init_session.remote(fn_bytes, config, restore_arg,
                                      shard_bytes[i])
                for i, w in enumerate(group.workers)])
            backend.on_training_start(group, tr._backend_config)
        except BaseException:
            # never strand a started PG + actors on a failed launch
            group.shutdown()
            raise
        self._group, self._backend = group, backend

    def poll(self):
        """One synchronous round: report() is collective in SPMD loops,
        so every rank reaches it together; the controller waits on rank
        0's ref and gathers the rest at collect()."""
        self._round_refs = [w.next_result.remote()
                            for w in self._group.workers]
        return self._round_refs[0]

    def collect(self, ref, timeout: float):
        results = ray_tpu_torch.get(self._round_refs, timeout=timeout)
        return results[0]          # rank 0 carries metrics + checkpoint

    def stop(self) -> None:
        if self._group is not None:
            try:
                self._backend.on_shutdown(self._group)
            except BaseException:
                pass
            self._group.shutdown()
            self._group = None


class Tuner:
    """Sweep a trainable over a param space.

    Two trainable forms:
    - a function ``trainable(config)`` — runs inside one trial actor and
      reports via ``ray_tpu_torch.train.report(metrics, checkpoint=...)``;
    - a ``TorchTrainer`` instance — each trial becomes a PG-placed worker
      group running the trainer's loop with the trial's
      ``train_loop_config``; param_space may be flat (merged into
      train_loop_config) or ``{"train_loop_config": {...}}``.
    """

    def __init__(self, trainable: Any,
                 *, param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None,
                 _restored_trials: Optional[List[Trial]] = None):
        from ray_tpu_torch.train.config import RunConfig
        self._trainable = trainable
        self._param_space = dict(param_space or {})
        self._tune = tune_config or TuneConfig()
        self._run = run_config or RunConfig()
        self._restored = _restored_trials

    # --------------------------------------------------------- persist
    def _state_path(self, exp_dir: str) -> str:
        return os.path.join(exp_dir, "experiment_state.json")

    def _save_state(self, exp_dir: str, trials: List[Trial]) -> None:
        tmp = self._state_path(exp_dir) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"trials": [t.to_json() for t in trials],
                       "metric": self._tune.metric,
                       "mode": self._tune.mode}, f, indent=1)
        os.replace(tmp, self._state_path(exp_dir))

    @classmethod
    def restore(cls, exp_dir: str, trainable: Callable,
                tune_config: Optional[TuneConfig] = None,
                run_config=None) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        results; RUNNING/PENDING/ERROR trials are re-run (reference
        Tuner.restore + experiment_state semantics)."""
        from ray_tpu_torch.train.config import RunConfig
        with open(os.path.join(exp_dir, "experiment_state.json")) as f:
            state = json.load(f)
        trials = [Trial.from_json(d) for d in state["trials"]]
        run = run_config or RunConfig(
            name=os.path.basename(exp_dir.rstrip("/")),
            storage_path=os.path.dirname(exp_dir.rstrip("/")))
        space: Dict[str, Any] = {}
        sp = os.path.join(exp_dir, "param_space.pkl")
        if os.path.exists(sp):
            with open(sp, "rb") as f:
                space = cloudpickle.load(f)
        return cls(trainable, param_space=space,
                   tune_config=tune_config or TuneConfig(
                       metric=state["metric"], mode=state["mode"]),
                   run_config=run, _restored_trials=trials)

    # -------------------------------------------------- trial creation
    def _generate_trials(self) -> List[Trial]:
        cfg = self._tune
        space = self._param_space
        if "train_loop_config" in space and len(space) == 1:
            space = space["train_loop_config"]
        if self._restored is not None:
            if cfg.search_alg is not None:
                # re-arm the searcher so unlaunched ({} config) restored
                # trials can still get lazy suggestions
                cfg.search_alg.set_space(space, cfg.metric, cfg.mode)
            return [
                t if t.status in (TERMINATED, STOPPED)
                else Trial(t.trial_id, t.config)
                for t in self._restored]
        if cfg.search_alg is not None:
            cfg.search_alg.set_space(space, cfg.metric, cfg.mode)
            # configs stay empty until launch: suggest() runs lazily so
            # the searcher sees completed-trial feedback mid-experiment
            return [Trial(f"trial_{i:05d}", {})
                    for i in range(cfg.num_samples)]
        gen = BasicVariantGenerator(cfg.seed)
        return [Trial(f"trial_{i:05d}", c) for i, c in enumerate(
            gen.variants(space, cfg.num_samples))]

    def _runner_factory(self):
        """Built ONCE per fit(): returns (make_runner, resources_needed).
        The trainable pickle and remote actor class are shared across
        every trial launch (and PBT relaunch)."""
        from ray_tpu_torch.train.trainer import TorchTrainer
        if isinstance(self._trainable, TorchTrainer):
            tr = self._trainable
            per = dict(tr._scaling.worker_resources() or {"CPU": 1.0})
            need = {k: v * tr._scaling.num_workers for k, v in per.items()}
            return (lambda: _GroupTrialRunner(tr)), need
        res = dict(self._tune.resources_per_trial or {"CPU": 1.0})
        need = dict(res)
        actor_cls = ray_tpu_torch.remote(**{
            "num_cpus": res.pop("CPU", 1.0),
            "num_gpus": res.pop("GPU", 0) or None,
            "resources": res or None})(
                _lazy_train_worker())
        fn_bytes = cloudpickle.dumps(self._trainable)
        return (lambda: _FnTrialRunner(actor_cls, fn_bytes)), need

    def _trial_config(self, trial: Trial) -> Dict[str, Any]:
        from ray_tpu_torch.train.trainer import TorchTrainer
        if isinstance(self._trainable, TorchTrainer):
            return {**self._trainable._config, **trial.config}
        return trial.config

    # ------------------------------------------------------------- fit
    def fit(self) -> ResultGrid:
        cfg = self._tune
        run_name = self._run.name or f"tune_{int(time.time())}"
        storage = (self._run.storage_path
                   or os.path.expanduser("~/ray_tpu_results"))
        exp_dir = os.path.join(storage, run_name)
        os.makedirs(exp_dir, exist_ok=True)
        scheduler = cfg.scheduler or FIFOScheduler()
        searcher = cfg.search_alg

        trials = self._generate_trials()
        if not trials:
            raise ValueError("param space produced no trials")
        if self._param_space and self._restored is None:
            # persist the space (Domains and all) so restore() can
            # re-arm a searcher for still-unlaunched trials
            with open(os.path.join(exp_dir, "param_space.pkl"),
                      "wb") as f:
                cloudpickle.dump(self._param_space, f)
        make_runner, trial_resources = self._runner_factory()

        pending = [t for t in trials if t.status == PENDING]
        runners: Dict[str, Any] = {}      # trial_id -> runner
        inflight: Dict[str, Trial] = {}   # ref.object_id -> trial
        ref_of: Dict[str, Any] = {}       # trial_id -> wait ref
        managers: Dict[str, CheckpointManager] = {}
        ckpt_cfg = self._run.checkpoint_config
        # restore bytes for requeued relaunches (PBT exploit that lost a
        # placement race keeps its inherited checkpoint)
        pending_restore: Dict[str, bytes] = {}

        def launch(trial: Trial,
                   restore_bytes: Optional[bytes] = None) -> None:
            if searcher is not None and not trial.config:
                trial.config = searcher.suggest(trial.trial_id)
            if restore_bytes is None:
                restore_bytes = pending_restore.pop(trial.trial_id, None)
            runner = make_runner()
            runner.launch(self._trial_config(trial), restore_bytes)
            trial.status = RUNNING
            runners[trial.trial_id] = runner
            if trial.trial_id not in managers:
                managers[trial.trial_id] = CheckpointManager(
                    os.path.join(exp_dir, trial.trial_id, "checkpoints"),
                    num_to_keep=ckpt_cfg.num_to_keep,
                    score_attribute=ckpt_cfg.checkpoint_score_attribute,
                    score_order=ckpt_cfg.checkpoint_score_order)
            if hasattr(scheduler, "on_trial_add"):
                scheduler.on_trial_add(trial.trial_id, trial.config)
            poll(trial)

        def poll(trial: Trial) -> None:
            ref = runners[trial.trial_id].poll()
            inflight[ref.object_id] = trial
            ref_of[trial.trial_id] = ref

        def finish(trial: Trial, status: str,
                   error: Optional[str] = None) -> None:
            trial.status = status
            trial.error = error
            runner = runners.pop(trial.trial_id, None)
            ref_of.pop(trial.trial_id, None)
            if runner is not None:
                runner.stop()
            mgr = managers.get(trial.trial_id)
            if mgr is not None and mgr.best is not None:
                trial.best_checkpoint_path = mgr.best.path
            if searcher is not None:
                searcher.on_trial_complete(trial.trial_id,
                                           trial.last_result)
            self._save_state(exp_dir, trials)

        def latest_ckpt_bytes(trial_id: str) -> Optional[bytes]:
            mgr = managers.get(trial_id)
            if mgr is None or mgr.latest is None:
                return None
            from ray_tpu_torch.train.checkpoint import pack_dir
            return pack_dir(mgr.latest.path)

        def capacity_for_trial() -> bool:
            """Advisory pre-check so a full cluster defers a launch
            instead of blocking the controller in a 60s PG wait while
            healthy trials starve."""
            try:
                avail = ray_tpu_torch.available_resources()
            except Exception:
                return True
            return all(avail.get(k, 0.0) >= v
                       for k, v in trial_resources.items())

        try:
            while pending or runners:
                while pending and len(runners) < cfg.max_concurrent_trials:
                    if runners and not capacity_for_trial():
                        break                    # defer until a trial frees up
                    trial = pending.pop(0)
                    try:
                        launch(trial)
                    except Exception as e:
                        if not runners:
                            # nothing running to free capacity — surface it
                            finish(trial, ERROR, error=repr(e))
                            continue
                        # transient (e.g. PG race lost): retry after progress
                        trial.status = PENDING
                        runners.pop(trial.trial_id, None)
                        ref_of.pop(trial.trial_id, None)
                        pending.append(trial)
                        break
                if not runners:
                    if pending:
                        continue
                    break
                ready, _ = ray_tpu_torch.wait(
                    [ref_of[t] for t in runners], num_returns=1,
                    timeout=cfg.trial_poll_timeout)
                if not ready:
                    raise TimeoutError(
                        f"no trial progressed within "
                        f"{cfg.trial_poll_timeout}s: {sorted(runners)}")
                ref = ready[0]
                trial = inflight.pop(ref.object_id)
                try:
                    # gather timeout matches the wait phase: an SPMD
                    # trial's other ranks may lag rank 0 by a full jit
                    # compile, which routinely exceeds 30s
                    item = runners[trial.trial_id].collect(
                        ref, timeout=cfg.trial_poll_timeout)
                except BaseException as e:
                    finish(trial, ERROR, error=repr(e))
                    continue
                if item is None:
                    finish(trial, TERMINATED)
                    continue
                metrics, ckpt_bytes = item
                trial.num_results += 1
                trial.last_result = metrics
                if ckpt_bytes is not None:
                    managers[trial.trial_id].register_bytes(ckpt_bytes,
                                                            metrics)
                if searcher is not None:
                    searcher.on_trial_result(trial.trial_id,
                                             trial.num_results, metrics)
                decision = scheduler.on_result(
                    trial.trial_id, trial.num_results, metrics)
                if decision == STOP:
                    finish(trial, STOPPED)
                elif isinstance(decision, tuple) and decision[0] == EXPLOIT:
                    # PBT: inherit the source trial's checkpoint + mutated
                    # config, restart this trial's runner in place
                    _, src_id, new_config = decision
                    restore = latest_ckpt_bytes(src_id)
                    runners.pop(trial.trial_id).stop()
                    ref_of.pop(trial.trial_id, None)
                    trial.config = dict(new_config)
                    trial.num_perturbations += 1
                    try:
                        launch(trial, restore)
                    except Exception:
                        # transient (e.g. lost the PG race to the
                        # stopping group's teardown): requeue like the
                        # launch loop does instead of erroring a healthy
                        # trial; the inherited checkpoint rides along
                        trial.status = PENDING
                        runners.pop(trial.trial_id, None)
                        ref_of.pop(trial.trial_id, None)
                        if restore is not None:
                            pending_restore[trial.trial_id] = restore
                        pending.append(trial)
                else:
                    assert decision == CONTINUE
                    poll(trial)
                self._save_state(exp_dir, trials)
        except BaseException:
            for _r in list(runners.values()):
                try:
                    _r.stop()
                except BaseException:
                    pass
            raise

        self._save_state(exp_dir, trials)
        return ResultGrid(trials, cfg.metric, cfg.mode, exp_dir)


def _lazy_train_worker():
    from ray_tpu_torch.train.worker_group import RayTrainWorker
    return RayTrainWorker
