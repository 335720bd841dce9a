"""Sebulba inference actors: admission-batched policy serving (r20).

Port of `ray_tpu/rllib/sebulba/inference.py`. The Podracer split's
serving half. One InferenceActor serves
`act(obs_batch) -> (actions, logp, policy_version)` to many env-runner
actors over the direct call plane; a background step loop (the LLM
engine's admission idiom — `_loop`/`_kick`/`_stop`, parked requests
coalesced per iteration) stacks every parked request into ONE forward
pass, so N concurrent callers cost one policy evaluation, not N. Create
the actor with `max_concurrency` >= the number of runners so their
blocking `act()` calls can all park at once.

Weights arrive versioned (`set_weights(weights, version)`): versions
are monotonic per actor — a stale publish (version <= current) is
dropped, so out-of-order broadcast deliveries can never roll a policy
back. Callers get the serving version back with every batch, which is
what makes learner staleness measurable end to end.

The default policy is the tiny ActorCriticModule MLP evaluated in numpy
(a classic-control batch costs less in numpy than the dispatch of a
framework call — the env-runner precedent). Pass `module_factory` for
heavier policies: it returns a module with `forward_policy_np(params,
obs)` and `sample_np(logits, rng, params)`, and, where its params are
not the numpy nest `to_numpy_params` makes, `params_from_weights(state
dict)`. `TorchPolicy` is such a module: its forward runs in torch on a
device (the card by default). The admission loop is unchanged — only
`_forward` swaps out.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.rllib.core.rl_module import (ActorCriticModule,
                                                to_numpy_params)
from ray_tpu_torch.rllib.sebulba.stats import RL_STATS


class TorchPolicy(ActorCriticModule):
    """A discrete ActorCriticModule whose policy forward runs in torch on
    `device` (None = the card). Its params are the learner's state dict
    on that device, one dict per publish, so a forward in flight keeps
    the weights it started with."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64),
                 device: Optional[str] = None, seed: int = 0):
        super().__init__(obs_dim, num_actions, hidden,
                         generator=torch.Generator().manual_seed(seed))
        self.device = resolve_device(device)
        self.to(self.device)

    def params_from_weights(self, weights) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, copy=True)
                for k, v in weights.items()}

    @torch.no_grad()
    def forward_policy_np(self, params, obs):
        x = torch.as_tensor(obs, device=self.device)
        logits, _ = torch.func.functional_call(self, params, (x,))
        return logits.cpu().numpy()


class _Req:
    __slots__ = ("obs", "out", "error")

    def __init__(self, obs):
        self.obs = obs
        self.out = None
        self.error: Optional[BaseException] = None


class InferenceActor:
    """Actor-hosted batched policy server (one per replica group)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), *,
                 continuous: bool = False, seed: int = 0,
                 module_factory: Optional[Callable[[], Any]] = None):
        if module_factory is not None:
            self.module = module_factory()
        else:
            self.module = ActorCriticModule(
                obs_dim=int(obs_dim), num_actions=int(num_actions),
                hidden=tuple(int(h) for h in hidden),
                continuous=bool(continuous),
                generator=torch.Generator().manual_seed(int(seed)))
        self.params = self._params_from(self.module.state_dict())
        # -1 = factory weights, never published by a learner: the
        # initial version-0 publish must apply (monotonic thereafter)
        self.policy_version = -1
        self._rng = np.random.default_rng(int(seed) + 7)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._waiting: List[_Req] = []
        self.counters = {"requests": 0, "forwards": 0,
                         "batched_obs": 0, "max_batch": 0,
                         "weight_updates": 0, "stale_weight_drops": 0}
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="rtt-rl-infer", daemon=True)
        self._thread.start()

    def _params_from(self, weights):
        """The module's params from a state dict (tensors or arrays)."""
        convert = getattr(self.module, "params_from_weights", None)
        if convert is not None:
            return convert(weights)
        return to_numpy_params(self.module, weights)

    # ---------------------------------------------------- serving API
    def act(self, obs_batch) -> Tuple[np.ndarray, np.ndarray, int]:
        """Park the request for the admission loop; block until the
        batched forward that includes it completes. Returns (actions,
        logp, policy_version) for exactly this caller's rows."""
        req = _Req(np.asarray(obs_batch, dtype=np.float32))
        with self._cv:
            if self._stop.is_set():
                raise RuntimeError("inference actor closed")
            self._waiting.append(req)
            self.counters["requests"] += 1
            RL_STATS["infer_requests"] += 1
        self._kick.set()
        with self._cv:
            while req.out is None and req.error is None:
                self._cv.wait(0.2)
        if req.error is not None:
            raise req.error
        return req.out

    def set_weights(self, weights, version: int, *,
                    force: bool = False) -> int:
        """Install published weights iff `version` advances (or
        `force`, for checkpoint-restore fencing). Returns the version
        now serving — callers learn about a dropped stale publish."""
        version = int(version)
        from ray_tpu_torch._private.refs import ObjectRef
        if isinstance(weights, ObjectRef):
            import ray_tpu_torch
            weights = ray_tpu_torch.get(weights)
        with self._lock:
            if not force and version <= self.policy_version:
                self.counters["stale_weight_drops"] += 1
                return self.policy_version
            self.params = self._params_from(weights)
            self.policy_version = version
            self.counters["weight_updates"] += 1
            return version

    def ping(self) -> int:
        return self.policy_version

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["policy_version"] = self.policy_version
            out["waiting"] = len(self._waiting)
        return out

    def close(self) -> None:
        self._stop.set()
        self._kick.set()
        with self._cv:
            self._cv.notify_all()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------- admission loop
    def _loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(0.05)
            self._kick.clear()
            # admission window: let concurrent callers pile up so one
            # forward serves them all (per-iteration admission)
            wait_ms = CONFIG.rl_infer_wait_ms
            if wait_ms > 0:
                with self._lock:
                    pending = len(self._waiting)
                if pending:
                    time.sleep(wait_ms / 1e3)
            with self._cv:
                if not self._waiting:
                    continue
                batch = self._waiting[:CONFIG.rl_infer_max_batch]
                del self._waiting[:len(batch)]
            try:
                self._step(batch)
            except BaseException as e:   # noqa: BLE001 — must wake callers
                with self._cv:
                    for req in batch:
                        req.error = e
                    self._cv.notify_all()
        with self._cv:
            for req in self._waiting:
                req.error = RuntimeError("inference actor closed")
            self._waiting.clear()
            self._cv.notify_all()

    def _step(self, batch: List[_Req]) -> None:
        rows = [r.obs for r in batch]
        stacked = np.concatenate(rows, axis=0)
        with self._lock:
            params = self.params
            version = self.policy_version
        actions, logp = self._forward(params, stacked)
        delay = CONFIG.rl_step_delay_s
        if delay > 0:                   # chaos pacing (llm_step_delay_s twin)
            time.sleep(delay)
        self.counters["forwards"] += 1
        self.counters["batched_obs"] += int(stacked.shape[0])
        self.counters["max_batch"] = max(self.counters["max_batch"],
                                         len(batch))
        RL_STATS["infer_forwards"] += 1
        RL_STATS["infer_batched_obs"] += int(stacked.shape[0])
        RL_STATS["infer_max_batch"] = max(RL_STATS["infer_max_batch"],
                                          len(batch))
        with self._cv:
            off = 0
            for req in batch:
                n = req.obs.shape[0]
                req.out = (actions[off:off + n], logp[off:off + n],
                           version)
                off += n
            self._cv.notify_all()

    def _forward(self, params, obs: np.ndarray):
        logits = self.module.forward_policy_np(params, obs)
        return self.module.sample_np(logits, self._rng, params)
