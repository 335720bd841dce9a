"""Sebulba env runners: vectorized acting against remote inference,
trajectory shards streamed into wire-channel rings (r20).

Port of `ray_tpu/rllib/sebulba/env_runner.py`, over the port's
wire-channel rings. The env is a gymnasium id or a callable
`env(num_envs)` returning a vector env (`env/env_runner.py::make_env`,
the seam the other runners share).

The Podracer split's sampling half. A SebulbaEnvRunner owns a
vector env but NO policy — every step's actions come from an
InferenceActor over the r18 direct call plane (`act(obs) -> actions,
logp, policy_version`). Completed fixed-length rollouts are published
as time-major shards into an r13 wire-channel ring the runner itself
serves (`serve_channel(n_readers=1, depth=rl_ring_depth)`); the
learner dials in as the single reader. The ring depth is the whole
flow-control story: `write()` blocks while the learner lags more than
`depth` shards, so a consumed shard can never be more than depth+2
policy versions stale per runner (depth in the ring + one being
produced + one being consumed) at publish interval 1.

Elasticity: the runner holds a list of inference handles; a failed
act() (actor died, partitioned, timed out) rotates to the next handle
and retries with the SAME observation — the env has not stepped, so
failover is exactly-once by construction (no lost or duplicated env
steps, the chaos gate's accounting invariant). Handles may also be
plain local objects exposing `act()`, which keeps the whole data path
testable in-process in tier-1 time.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.rllib.env.env_runner import make_env
from ray_tpu_torch.rllib.sebulba.stats import RL_STATS


@dataclasses.dataclass
class SebulbaRunnerConfig:
    # a gymnasium id, or a callable num_envs -> vector env
    env: Union[str, Callable[[int], Any]] = "CartPole-v1"
    num_envs: int = 8
    rollout_length: int = 16
    ring_depth: Optional[int] = None       # None -> CONFIG.rl_ring_depth
    seed: int = 0
    act_timeout_s: float = 30.0            # per remote act() attempt
    max_failovers: int = 8                 # per act(), before giving up
    write_timeout_s: Optional[float] = 120.0
    episode_metric_window: int = 100


class SebulbaEnvRunner:
    """Vector env + inference handles + one trajectory ring."""

    _f32 = staticmethod(
        lambda obs: (obs.astype(np.float32) / 255.0
                     if np.issubdtype(obs.dtype, np.integer)
                     else obs.astype(np.float32)))

    def __init__(self, config: SebulbaRunnerConfig, runner_index: int,
                 inference: Sequence[Any]):
        from ray_tpu_torch.experimental.wire_channel import serve_channel

        if not inference:
            raise ValueError("need at least one inference handle")
        self.config = config
        self.runner_index = runner_index
        self._infer = list(inference)
        self._cur = runner_index % len(self._infer)
        seed = config.seed + 1000 * runner_index
        self._envs = make_env(config.env, config.num_envs)
        act_space = self._envs.single_action_space
        self._continuous = not hasattr(act_space, "n")
        if self._continuous:
            self._act_low = np.asarray(act_space.low, np.float32)
            self._act_high = np.asarray(act_space.high, np.float32)
        self._obs, _ = self._envs.reset(seed=seed)
        self._prev_done = np.zeros(config.num_envs, bool)
        depth = (config.ring_depth if config.ring_depth is not None
                 else CONFIG.rl_ring_depth)
        self._channel = serve_channel(
            n_readers=1, depth=depth, label=f"rl{runner_index}")
        self._writer = self._channel.writer()
        self._seq = 0
        self.counters = {"shards": 0, "steps": 0, "failovers": 0,
                         "act_calls": 0, "last_version": -1}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream_error: Optional[BaseException] = None

    # ------------------------------------------------------------ rpc
    def ping(self) -> str:
        return "pong"

    def channel(self):
        """The ring descriptor the learner dials (reader index 0)."""
        return self._channel

    def stats(self) -> dict:
        out = dict(self.counters)
        out["seq"] = self._seq
        out["stream_error"] = (repr(self._stream_error)
                               if self._stream_error else None)
        return out

    # --------------------------------------------------------- acting
    def _call_act(self, obs: np.ndarray):
        """One batched action request, with failover: any failure
        (died/partitioned/slow actor) retargets the NEXT handle and
        retries the same observation — the env only steps once an
        answer lands, so accounting stays exact across failures."""
        last: Optional[BaseException] = None
        for _ in range(self.config.max_failovers + 1):
            h = self._infer[self._cur]
            try:
                self.counters["act_calls"] += 1
                fn = getattr(h, "act")
                if hasattr(fn, "remote"):
                    import ray_tpu_torch
                    out = ray_tpu_torch.get(
                        fn.remote(obs),
                        timeout=self.config.act_timeout_s)
                else:
                    out = fn(obs)
                actions, logp, version = out
                self.counters["last_version"] = int(version)
                return (np.asarray(actions), np.asarray(logp),
                        int(version))
            except Exception as e:   # noqa: BLE001 — failover boundary
                last = e
                self.counters["failovers"] += 1
                RL_STATS["failovers"] += 1
                self._cur = (self._cur + 1) % len(self._infer)
        raise RuntimeError(
            f"env runner {self.runner_index}: all inference handles "
            f"failed after {self.config.max_failovers + 1} attempts"
        ) from last

    def collect_shard(self) -> Dict[str, Any]:
        """One fixed-length time-major rollout acting remotely. Same
        batch contract as SingleAgentEnvRunner.sample() (autoreset
        filler masked, truncation keeps the bootstrap) plus shard
        metadata: runner / seq (contiguous per runner — the chaos
        gate's accounting key) / version (min behavior policy version,
        what learner staleness is measured against)."""
        T, N = self.config.rollout_length, self.config.num_envs
        proc = self._f32(self._obs)
        obs_buf = np.empty((T + 1, N) + proc.shape[1:], np.float32)
        act_buf: Optional[np.ndarray] = None
        logp_buf = np.empty((T, N), np.float32)
        rew_buf = np.empty((T, N), np.float32)
        term_buf = np.empty((T, N), np.float32)
        done_buf = np.empty((T, N), np.float32)
        mask_buf = np.empty((T, N), np.float32)
        min_version = None
        for t in range(T):
            obs_buf[t] = proc
            action, logp, version = self._call_act(proc)
            min_version = (version if min_version is None
                           else min(min_version, version))
            env_action = action
            if self._continuous:
                env_action = np.clip(action, self._act_low,
                                     self._act_high)
            nobs, reward, term, trunc, _ = self._envs.step(env_action)
            done = np.logical_or(term, trunc)
            if act_buf is None:
                act_buf = np.empty((T,) + action.shape, action.dtype)
            act_buf[t] = action
            logp_buf[t] = logp
            rew_buf[t] = reward
            term_buf[t] = term.astype(np.float32)
            done_buf[t] = done.astype(np.float32)
            mask_buf[t] = (~self._prev_done).astype(np.float32)
            self._prev_done = done
            self._obs = nobs
            proc = self._f32(nobs)
        obs_buf[T] = proc
        steps = int(mask_buf.sum())
        self.counters["steps"] += steps
        RL_STATS["env_steps"] += steps
        self._seq += 1
        return {"obs": obs_buf, "actions": act_buf, "logp": logp_buf,
                "rewards": rew_buf, "terminateds": term_buf,
                "dones": done_buf, "mask": mask_buf,
                "runner": self.runner_index, "seq": self._seq,
                "steps": steps, "version": int(min_version)}

    # ------------------------------------------------------ streaming
    def start(self) -> str:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._stream, daemon=True,
                name=f"rtt-rl-runner{self.runner_index}")
            self._thread.start()
        return "started"

    def _stream(self) -> None:
        from ray_tpu_torch.experimental.channel import (ChannelClosed,
                                                        ChannelTimeout)
        while not self._stop.is_set():
            try:
                shard = self.collect_shard()
                # blocks while the learner lags > depth shards: this
                # backpressure IS the policy-staleness bound
                self._writer.write(
                    shard, timeout=self.config.write_timeout_s)
                self.counters["shards"] += 1
                RL_STATS["shards_written"] += 1
            except (ChannelClosed, ChannelTimeout) as e:
                self._stream_error = e
                return              # learner detached: stream is over
            except BaseException as e:   # noqa: BLE001
                self._stream_error = e
                return

    def stop(self) -> str:
        self._stop.set()
        # release BEFORE join: a writer blocked on acks wakes with
        # ChannelClosed instead of riding out its write timeout
        try:
            self._writer.release()
        except Exception:
            pass
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        try:
            self._envs.close()
        except Exception:
            pass
        return "stopped"
