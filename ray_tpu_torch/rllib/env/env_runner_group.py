"""EnvRunnerGroup: a fleet of SingleAgentEnvRunner actors.

Port of `ray_tpu/rllib/env/env_runner_group.py`, over the port's runtime.

Parity: reference rllib/env/env_runner_group.py:70 (sampling fan-out
:185 via FaultTolerantActorManager). num_env_runners=0 keeps a single
local runner in-process (the reference's local-worker debug mode and
the right choice for cheap envs where actor RPC would dominate).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env.env_runner import (EnvRunnerConfig,
                                                SingleAgentEnvRunner)


class EnvRunnerGroup:
    def __init__(self, config: EnvRunnerConfig, num_env_runners: int = 0,
                 num_cpus_per_runner: float = 1.0,
                 restart_failed_env_runners: bool = True):
        self.config = config
        self._local: Optional[SingleAgentEnvRunner] = None
        self._manager = None
        if num_env_runners == 0:
            self._local = SingleAgentEnvRunner(config, worker_index=0)
        else:
            import ray_tpu_torch
            from ray_tpu_torch.rllib.actor_manager import (
                FaultTolerantActorManager)

            remote_cls = ray_tpu_torch.remote(num_cpus=num_cpus_per_runner)(
                SingleAgentEnvRunner)

            def factory(idx: int):
                return remote_cls.remote(config, worker_index=idx + 1)

            actors = [factory(i) for i in range(num_env_runners)]
            self._manager = FaultTolerantActorManager(
                actors,
                actor_factory=(factory if restart_failed_env_runners
                               else None))

    @property
    def num_healthy_env_runners(self) -> int:
        if self._local is not None:
            return 1
        return self._manager.num_healthy_actors

    @property
    def manager(self):
        return self._manager

    # -------------------------------------------------------- actions
    def sample(self) -> List[Dict[str, np.ndarray]]:
        """One rollout from every healthy runner (synchronous parallel
        sample, reference ppo.py:425 synchronous_parallel_sample)."""
        if self._local is not None:
            return [self._local.sample()]
        results = self._manager.foreach_actor("sample")
        batches = results.values()
        if not batches:
            raise RuntimeError("no healthy env runners produced samples")
        return batches

    def sync_weights(self, weights) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            import ray_tpu_torch
            ref = ray_tpu_torch.put(weights)   # ship once, fan out the ref
            self._manager.foreach_actor("set_weights", args=(ref,))

    def aggregate_metrics(self) -> Dict[str, float]:
        if self._local is not None:
            return self._local.get_metrics()
        per = self._manager.foreach_actor("get_metrics").values()
        if not per:
            return {}
        returns = [m["episode_return_mean"] for m in per
                   if m["num_episodes"] > 0]
        lens = [m["episode_len_mean"] for m in per
                if m["num_episodes"] > 0]
        return {
            "episode_return_mean": (float(np.mean(returns)) if returns
                                    else float("nan")),
            "episode_len_mean": (float(np.mean(lens)) if lens
                                 else float("nan")),
            "num_episodes": int(sum(m["num_episodes"] for m in per)),
            "num_env_steps_sampled": int(
                sum(m["num_env_steps_sampled"] for m in per)),
        }

    def probe_unhealthy_env_runners(self) -> List[int]:
        if self._manager is None:
            return []
        return self._manager.probe_unhealthy_actors()

    def stop(self) -> None:
        if self._local is not None:
            self._local.stop()
        elif self._manager is not None:
            import ray_tpu_torch
            self._manager.foreach_actor("stop", timeout_seconds=5.0)
            for actor in self._manager.actors().values():
                try:
                    ray_tpu_torch.kill(actor)
                except BaseException:
                    pass
