"""Fault-tolerant manager for a fleet of ray_tpu_torch actors.

Port of `ray_tpu/rllib/actor_manager.py`, copied over the port's
runtime and exceptions.

Parity: reference rllib/utils/actor_manager.py (FaultTolerantActorManager
:198 — foreach_actor :396, foreach_actor_async :464,
fetch_ready_async_reqs :558, probe_unhealthy_actors :641). Small and
load-bearing: both the EnvRunnerGroup and the LearnerGroup drive their
actors through this, so individual actor deaths degrade throughput
instead of killing the algorithm.

Results come back as `RemoteCallResults`, a list of `CallResult`s that
either carry a value (`ok=True`) or the exception that felled the call.
Actors whose calls raise system errors (worker death) are marked
unhealthy and skipped until `probe_unhealthy_actors` restores them.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import ray_tpu_torch
from ray_tpu_torch.exceptions import (ActorDiedError,
                                      ActorUnavailableError,
                                      WorkerDiedError)

logger = logging.getLogger(__name__)

# Exception types that mean "the actor process is gone", as opposed to a
# user-code error that leaves the actor healthy. A get() timeout is NOT
# fatal: a slow-but-healthy actor (e.g. a long sample() under
# timeout_seconds) must keep its health, matching the reference manager.
_SYSTEM_ERRORS = (ActorDiedError, ActorUnavailableError, WorkerDiedError,
                  ConnectionError)


def _is_system_error(e: BaseException) -> bool:
    """Actor-death errors surface wrapped in TaskError at the get()
    site; classify by the CAUSE, not the wrapper (a user-code exception
    also arrives as a TaskError but leaves the actor healthy)."""
    from ray_tpu_torch.exceptions import GetTimeoutError, TaskError
    if isinstance(e, GetTimeoutError):
        return False
    if isinstance(e, TaskError):
        cause = e.cause
        return cause is not None and isinstance(cause, _SYSTEM_ERRORS)
    return isinstance(e, _SYSTEM_ERRORS)


@dataclasses.dataclass
class CallResult:
    actor_id: int
    ok: bool
    value: Any = None
    error: Optional[BaseException] = None

    def get(self):
        if not self.ok:
            raise self.error
        return self.value


class RemoteCallResults(list):
    """List[CallResult] with convenience accessors."""

    def ignore_errors(self) -> List[CallResult]:
        return [r for r in self if r.ok]

    def values(self) -> List[Any]:
        return [r.value for r in self if r.ok]

    @property
    def num_errors(self) -> int:
        return sum(0 if r.ok else 1 for r in self)


@dataclasses.dataclass
class _ActorState:
    actor: Any
    healthy: bool = True
    num_restarts: int = 0


@dataclasses.dataclass
class _InflightReq:
    actor_id: int
    ref: Any
    tag: Optional[str]
    submitted_at: float


class FaultTolerantActorManager:
    """Sync/async RPC fan-out over actors with health tracking.

    `actor_factory`, when given, lets `probe_unhealthy_actors(restore=
    True)` replace dead actors wholesale (the analogue of the
    reference's restart-under-same-handle flow: the runtime restarts
    actors via max_restarts; the factory path covers actors created
    without restarts or killed past their budget).
    """

    def __init__(self, actors: Optional[Sequence[Any]] = None,
                 max_remote_requests_in_flight_per_actor: int = 2,
                 actor_factory: Optional[Callable[[int], Any]] = None):
        self._states: Dict[int, _ActorState] = {}
        self._next_id = 0
        self._max_in_flight = max_remote_requests_in_flight_per_actor
        self._in_flight: List[_InflightReq] = []
        self._factory = actor_factory
        for a in actors or []:
            self.add_actor(a)

    # ----------------------------------------------------------- fleet
    def add_actor(self, actor: Any) -> int:
        aid = self._next_id
        self._next_id += 1
        self._states[aid] = _ActorState(actor)
        return aid

    def remove_actor(self, actor_id: int) -> Any:
        st = self._states.pop(actor_id)
        self._in_flight = [r for r in self._in_flight
                           if r.actor_id != actor_id]
        return st.actor

    @property
    def num_actors(self) -> int:
        return len(self._states)

    @property
    def num_healthy_actors(self) -> int:
        return sum(1 for s in self._states.values() if s.healthy)

    def healthy_actor_ids(self) -> List[int]:
        return [a for a, s in self._states.items() if s.healthy]

    def actors(self) -> Dict[int, Any]:
        return {a: s.actor for a, s in self._states.items()}

    def actor(self, actor_id: int) -> Any:
        return self._states[actor_id].actor

    # ------------------------------------------------------------ sync
    def foreach_actor(self, fn_or_name, *, args: Sequence = (),
                      kwargs: Optional[dict] = None,
                      healthy_only: bool = True,
                      remote_actor_ids: Optional[Sequence[int]] = None,
                      timeout_seconds: Optional[float] = None
                      ) -> RemoteCallResults:
        """Call `fn_or_name` on each actor and wait for all results.

        `fn_or_name` is either a method name (str) or a callable applied
        to the actor handle via its `apply` method when present, else
        called as `fn(actor_handle)` driver-side to build the ref.
        """
        ids = self._target_ids(healthy_only, remote_actor_ids)
        refs, ref_ids = [], []
        for aid in ids:
            ref = self._submit(aid, fn_or_name, args, kwargs or {})
            if ref is not None:
                refs.append(ref)
                ref_ids.append(aid)
        return self._collect(ref_ids, refs, timeout_seconds)

    # ----------------------------------------------------------- async
    def foreach_actor_async(self, fn_or_name, *, args: Sequence = (),
                            kwargs: Optional[dict] = None,
                            healthy_only: bool = True,
                            remote_actor_ids: Optional[Sequence[int]] = None,
                            tag: Optional[str] = None) -> int:
        """Fire-and-forget fan-out; results arrive via
        `fetch_ready_async_reqs`. Returns the number of calls actually
        submitted (actors at their in-flight cap are skipped — the
        reference does the same to provide backpressure)."""
        ids = self._target_ids(healthy_only, remote_actor_ids)
        n = 0
        for aid in ids:
            if self._in_flight_count(aid) >= self._max_in_flight:
                continue
            ref = self._submit(aid, fn_or_name, args, kwargs or {})
            if ref is not None:
                self._in_flight.append(
                    _InflightReq(aid, ref, tag, time.monotonic()))
                n += 1
        return n

    def fetch_ready_async_reqs(self, *, timeout_seconds: float = 0.0,
                               tags: Optional[Sequence[str]] = None
                               ) -> RemoteCallResults:
        """Collect whatever async results are ready right now."""
        pending = [r for r in self._in_flight
                   if tags is None or r.tag in tags]
        if not pending:
            return RemoteCallResults()
        ready, _ = ray_tpu_torch.wait(
            [r.ref for r in pending], num_returns=len(pending),
            timeout=timeout_seconds)
        ready_ids = {r.object_id for r in ready}
        done = [r for r in pending if r.ref.object_id in ready_ids]
        results = RemoteCallResults()
        for req in done:
            self._in_flight.remove(req)
            try:
                results.append(CallResult(
                    req.actor_id, True, ray_tpu_torch.get(req.ref, timeout=0.1)))
            except BaseException as e:
                if _is_system_error(e):
                    self._mark_unhealthy(req.actor_id, e)
                results.append(CallResult(req.actor_id, False, error=e))
        return results

    # ---------------------------------------------------------- health
    def probe_unhealthy_actors(self, timeout_seconds: float = 5.0,
                               mark_healthy: bool = True) -> List[int]:
        """Ping unhealthy actors; returns ids of those that came back.

        With an `actor_factory`, dead actors are replaced by fresh ones
        (the whole point: the group keeps its width)."""
        restored = []
        for aid, st in list(self._states.items()):
            if st.healthy:
                continue
            try:
                ray_tpu_torch.get(st.actor.ping.remote(),
                                  timeout=timeout_seconds)
                if mark_healthy:
                    st.healthy = True
                restored.append(aid)
            except BaseException:
                if self._factory is not None:
                    try:
                        st.actor = self._factory(aid)
                        st.healthy = True
                        st.num_restarts += 1
                        restored.append(aid)
                    except BaseException as e:
                        logger.warning("factory failed for actor %s: %s",
                                       aid, e)
        return restored

    def clear(self) -> None:
        """Kill every managed actor and forget the fleet (reference
        manager's clear()). Groups call this from their stop()."""
        for st in self._states.values():
            try:
                ray_tpu_torch.kill(st.actor)
            except BaseException:
                pass
        self._states.clear()
        self._in_flight.clear()

    def set_actor_state(self, actor_id: int, healthy: bool) -> None:
        self._states[actor_id].healthy = healthy

    def is_actor_healthy(self, actor_id: int) -> bool:
        return self._states[actor_id].healthy

    # -------------------------------------------------------- internal
    def _target_ids(self, healthy_only, remote_actor_ids) -> List[int]:
        ids = (list(remote_actor_ids) if remote_actor_ids is not None
               else list(self._states))
        if healthy_only:
            ids = [a for a in ids if self._states[a].healthy]
        return ids

    def _in_flight_count(self, actor_id: int) -> int:
        return sum(1 for r in self._in_flight if r.actor_id == actor_id)

    def num_in_flight(self, actor_id: Optional[int] = None,
                      tag: Optional[str] = None) -> int:
        """Outstanding async requests, filterable by actor and tag
        (drivers of perpetual-sampling loops use this to keep every
        actor saturated, e.g. IMPALA's pump)."""
        return sum(1 for r in self._in_flight
                   if (actor_id is None or r.actor_id == actor_id)
                   and (tag is None or r.tag == tag))

    def _submit(self, aid: int, fn_or_name, args, kwargs):
        actor = self._states[aid].actor
        try:
            if isinstance(fn_or_name, str):
                return getattr(actor, fn_or_name).remote(*args, **kwargs)
            if hasattr(actor, "apply"):
                return actor.apply.remote(fn_or_name, *args, **kwargs)
            return fn_or_name(actor, *args, **kwargs)
        except BaseException as e:
            if not _is_system_error(e):
                raise
            self._mark_unhealthy(aid, e)
            return None

    def _collect(self, ref_ids, refs, timeout) -> RemoteCallResults:
        results = RemoteCallResults()
        for aid, ref in zip(ref_ids, refs):
            try:
                results.append(CallResult(
                    aid, True, ray_tpu_torch.get(ref, timeout=timeout)))
            except BaseException as e:
                if _is_system_error(e):
                    self._mark_unhealthy(aid, e)
                results.append(CallResult(aid, False, error=e))
        return results

    def _mark_unhealthy(self, aid: int, err: BaseException) -> None:
        if self._states[aid].healthy:
            logger.warning("actor %s marked unhealthy: %r", aid, err)
        self._states[aid].healthy = False
