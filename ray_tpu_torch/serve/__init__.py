"""ray_tpu_torch.serve: model serving on the port's actor runtime.

Port of `ray_tpu/serve/__init__.py`, complete: the controller, replicas,
handles, autoscaling, the HTTP and gRPC ingress. Two differences: the
controller hands each replica the deployment's pickled class and the
replica unpickles it, so the controller's worker never imports the
class's module (an `LLMEngine` deployment's imports torch); and a
replica that has not reported yet is judged by its actor's state too:
the 30 s grace for its first report counts from the last time its
constructor was seen running (a llama3-8b replica's takes longer than
the grace), and it goes at once if it died first (ROADMAP queue 3,
item 7).

Parity (shape, not scale) with reference python/ray/serve:
- `@serve.deployment` + `.bind()` + `serve.run`  <- serve/api.py:491
- ServeController actor reconciling replica sets <- _private/controller.py:84,
  deployment_state.py (replica FSM: start, health-check, restart, scale)
- DeploymentHandle with power-of-two-choices routing on outstanding
  requests                                       <- _private/router.py:315
- optional HTTP ingress (JSON over POST)         <- _private/proxy.py

Re-designed for this stack: the controller is one actor owning replica
actors; handles route client-side (each handle tracks its own in-flight
counts — the reference router does the same per-handle since 2.x);
replicas execute with max_concurrency = max_ongoing_requests.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch

_CONTROLLER_NAME = "_rtpu_serve_controller"


# ------------------------------------------------------------ replica
_STREAM_IDLE_TTL_S = 300.0
_STREAM_END = ("__rtpu_stream__", "end")   # out-of-band marker


@dataclasses.dataclass
class _BoundHandle:
    """Placeholder for a bound sub-deployment inside a deployment's init
    args: resolved to a live DeploymentHandle inside the replica at
    construction (reference deployment-graph handle injection,
    deployment_state.py:1245 + handle.py handle-passing)."""
    name: str


def _resolve_bound(value, controller_name: str):
    """Swap _BoundHandle markers (top level or nested one container
    deep) for live handles."""
    if isinstance(value, _BoundHandle):
        import ray_tpu_torch
        return DeploymentHandle(value.name,
                                ray_tpu_torch.get_actor(controller_name))
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve_bound(v, controller_name)
                           for v in value)
    if isinstance(value, dict):
        return {k: _resolve_bound(v, controller_name)
                for k, v in value.items()}
    return value


class _StreamState:
    """A parked generator with a producer thread filling a bounded
    buffer. Decouples production from consumption so `next_chunk` can
    return whatever is ready (possibly nothing) instead of blocking
    the replica's request slot inside `next(gen)` until a full batch
    materializes — the consumer decides how to pace a dry stream."""

    _BUF_CAP = 256

    def __init__(self, gen):
        self._gen = gen
        self._buf: List[Any] = []
        self._cond = threading.Condition()
        self._done = False
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._produce,
                                        daemon=True,
                                        name="serve-stream-producer")
        self._thread.start()

    def _produce(self) -> None:
        try:
            for item in self._gen:
                with self._cond:
                    while (len(self._buf) >= self._BUF_CAP
                           and not self._closed):
                        self._cond.wait(0.1)
                    if self._closed:
                        return
                    self._buf.append(item)
                    self._cond.notify_all()
        except BaseException as e:        # surfaced on next pull
            with self._cond:
                self._exc = e
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()

    def pull(self, n: int, wait_s: Optional[float]) -> List[Any]:
        """Up to n buffered chunks. wait_s=None: legacy blocking pull
        (park until n chunks or the generator ends); else wait at most
        wait_s for the FIRST chunk and return what's there — an empty
        list means "dry, poll again", never end-of-stream (the
        sentinel says that)."""
        with self._cond:
            if wait_s is None:
                while len(self._buf) < n and not self._done:
                    self._cond.wait()
            elif not self._buf and not self._done:
                self._cond.wait(wait_s)
            out = self._buf[:n]
            del self._buf[:len(out)]
            if self._exc is not None and not out and not self._buf:
                exc, self._exc = self._exc, None
                raise exc
            if (self._done and self._exc is None and not self._buf
                    and len(out) < n):
                out.append(_STREAM_END)
            self._cond.notify_all()
            return out

    @property
    def finished(self) -> bool:
        with self._cond:
            return self._done and not self._buf

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        try:
            self._gen.close()
        except BaseException:
            pass


class _Replica:
    """Actor wrapping one instance of the user's deployment class.

    Tracks its own ongoing-request count (the autoscaling signal the
    reference's replicas report, _private/replica.py num_ongoing) and
    holds generator state for streaming responses: a generator result is
    parked under a stream id and pulled chunk-by-chunk via next_chunk
    (the reference streams over gRPC/ASGI; here the ordered actor queue
    is the transport)."""

    def __init__(self, cls_or_fn, init_args, init_kwargs,
                 deployment: str = "", replica_id: str = "",
                 controller_name: str = "",
                 report_period_s: float = 0.5):
        if isinstance(cls_or_fn, bytes):     # the deployment's pickle
            import cloudpickle
            cls_or_fn = cloudpickle.loads(cls_or_fn)
        if controller_name:
            init_args = _resolve_bound(tuple(init_args), controller_name)
            init_kwargs = _resolve_bound(dict(init_kwargs),
                                         controller_name)
        if isinstance(cls_or_fn, type):
            self._obj = cls_or_fn(*init_args, **init_kwargs)
        else:
            self._obj = cls_or_fn       # function deployment
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        self._streams: Dict[str, tuple] = {}   # sid -> (gen, last_used)
        # Replica-PUSHED stats (reference _private/replica.py metrics
        # push): a probe through the actor's request queue would starve
        # behind saturated user calls — exactly when autoscaling needs
        # the signal most — so a side thread reports ongoing counts to
        # the controller instead, doubling as the liveness signal.
        self._stop_report = threading.Event()
        if deployment and controller_name:
            threading.Thread(
                target=self._report_loop,
                args=(deployment, replica_id, controller_name,
                      report_period_s),
                daemon=True, name="replica-report").start()

    def _report_loop(self, deployment: str, rid: str,
                     controller_name: str, period: float) -> None:
        import ray_tpu_torch
        controller = None
        check = getattr(self._obj, "check_health", None)
        while not self._stop_report.wait(period):
            if check is not None:
                try:
                    check()
                except BaseException:
                    # unhealthy (Ray Serve's `check_health` contract):
                    # silent from now on, so the controller presumes the
                    # replica dead, kills it and starts another
                    return
            try:
                if controller is None:
                    controller = ray_tpu_torch.get_actor(controller_name)
                with self._lock:
                    self._sweep_streams()
                    ongoing = self._ongoing + len(self._streams)
                # deployment-defined extras ride the existing report
                # (r11 signal path): e.g. the LLM engine's queue-wait
                # p95 reaches the autoscaler with zero extra RPCs
                extra = None
                hook = getattr(self._obj, "__serve_stats__", None)
                if hook is not None:
                    try:
                        extra = hook()
                    except BaseException:
                        extra = None
                controller.report_stats.remote(deployment, rid, ongoing,
                                               extra)
            except BaseException:
                controller = None

    def ping(self):
        return "pong"

    def stats(self) -> dict:
        with self._lock:
            self._sweep_streams()
            return {"ongoing": self._ongoing + len(self._streams),
                    "total": self._total}

    def close_stream(self, sid: str) -> None:
        """Early-exit consumers retire their parked generator so it
        stops counting as ongoing (autoscaling signal) immediately."""
        with self._lock:
            entry = self._streams.pop(sid, None)
        if entry is not None:
            entry[0].close()

    def handle_request(self, method: str, args, kwargs,
                       wants_stream: bool = False):
        import inspect
        import uuid
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            if method == "__call__":
                result = self._obj(*args, **kwargs)
            else:
                result = getattr(self._obj, method)(*args, **kwargs)
            if inspect.isgenerator(result):
                if not wants_stream:
                    # plain .remote() on a generator method: drain it
                    # (never leak the internal stream handshake)
                    return list(result)
                sid = uuid.uuid4().hex[:12]
                with self._lock:
                    self._sweep_streams()
                    self._streams[sid] = (_StreamState(result),
                                          time.monotonic())
                return ("__stream__", sid)
            return result
        finally:
            with self._lock:
                self._ongoing -= 1

    def next_chunk(self, sid: str, n: int = 1,
                   wait_s: Optional[float] = None):
        """Pull up to n buffered chunks from a parked stream; the
        sentinel tuple terminates (and retires) it. With `wait_s`, a
        dry stream returns [] after at most that long instead of
        parking the request slot (the adaptive client backs off)."""
        with self._lock:
            entry = self._streams.get(sid)
        if entry is None:
            # swept (idle TTL) or never existed: error, never a silent
            # truncation indistinguishable from completion
            raise RuntimeError(
                f"stream {sid!r} expired or unknown on this replica")
        state, _ = entry
        try:
            out = state.pull(n, wait_s)
        except BaseException:
            with self._lock:
                self._streams.pop(sid, None)
            raise
        if out and isinstance(out[-1], tuple) and out[-1] == _STREAM_END:
            with self._lock:
                self._streams.pop(sid, None)
            return out
        with self._lock:
            if sid in self._streams:
                self._streams[sid] = (state, time.monotonic())
        return out

    def _sweep_streams(self) -> None:     # caller holds _lock
        now = time.monotonic()
        dead = [s for s, (_, t) in self._streams.items()
                if now - t > _STREAM_IDLE_TTL_S]
        for s in dead:
            entry = self._streams.pop(s, None)
            if entry is not None:
                entry[0].close()


@dataclasses.dataclass
class AutoscalingConfig:
    """Reference serve/config.py AutoscalingConfig /
    _private/autoscaling_state.py: desired = ceil(total_ongoing /
    target_ongoing_requests), clamped to [min, max]; a scale decision
    must hold continuously for its delay before it applies."""
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    # queue-latency scale-up (r11 signal): when any replica reports a
    # queue_wait_p95 (via __serve_stats__) above this, desire one more
    # replica than we have, regardless of the ongoing-count ratio.
    # 0 disables.
    target_queue_latency_s: float = 0.0

    def clamp(self, n: int) -> int:
        return max(self.min_replicas, min(self.max_replicas, n))


@dataclasses.dataclass
class _DeploymentInfo:
    name: str
    cls_bytes: bytes
    init_args: tuple
    init_kwargs: dict
    num_replicas: int
    max_ongoing_requests: int
    ray_actor_options: dict
    autoscaling_config: Optional[AutoscalingConfig] = None


class ServeController:
    """Owns deployment -> replica-set state; reconciles continuously
    (reference deployment_state DeploymentStateManager.update loop)."""

    # Presumed-dead threshold: generous enough that a replica whose
    # report thread is starved by a long GIL-holding call (first-request
    # jit compile) isn't misdeclared dead.
    _REPORT_TTL_S = 10.0
    _STARTUP_GRACE_S = 30.0  # time for a new replica's first report
    _DRAIN_CAP_S = 30.0      # max wait for a victim to finish requests
    # a busy replica gets extra silence allowance before the liveness
    # kill (a long GIL-holding native call in its handler blocks the
    # report thread while requests are genuinely in flight)
    _BUSY_TTL_S = 60.0

    def __init__(self):
        self._deployments: Dict[str, _DeploymentInfo] = {}
        # application table: app name -> {route_prefix, ingress,
        # deployments} (reference serve multi-app: one controller owns
        # many independent deployment graphs, api.py serve.run(name=...))
        self._apps: Dict[str, dict] = {}
        # name -> [(replica_id, handle, created_monotonic), ...]
        self._replicas: Dict[str, List[Any]] = {}
        # (name, replica_id) -> (ongoing, reported_monotonic)
        self._reports: Dict[tuple, tuple] = {}
        # (name, replica_id) -> deployment-defined extra stats dict
        self._extra_reports: Dict[tuple, dict] = {}
        # downscale victims draining in-flight requests:
        # name -> [(replica_id, handle, deadline_monotonic), ...]
        self._draining: Dict[str, List[Any]] = {}
        self._targets: Dict[str, int] = {}       # autoscaled target
        # autoscale hysteresis: name -> (direction, desired, since)
        self._scale_intent: Dict[str, tuple] = {}
        self._last_ongoing: Dict[str, int] = {}
        self._lock = threading.Lock()
        # serializes whole reconcile passes (deploy() RPCs race the
        # 1 Hz loop thread under the actor's max_concurrency)
        self._reconcile_lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True)
        self._thread.start()

    def ping(self):
        return "pong"

    # ------------------------------------------------------ deploy api
    def deploy(self, info: _DeploymentInfo) -> None:
        with self._lock:
            self._deployments[info.name] = info
            ac = info.autoscaling_config
            self._targets[info.name] = (
                ac.clamp(info.num_replicas) if ac else info.num_replicas)
            self._scale_intent.pop(info.name, None)
        self._reconcile_once()

    def report_stats(self, name: str, replica_id: str,
                     ongoing: int, extra: Optional[dict] = None) -> None:
        """Replica-pushed ongoing count; doubles as liveness. `extra`
        carries deployment-defined signals (queue_wait_p95, ...)."""
        with self._lock:
            self._reports[(name, replica_id)] = (int(ongoing),
                                                 time.monotonic())
            if extra:
                self._extra_reports[(name, replica_id)] = dict(extra)

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            self._deployments.pop(name, None)
            replicas = self._replicas.pop(name, [])
            replicas += [(rid, r, 0.0) for rid, r, _d
                         in self._draining.pop(name, [])]
            for key in [k for k in self._reports if k[0] == name]:
                self._reports.pop(key, None)
            for key in [k for k in self._extra_reports
                        if k[0] == name]:
                self._extra_reports.pop(key, None)
        for _rid, r, _t in replicas:
            try:
                ray_tpu_torch.kill(r)
            except BaseException:
                pass
        self._publish_membership(name, [])

    # -------------------------------------------------- application api
    def _check_app(self, name: str, route_prefix: str,
                   deployments: List[str]) -> None:
        """Collision rules vs OTHER apps (call with self._lock held)."""
        for other, rec in self._apps.items():
            if other == name:
                continue
            if rec["route_prefix"] == route_prefix:
                raise ValueError(
                    f"route_prefix {route_prefix!r} is already "
                    f"taken by application {other!r}")
            clash = set(deployments) & set(rec["deployments"])
            if clash:
                raise ValueError(
                    f"deployment name(s) {sorted(clash)} already "
                    f"belong to application {other!r}; rename via "
                    f".options(name=...)")

    def deploy_application(self, name: str, route_prefix: str,
                           ingress: str,
                           infos: List[_DeploymentInfo]) -> None:
        """Atomically validate + register + deploy an application (a
        named deployment graph with an HTTP route prefix). The
        collision check and the app-table write happen under one lock,
        so two racing serve.run() calls cannot both pass validation and
        strand orphan deployments; deployments dropped by a redeploy
        are deleted. `infos` arrive children-first so handles resolve
        as replicas come up."""
        dep_names = [i.name for i in infos]
        with self._lock:
            self._check_app(name, route_prefix, dep_names)
            prev = self._apps.get(name)
            stale = ([d for d in prev["deployments"]
                      if d not in dep_names] if prev else [])
            self._apps[name] = {"route_prefix": route_prefix,
                                "ingress": ingress,
                                "deployments": list(dep_names)}
        for d in stale:
            self.delete_deployment(d)
        for info in infos:
            self.deploy(info)
        self._publish_routes()

    def delete_app(self, name: str) -> bool:
        with self._lock:
            rec = self._apps.pop(name, None)
        if rec is None:
            return False
        for d in rec["deployments"]:
            self.delete_deployment(d)
        self._publish_routes()
        return True

    def _publish_routes(self) -> None:
        """Push the application route table to the HTTP proxy over the
        control-plane pubsub (reference long_poll.py route-table push)
        so routing reflects deploys/deletes immediately instead of on a
        poll interval."""
        with self._lock:
            routes = {n: {"route_prefix": rec["route_prefix"],
                          "ingress": rec["ingress"]}
                      for n, rec in self._apps.items()}
        _publish("serve:routes", {"routes": routes, "ts": time.time()})

    def list_applications(self) -> Dict[str, dict]:
        deps = self.list_deployments()
        with self._lock:
            return {n: {"route_prefix": rec["route_prefix"],
                        "ingress": rec["ingress"],
                        "deployments": {d: deps.get(d, {})
                                        for d in rec["deployments"]}}
                    for n, rec in self._apps.items()}

    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            if name not in self._deployments:
                raise ValueError(f"no deployment named {name!r}")
            return [r for _rid, r, _t in self._replicas.get(name, [])]

    def list_deployments(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"num_replicas": d.num_replicas,
                        "target_replicas": self._targets.get(
                            n, d.num_replicas),
                        "live_replicas": len(self._replicas.get(n, [])),
                        "ongoing_requests": self._last_ongoing.get(n, 0),
                        "autoscaling": d.autoscaling_config is not None}
                    for n, d in self._deployments.items()}

    def shutdown(self) -> None:
        self._running = False
        with self._lock:
            self._apps.clear()
        for name in list(self._deployments):
            self.delete_deployment(name)

    # ------------------------------------------------------- reconcile
    def _reconcile_loop(self) -> None:
        while self._running:
            try:
                self._reconcile_once()
            except BaseException:
                pass
            time.sleep(1.0)

    def _reconcile_once(self) -> None:
        with self._lock:
            items = list(self._deployments.items())
        with self._reconcile_lock:
            self._reconcile_items(items)

    def _reconcile_items(self, items) -> None:
        import uuid
        now = time.monotonic()
        for name, info in items:
            live, ongoing = [], 0   # live: (rid, handle, created, ongoing)
            with self._lock:
                current = list(self._replicas.get(name, []))
                reports = {rid: self._reports.get((name, rid))
                           for rid, _r, _t in current}
            # a replica with no report yet: the runtime says whether its
            # constructor still runs (a large model's takes longer than
            # the grace) or whether it died before its first report
            states = (_actor_states() if None in reports.values()
                      else {})
            for rid, r, created in current:
                rep = reports.get(rid)
                state = states.get(r._actor_id)
                if rep is not None and now - rep[1] < self._REPORT_TTL_S:
                    live.append((rid, r, created, rep[0]))
                    ongoing += rep[0]
                elif rep is None and state in ("PENDING_CREATION",
                                               "RESTARTING"):
                    # its constructor still runs: the grace for its
                    # first report counts from now
                    live.append((rid, r, now, 0))
                elif (rep is None and state != "DEAD"
                        and now - created < self._STARTUP_GRACE_S):
                    live.append((rid, r, created, 0))   # still starting
                elif (rep is not None and rep[0] > 0
                        and now - rep[1] < self._BUSY_TTL_S):
                    # silent but last seen busy: its report thread may
                    # be starved by a long native call in the handler —
                    # extend grace instead of failing in-flight work
                    live.append((rid, r, created, rep[0]))
                    ongoing += rep[0]
                else:
                    # silent past TTL: presumed dead. KILL before
                    # dropping — if the presumption was wrong (replica
                    # wedged, not dead) an untracked live actor would
                    # leak its resources forever.
                    try:
                        ray_tpu_torch.kill(r)
                    except BaseException:
                        pass
                    with self._lock:
                        self._reports.pop((name, rid), None)
                        self._extra_reports.pop((name, rid), None)
            with self._lock:
                self._last_ongoing[name] = ongoing
            target = self._autoscale(name, info, len(live), ongoing)
            while len(live) < target:
                opts = dict(info.ray_actor_options)
                opts["max_concurrency"] = info.max_ongoing_requests
                rid = uuid.uuid4().hex[:8]
                actor = ray_tpu_torch.remote(**opts)(_Replica).remote(
                    info.cls_bytes, info.init_args, info.init_kwargs,
                    deployment=name, replica_id=rid,
                    controller_name=_CONTROLLER_NAME)
                live.append((rid, actor, time.monotonic(), 0))
            if len(live) > target:
                # evict the idlest replicas first, and DRAIN instead of
                # kill: a victim leaves routing immediately (dropped
                # from _replicas below) but is only killed once its
                # reported ongoing count reaches 0 or the drain cap
                # expires — in-flight requests and parked streams finish
                # (reference drains gracefully before stopping)
                live.sort(key=lambda rn: rn[3], reverse=True)
                while len(live) > target:
                    rid, victim, _c, _n = live.pop()
                    with self._lock:
                        if name in self._deployments:
                            self._draining.setdefault(name, []).append(
                                (rid, victim, now + self._DRAIN_CAP_S))
                            victim = None
                    if victim is not None:
                        # deployment was deleted under us: nothing will
                        # ever sweep this drain entry — kill inline
                        try:
                            ray_tpu_torch.kill(victim)
                        except BaseException:
                            pass
            with self._lock:
                before = [rid for rid, _r, _c in
                          self._replicas.get(name, [])]
                self._replicas[name] = [(rid, r, c)
                                        for rid, r, c, _n in live]
                after = [rid for rid, _r, _c, _n in live]
            if before != after:
                self._publish_membership(name, after)
            self._sweep_draining(name, now)

    def _publish_membership(self, name: str, rids: List[str]) -> None:
        """Push the replica-set change to subscribed handles over the
        control-plane pubsub (reference long_poll.py config push) —
        handles refresh on the push instead of polling."""
        _publish(f"serve:{name}", {"deployment": name, "replicas": rids,
                                   "ts": time.time()})

    def _sweep_draining(self, name: str, now: float) -> None:
        """Kill drain victims that finished their in-flight work (or hit
        the drain cap / stopped reporting)."""
        with self._lock:
            draining = list(self._draining.get(name, []))
        keep = []
        for rid, victim, deadline in draining:
            with self._lock:
                rep = self._reports.get((name, rid))
            # NO silence-based kill here: a victim mid-native-call stops
            # reporting while genuinely busy; the drain cap bounds it
            done = now >= deadline or rep is None or rep[0] == 0
            if done:
                try:
                    ray_tpu_torch.kill(victim)
                except BaseException:
                    pass
                with self._lock:
                    self._reports.pop((name, rid), None)
                    self._extra_reports.pop((name, rid), None)
            else:
                keep.append((rid, victim, deadline))
        with self._lock:
            if keep:
                self._draining[name] = keep
            else:
                self._draining.pop(name, None)

    def _autoscale(self, name: str, info: _DeploymentInfo,
                   current: int, ongoing: int) -> int:
        """Desired-replica decision with up/down hysteresis (reference
        autoscaling_state.py get_decision_num_replicas)."""
        ac = info.autoscaling_config
        if ac is None:
            return info.num_replicas
        import math
        with self._lock:
            target = self._targets.get(name, ac.clamp(info.num_replicas))
            desired = ac.clamp(
                math.ceil(ongoing / max(ac.target_ongoing_requests,
                                        1e-9)))
            if ac.target_queue_latency_s > 0:
                # r11 latency signal: queue_wait_p95 pushed by the
                # replicas' __serve_stats__ hook. Latency over target
                # means the ongoing-count ratio is lying (requests are
                # cheap to hold but slow to admit — LLM engines), so
                # desire one more replica than we have.
                qlat = max((float(e.get("queue_wait_p95", 0.0) or 0.0)
                            for k, e in self._extra_reports.items()
                            if k[0] == name), default=0.0)
                if qlat > ac.target_queue_latency_s:
                    desired = max(desired, ac.clamp(current + 1))
            now = time.monotonic()
            if desired == target:
                self._scale_intent.pop(name, None)
                return target
            direction = "up" if desired > target else "down"
            intent = self._scale_intent.get(name)
            if intent is None or intent[0] != direction:
                self._scale_intent[name] = (direction, desired, now)
                return target
            _, _, since = intent
            delay = (ac.upscale_delay_s if direction == "up"
                     else ac.downscale_delay_s)
            # keep the most recent desired value while waiting
            self._scale_intent[name] = (direction, desired, since)
            if now - since >= delay:
                self._targets[name] = desired
                self._scale_intent.pop(name, None)
                return desired
            return target


# ------------------------------------------------------------- handle
class DeploymentHandle:
    """Client-side router: power-of-two-choices on this handle's
    outstanding-request counts (reference router.py:315)."""

    def __init__(self, name: str, controller):
        self._name = name
        self._controller = controller
        self._replicas: List[Any] = []
        # idx -> weakrefs of pending ObjectRefs. Weak so an idle handle
        # never pins results: once the caller drops a result ref, it
        # stops counting as (and stops being kept) in flight.
        self._inflight: Dict[int, List[Any]] = {}
        self._refreshed = 0.0
        self._rng = __import__("random").Random(id(self) & 0xffff)
        self._watch_started = False
        self._watch_lock = threading.Lock()

    # handles cross process boundaries (composition, tasks): runtime
    # state (watch thread, inflight weakrefs) never travels
    def __getstate__(self):
        return {"name": self._name, "controller": self._controller}

    def __setstate__(self, state):
        self.__init__(state["name"], state["controller"])

    def _ensure_watch(self) -> None:
        """Long-poll membership push (reference long_poll.py): a daemon
        thread parks on the `serve:<name>` pubsub channel and refreshes
        the replica list the moment the controller publishes a change —
        the TTL poll in _refresh becomes a slow fallback."""
        if self._watch_started:
            return
        with self._watch_lock:
            if self._watch_started:
                return
            self._watch_started = True
        import weakref
        threading.Thread(
            target=_handle_watch_loop,
            args=(weakref.ref(self), self._name),
            name=f"serve-watch-{self._name}", daemon=True).start()

    def _refresh(self, force: bool = False) -> None:
        if not force and time.time() - self._refreshed < 30.0:
            return
        self._replicas = ray_tpu_torch.get(
            self._controller.get_replicas.remote(self._name))
        self._inflight = {i: self._inflight.get(i, [])
                          for i in range(len(self._replicas))}
        self._refreshed = time.time()

    def _drain_done(self) -> None:
        """Opportunistically drop refs that have resolved (or were
        dropped by the caller) so in-flight counts reflect genuinely
        outstanding requests (not just submission concurrency within
        one tick)."""
        import weakref as _wr
        for idx, wrefs in list(self._inflight.items()):
            if not wrefs:
                continue
            live = [(w, w()) for w in wrefs]
            refs = [r for _, r in live if r is not None]
            done = set()
            if refs:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                              timeout=0)
                done = {id(r) for r in ready}
            self._inflight[idx] = [w for w, r in live
                                   if r is not None and id(r) not in done]

    def _pick(self, n: int) -> int:
        if n == 1:
            return 0
        a, b = self._rng.sample(range(n), 2)
        inflight = self._inflight
        return (a if len(inflight.get(a, ()))
                <= len(inflight.get(b, ())) else b)

    def inflight_count(self) -> int:
        """Outstanding requests on this handle (autoscaling signal)."""
        self._drain_done()
        return sum(len(v) for v in self._inflight.values())

    def remote(self, *args, **kwargs):
        return self.method("__call__", *args, **kwargs)

    def method(self, method_name: str, *args, **kwargs):
        ref, _ = self._route(method_name, args, kwargs)
        return ref

    def _route(self, method_name: str, args, kwargs,
               wants_stream: bool = False):
        self._ensure_watch()
        self._refresh()
        # SNAPSHOT the replica list: the watch thread swaps
        # self._replicas/_inflight on membership pushes, and indexing
        # the live attributes after a swap would IndexError mid-request
        reps = self._replicas
        if not reps:
            self._refresh(force=True)
            reps = self._replicas
            if not reps:
                raise RuntimeError(
                    f"deployment {self._name!r} has no live replicas")
        self._drain_done()
        idx = self._pick(len(reps))
        replica = reps[idx]
        ref = replica.handle_request.remote(method_name, args, kwargs,
                                            wants_stream)
        import weakref as _wr
        self._inflight.setdefault(idx, []).append(_wr.ref(ref))
        return ref, replica

    def stream(self, *args, method_name: str = "__call__",
               chunk_batch: int = 4, **kwargs):
        """Call a generator deployment method; yields its chunks as they
        are produced (reference streaming DeploymentResponseGenerator).
        All pulls pin the replica that holds the generator state.

        Pull pacing is adaptive, not a fixed `chunk_batch` spin: each
        pull asks for the current batch and parks server-side up to a
        short wait. A full batch doubles the next ask (a fast producer
        gets fewer round-trips); a dry pull backs off exponentially
        (capped at 0.25 s) so a slow producer isn't hammered with empty
        RPCs — and the first chunk still arrives the moment it exists,
        never held for a full batch."""
        ref, replica = self._route(method_name, args, kwargs,
                                   wants_stream=True)
        first = ray_tpu_torch.get(ref)
        if not (isinstance(first, tuple) and len(first) == 2
                and first[0] == "__stream__"):
            # non-generator result: single-chunk stream
            yield first
            return
        sid = first[1]
        finished = False
        batch = max(1, int(chunk_batch))
        backoff = 0.0
        try:
            while True:
                chunks = ray_tpu_torch.get(
                    replica.next_chunk.remote(sid, batch, wait_s=0.05))
                if not chunks:
                    backoff = min(0.25, (backoff or 0.01) * 2)
                    time.sleep(backoff)
                    continue
                backoff = 0.0
                if len(chunks) >= batch:
                    batch = min(batch * 2, 64)
                for c in chunks:
                    if isinstance(c, tuple) and c == _STREAM_END:
                        finished = True
                        return
                    yield c
        finally:
            if not finished:
                # abandoned mid-stream: retire the parked generator now
                try:
                    replica.close_stream.remote(sid)
                except BaseException:
                    pass


def _actor_states() -> Dict[str, str]:
    """Actor id -> lifecycle state, from the head; empty when the head
    cannot say (the reconcile loop then falls back on the grace)."""
    try:
        from ray_tpu_torch._private import context as _c
        return {a["actor_id"]: a["state"]
                for a in _c.get_ctx().state_op("list_actors")}
    except Exception:
        return {}


def _publish(channel: str, message: dict) -> None:
    """Best-effort control-plane pubsub publish (reference
    long_poll.py's push side)."""
    try:
        from ray_tpu_torch._private import context as _c
        _c.get_ctx().state_op("pubsub_publish", channel=channel,
                              message=message)
    except BaseException:
        pass


def _watch_channel(channel: str, on_msgs, should_stop) -> None:
    """Shared long-poll watch skeleton (reference long_poll.py client
    loop): park on the channel, resync on StaleCursorError (the ring
    lapped us — treat as one coalesced notification), back off while
    the runtime is down or unreachable. Polls park HEAD-side in the
    publisher's waiter list (never on a connection reader)."""
    from ray_tpu_torch._private import context as _context
    from ray_tpu_torch._private.pubsub import StaleCursorError
    cursor = 0
    while not should_stop():
        ctx = _context.maybe_ctx()
        if ctx is None:
            # runtime down (or not up yet): keep the thread alive so a
            # re-init resumes pushes instead of silently degrading to
            # the slow fallback forever
            time.sleep(1.0)
            continue
        try:
            out = ctx.state_op("pubsub_poll", channel=channel,
                               cursor=cursor, timeout=15.0)
            msgs, cursor = out if out else ([], cursor)
        except StaleCursorError as e:
            cursor = getattr(e, "resync", 0)
            msgs = [None]
        except BaseException:
            time.sleep(1.0)
            continue
        if msgs and not should_stop():
            try:
                on_msgs(msgs)
            except BaseException:
                pass


def _handle_watch_loop(handle_ref, name: str) -> None:
    """Holds only a weakref to the handle: the handle stays collectable
    and the thread exits when it goes away."""
    def on_msgs(_msgs) -> None:
        h = handle_ref()
        if h is not None:
            h._refresh(force=True)

    _watch_channel(f"serve:{name}", on_msgs,
                   lambda: handle_ref() is None)


# ---------------------------------------------------------- user API
@dataclasses.dataclass
class Application:
    deployment: "Deployment"
    init_args: tuple
    init_kwargs: dict


class Deployment:
    def __init__(self, cls_or_fn, name: Optional[str] = None,
                 num_replicas: int = 1, max_ongoing_requests: int = 8,
                 ray_actor_options: Optional[dict] = None,
                 autoscaling_config: Optional[Any] = None):
        self._cls = cls_or_fn
        self.name = name or getattr(cls_or_fn, "__name__", "deployment")
        self.num_replicas = num_replicas
        self.max_ongoing_requests = max_ongoing_requests
        self.ray_actor_options = dict(ray_actor_options or {})
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        self.autoscaling_config = autoscaling_config

    def options(self, **kw) -> "Deployment":
        d = Deployment(self._cls, self.name, self.num_replicas,
                       self.max_ongoing_requests, self.ray_actor_options,
                       self.autoscaling_config)
        for k, v in kw.items():
            if not hasattr(d, k):
                raise ValueError(f"unknown deployment option {k!r}")
            if k == "autoscaling_config" and isinstance(v, dict):
                v = AutoscalingConfig(**v)
            setattr(d, k, v)
        return d

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(cls=None, **kwargs):
    """`@serve.deployment` / `@serve.deployment(num_replicas=...)`."""
    if cls is not None:
        return Deployment(cls)
    return lambda c: Deployment(c, **kwargs)


def _get_controller():
    return ray_tpu_torch.remote(max_concurrency=16)(
        ServeController).options(name=_CONTROLLER_NAME,
                                 get_if_exists=True).remote()


def run(app: Application, name: Optional[str] = None,
        route_prefix: Optional[str] = None) -> DeploymentHandle:
    """Deploy an application — including every bound sub-deployment in
    its init args — and return the top deployment's handle (reference
    serve.run, serve/api.py:491, with deployment-graph resolution:
    nested `.bind()`s become handles injected at replica init,
    deployment_state.py:1245 + handle.py).

    Multi-app (reference serve multi-application): `name` names the
    application (and its ingress deployment); apps coexist under one
    controller with independent lifecycles. `route_prefix` (default
    `/<name>`) routes HTTP ingress traffic to this app's ingress
    deployment by longest-prefix match."""
    import cloudpickle
    controller = _get_controller()
    ray_tpu_torch.get(controller.ping.remote())
    names: Dict[int, str] = {}           # id(Application) -> name

    # ---- phase 1: assign names + validate (no side effects, so a
    # refused app leaves no orphan deployments)
    def _walk(value):
        if isinstance(value, Application):
            _assign(value)
        elif isinstance(value, (list, tuple)):
            for v in value:
                _walk(v)
        elif isinstance(value, dict):
            for v in value.values():
                _walk(v)

    def _assign(a: Application, top_name: Optional[str] = None) -> None:
        if id(a) in names:               # diamond: shared child, once
            return
        dep_name = top_name or a.deployment.name
        if dep_name in names.values():
            # two DISTINCT binds under one name would silently clobber
            # each other (both handles routing to whichever deployed
            # last) — make the user disambiguate
            raise ValueError(
                f"deployment name {dep_name!r} is bound more than once "
                f"in this application graph; give each bind a distinct "
                f"name via .options(name=...)")
        names[id(a)] = dep_name
        for v in list(a.init_args) + list(a.init_kwargs.values()):
            _walk(v)

    _assign(app, name)
    top = names[id(app)]
    app_name = name or top
    prefix = route_prefix if route_prefix is not None else f"/{app_name}"

    # ---- phase 2: build infos children-first (still no side effects)
    infos: List[_DeploymentInfo] = []
    built: set = set()

    def _sub(value):
        if isinstance(value, Application):
            _build(value)
            return _BoundHandle(names[id(value)])
        if isinstance(value, (list, tuple)):
            return type(value)(_sub(v) for v in value)
        if isinstance(value, dict):
            return {k: _sub(v) for k, v in value.items()}
        return value

    def _build(a: Application) -> None:
        if id(a) in built:
            return
        built.add(id(a))
        d = a.deployment
        init_args = tuple(_sub(v) for v in a.init_args)
        init_kwargs = {k: _sub(v) for k, v in a.init_kwargs.items()}
        infos.append(_DeploymentInfo(
            name=names[id(a)], cls_bytes=cloudpickle.dumps(d._cls),
            init_args=init_args, init_kwargs=init_kwargs,
            num_replicas=d.num_replicas,
            max_ongoing_requests=d.max_ongoing_requests,
            ray_actor_options=d.ray_actor_options,
            autoscaling_config=d.autoscaling_config))

    _build(app)
    # ---- phase 3: ONE atomic controller call (validate + register +
    # deploy under the controller's lock — no validate/deploy TOCTOU
    # between concurrent serve.run()s)
    ray_tpu_torch.get(controller.deploy_application.remote(
        app_name, prefix, top, infos))
    return DeploymentHandle(top, controller)


def get_handle(name: str) -> DeploymentHandle:
    controller = _get_controller()
    return DeploymentHandle(name, controller)


def get_app_handle(name: str) -> DeploymentHandle:
    """Handle to a named application's ingress deployment."""
    controller = _get_controller()
    apps = ray_tpu_torch.get(controller.list_applications.remote())
    if name not in apps:
        raise ValueError(f"no application named {name!r}")
    return DeploymentHandle(apps[name]["ingress"], controller)


def status() -> Dict[str, dict]:
    controller = _get_controller()
    return ray_tpu_torch.get(controller.list_deployments.remote())


def status_applications() -> Dict[str, dict]:
    controller = _get_controller()
    return ray_tpu_torch.get(controller.list_applications.remote())


def delete(name: str) -> None:
    """Delete an application (the whole graph, by app name) or a single
    standalone deployment."""
    controller = _get_controller()
    if not ray_tpu_torch.get(controller.delete_app.remote(name)):
        ray_tpu_torch.get(controller.delete_deployment.remote(name))


def shutdown() -> None:
    try:
        controller = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    except ValueError:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except BaseException:
        pass
    # kill is async: wait for the name to actually clear, or the next
    # serve.run's get_if_exists would grab the dying controller
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            ray_tpu_torch.get_actor(_CONTROLLER_NAME)
        except ValueError:
            return
        time.sleep(0.05)


# ------------------------------------------------------- http ingress
_HTTP_SERVER = None


def start_http(port: int = 8000, host: str = "127.0.0.1") -> int:
    """JSON-over-POST ingress on the driver: POST /<deployment> with a
    JSON body calls the deployment and returns the JSON result
    (reference proxy actor, reduced to a driver thread)."""
    global _HTTP_SERVER
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if _HTTP_SERVER is not None:
        stop_http()          # never orphan a running ingress

    handles: Dict[str, DeploymentHandle] = {}
    # application route table: pushed over the `serve:routes` pubsub
    # channel by the controller on every deploy/delete (reference
    # long_poll.py route-table push); a slow TTL poll stays as the
    # fallback for missed pushes
    routes_cache = {"ts": 0.0, "apps": {}, "stop": False,
                    "loaded_at": -1.0}
    routes_lock = threading.Lock()

    def _load_routes() -> None:
        # ordered application: a slow fallback load that STARTED before
        # a push-triggered reload must not overwrite the fresher table
        started = time.monotonic()
        controller = _get_controller()
        apps = ray_tpu_torch.get(controller.list_applications.remote(),
                                 timeout=10)
        with routes_lock:
            if started > routes_cache["loaded_at"]:
                routes_cache["apps"] = apps
                routes_cache["loaded_at"] = started
                routes_cache["ts"] = time.time()

    def _app_routes() -> Dict[str, dict]:
        if time.time() - routes_cache["ts"] > 30.0:   # slow fallback
            try:
                _load_routes()
            except BaseException:
                pass
        return routes_cache["apps"]

    def _match_app(path: str):
        """Longest-prefix match of `path` against app route_prefixes;
        returns (ingress deployment, remaining path) or None."""
        best = None
        for rec in _app_routes().values():
            p = rec["route_prefix"].rstrip("/")
            if path == p or path == p + "/" or path.startswith(p + "/"):
                if best is None or len(p) > len(best[0]):
                    best = (p, rec["ingress"])
        if best is None:
            return None
        return best[1], path[len(best[0]):].strip("/")

    class Ingress(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            from urllib.parse import parse_qs, urlsplit
            url = urlsplit(self.path)
            matched = _match_app(url.path)
            if matched is not None:
                name, rest = matched
                sub = rest.split("/") if rest else []
            else:           # legacy: POST /<deployment>[/stream]
                parts = url.path.strip("/").split("/")
                name, sub = parts[0], parts[1:]
            streaming = ("stream" in sub[:1]) or \
                parse_qs(url.query).get("stream", ["0"])[0] == "1"
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"null")
                if name not in handles:
                    handles[name] = get_handle(name)
                if streaming:
                    self._stream_response(handles[name], body)
                    return
                result = ray_tpu_torch.get(handles[name].remote(body),
                                           timeout=60)
                payload = json.dumps({"result": result}).encode()
                self.send_response(200)
            except BaseException as e:  # noqa: BLE001
                payload = json.dumps({"error": repr(e)}).encode()
                self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _stream_response(self, handle, body) -> None:
            """Chunked transfer: one JSON line per generator chunk
            (reference proxy streaming over ASGI)."""
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonlines")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data + b"\r\n")

            try:
                for chunk in handle.stream(body):
                    write_chunk(json.dumps({"chunk": chunk}).encode()
                                + b"\n")
            except BaseException as e:  # noqa: BLE001
                write_chunk(json.dumps({"error": repr(e)}).encode()
                            + b"\n")
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, *a):   # quiet
            pass

    _HTTP_SERVER = ThreadingHTTPServer((host, port), Ingress)
    _HTTP_SERVER._rtpu_routes_cache = routes_cache   # for stop_http
    # start the push watcher only once the server actually bound — a
    # bind failure must not leak an unstoppable polling thread
    threading.Thread(
        target=_watch_channel,
        args=("serve:routes",
              lambda _msgs: _load_routes(),
              lambda: routes_cache["stop"]),
        name="serve-routes-watch", daemon=True).start()
    threading.Thread(target=_HTTP_SERVER.serve_forever,
                     daemon=True).start()
    return _HTTP_SERVER.server_address[1]


def stop_http() -> None:
    global _HTTP_SERVER
    if _HTTP_SERVER is not None:
        cache = getattr(_HTTP_SERVER, "_rtpu_routes_cache", None)
        if cache is not None:
            cache["stop"] = True       # routes watch thread exits
        _HTTP_SERVER.shutdown()
        _HTTP_SERVER = None


# -------------------------------------------------------- grpc ingress
_GRPC_SERVER = None


def start_grpc(port: int = 9000, host: str = "127.0.0.1",
               max_workers: int = 8) -> int:
    """gRPC ingress (reference _private/grpc_util / proxy gRPC mode),
    codegen-free: a generic handler registers two JSON-over-bytes
    methods —

      /ray_tpu_torch.serve/Call    unary-unary   {"deployment", "method",
                                                  "args", "kwargs"} -> result
      /ray_tpu_torch.serve/Stream  unary-stream  same request; one JSON
                                                  chunk per generator yield

    Clients call via grpc.insecure_channel with json (de)serializers;
    no .proto compilation needed on either side."""
    global _GRPC_SERVER
    import json
    from concurrent import futures

    import grpc

    handles: Dict[str, DeploymentHandle] = {}

    def _handle(name: str) -> DeploymentHandle:
        if name not in handles:
            handles[name] = get_handle(name)
        return handles[name]

    def call(request: bytes, context) -> bytes:
        req = json.loads(request or b"{}")
        try:
            h = _handle(req["deployment"])
            result = ray_tpu_torch.get(
                h.method(req.get("method", "__call__"),
                         *req.get("args", []), **req.get("kwargs", {})),
                timeout=req.get("timeout_s", 60))
            return json.dumps({"result": result}).encode()
        except (GeneratorExit, KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001
            # error travels on the status alone (clients drop response
            # bodies on non-OK)
            context.abort(grpc.StatusCode.INTERNAL, repr(e))

    def stream(request: bytes, context):
        req = json.loads(request or b"{}")
        try:
            h = _handle(req["deployment"])
            for chunk in h.stream(*req.get("args", []),
                                  method_name=req.get("method",
                                                      "__call__"),
                                  **req.get("kwargs", {})):
                yield json.dumps({"chunk": chunk}).encode()
        except (GeneratorExit, KeyboardInterrupt, SystemExit):
            raise          # client cancelled / teardown: close cleanly
        except BaseException as e:  # noqa: BLE001
            # one consistent error channel: the trailing status (no
            # in-band error chunk a client would misparse)
            context.abort(grpc.StatusCode.INTERNAL, repr(e))

    ident = lambda b: b
    handler = grpc.method_handlers_generic_handler(
        "ray_tpu_torch.serve",
        {"Call": grpc.unary_unary_rpc_method_handler(
            call, request_deserializer=ident, response_serializer=ident),
         "Stream": grpc.unary_stream_rpc_method_handler(
            stream, request_deserializer=ident,
            response_serializer=ident)})
    if _GRPC_SERVER is not None:
        stop_grpc()          # never orphan a running ingress
    server = grpc.server(futures.ThreadPoolExecutor(
        max_workers=max_workers))
    server.add_generic_rpc_handlers((handler,))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        server.stop(None)
        raise OSError(f"could not bind gRPC ingress to {host}:{port}")
    server.start()
    _GRPC_SERVER = server
    return bound


def stop_grpc() -> None:
    global _GRPC_SERVER
    if _GRPC_SERVER is not None:
        _GRPC_SERVER.stop(grace=2)
        _GRPC_SERVER = None
