"""Worker process entry point + worker-side context.

Parity: the reference's `default_worker.py` + worker-side core worker
(reference python/ray/_private/workers/default_worker.py and
src/ray/core_worker/core_worker.cc RunTaskExecutionLoop:2840 /
ExecuteTask:2914). Execution flows through a thread pool whose width is the
actor's ``max_concurrency`` (concurrency-group parity,
core_worker/transport/concurrency_group_manager.cc, width only), so the
socket reader thread never runs user code and a worker blocked in a nested
``get`` keeps draining pushed messages.
"""
from __future__ import annotations

import argparse
import asyncio
import inspect
import os
import pickle
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import cloudpickle

from ray_tpu_torch._private import context as _context
from ray_tpu_torch._private import metrics_plane as _mp
from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.accelerators import gpu as _gpu
from ray_tpu_torch._private.object_store import StoredObject, deserialize, serialize
from ray_tpu_torch._private.refs import ObjectRef
from ray_tpu_torch._private.specs import (ActorSpec, ActorTaskSpec, RefMarker,
                                    TaskSpec, extract_ref_args, function_id,
                                    new_actor_id, new_task_id)
from ray_tpu_torch.exceptions import (GetTimeoutError, TaskError, format_exception)


class WorkerContext(_context.BaseContext):
    is_driver = False

    def __init__(self, conn: protocol.Connection, worker_id: str):
        self.conn = conn
        self.worker_id = worker_id
        self._sent_funcs: set[str] = set()
        # r18 direct actor caller: created lazily on the first actor
        # call once the peer has demonstrated wire MINOR >= 8 (the
        # delta flusher thread shouldn't exist in workers that never
        # call actors)
        self._direct = None
        self._direct_lock = threading.Lock()

    def _direct_caller(self):
        from ray_tpu_torch._private.config import CONFIG
        if not CONFIG.direct_actor or \
                not self.conn.peer_speaks_direct_actor():
            return None
        with self._direct_lock:
            if self._direct is None:
                from ray_tpu_torch._private import refs as _refs
                from ray_tpu_torch._private.direct_actor import (
                    WorkerDirectCaller)
                self._direct = WorkerDirectCaller(self)
                # a released return ref drops its cached inline reply
                _refs.register_release_hook(self._direct.release)
            return self._direct

    # ---- object plane ----
    def put(self, value: Any) -> ObjectRef:
        with _tp.span("worker", "put"):
            return self._put_inner(value)

    def _put_inner(self, value: Any) -> ObjectRef:
        stored = serialize(value)
        rep = self.conn.request(_tp.stamp(
            {"type": protocol.PUT_OBJECT, "stored": stored}))
        if rep.get("pressure"):
            # store over cap and fully pinned: self-throttle the
            # producer (create-queueing backpressure applied in the
            # producer process, never on a connection reader)
            import time as _t
            _t.sleep(0.2)
        return ObjectRef(stored.object_id, owned=True)

    def get_objects(self, object_ids: list[str],
                    timeout: Optional[float]) -> list[Any]:
        out = []
        for oid in object_ids:
            value, stored = self._get_one(oid, timeout)
            if stored.is_error:
                self._note_actor_death(value)
                raise value
            out.append(value)
        return out

    def _note_actor_death(self, err) -> None:
        """An error about to surface to the caller: when it carries an
        ActorDiedError, invalidate the direct caller's endpoint cache
        for that actor so a restarted incarnation is re-resolved on
        the next call rather than NACK-discovered."""
        if self._direct is None:
            return
        from ray_tpu_torch.exceptions import ActorDiedError
        cause = getattr(err, "cause", err)
        if isinstance(cause, ActorDiedError) and cause.actor_id:
            self._direct.on_actor_died(cause.actor_id)

    def _get_one(self, oid: str, timeout):
        # r18 direct plane: a return ref of a direct actor call
        # resolves against the inline-reply cache (zero frames). When
        # the reply is still in flight this waits on its future — with
        # a stall fallback onto the normal head path, which is where a
        # dead/partitioned host's calls resolve (the head errors its
        # mirrored in-flight entries with ActorDiedError).
        if self._direct is not None:
            t0 = time.monotonic()
            stored = self._direct.wait_inline(oid, timeout)
            if stored is not None:
                return deserialize(stored), stored
            if timeout is not None:
                # the head-routed fallback gets the REMAINING budget,
                # not a fresh one — get(timeout=T) must bound at ~T
                timeout = max(0.0, timeout
                              - (time.monotonic() - t0))
        for attempt in (0, 1):
            # stamped: the serving side (head/agent) parents its pull
            # spans under this get's span — arg pulls join the timeline
            reply = self.conn.request(_tp.stamp(
                {"type": protocol.GET_OBJECT, "object_id": oid,
                 "timeout": timeout}))
            if reply.get("timeout") or reply.get("stored") is None:
                raise GetTimeoutError(f"get() timed out waiting for {oid}")
            stored: StoredObject = reply["stored"]
            try:
                return deserialize(stored), stored
            except FileNotFoundError:
                # driver spilled the object between reply and our shm
                # map; one re-request restores it (inline buffers)
                if attempt:
                    raise

    def wait(self, object_ids: list[str], num_returns: int,
             timeout: Optional[float]):
        reply = self.conn.request(
            {"type": protocol.WAIT, "object_ids": object_ids,
             "num_returns": num_returns, "timeout": timeout})
        ready = set(reply.get("ready", []))
        return ([o for o in object_ids if o in ready],
                [o for o in object_ids if o not in ready])

    def decref(self, object_id: str) -> None:
        try:
            self.conn.send_lazy({"type": protocol.DECREF,
                                 "object_id": object_id})
        except protocol.ConnectionClosed:
            pass

    def decref_batch(self, object_ids: list[str]) -> None:
        # one frame for the whole flush batch (refs.py decref flusher)
        if not object_ids:
            return
        try:
            self.conn.send_lazy({"type": protocol.DECREF_BATCH,
                                 "object_ids": list(object_ids)})
        except protocol.ConnectionClosed:
            pass

    def addref(self, object_id: str) -> None:
        # lazy is safe: the ADDREF and any later TASK_DONE share the
        # coalescing queue (FIFO), and eager requests flush it first —
        # the pin-release ordering invariant holds either way
        try:
            self.conn.send_lazy({"type": protocol.ADDREF,
                                 "object_id": object_id})
        except protocol.ConnectionClosed:
            pass

    # ---- task plane (nested submission) ----
    def submit_task(self, spec: TaskSpec, func_bytes: bytes = None) -> list[str]:
        fb = None
        if spec.func_id not in self._sent_funcs:
            fb = func_bytes
            self._sent_funcs.add(spec.func_id)
        # nested submission inside a traced task: the child task's
        # trace chains under this worker-side submit span (the head's
        # own submit span then chains under it in turn)
        with _tp.span("submit", spec.name or spec.task_id) as tr:
            if tr is not None:
                spec.trace_id, spec.parent_span = tr
            self.conn.request({"type": protocol.SUBMIT, "spec": spec,
                               "func_bytes": fb})
        return spec.return_ids

    def create_actor(self, spec: ActorSpec, class_bytes: bytes = None) -> str:
        fb = None
        if spec.class_id not in self._sent_funcs:
            fb = class_bytes
            self._sent_funcs.add(spec.class_id)
        self.conn.request({"type": protocol.SUBMIT_ACTOR, "spec": spec,
                           "class_bytes": fb})
        return spec.actor_id

    def submit_actor_task(self, actor_id: str,
                          spec: ActorTaskSpec) -> list[str]:
        with _tp.span("submit", spec.name or spec.task_id) as tr:
            if tr is not None:
                spec.trace_id, spec.parent_span = tr
            # return-id borrows register eagerly ahead of the submit
            # on BOTH routes (lazy ADDREFs coalesce with neighboring
            # frames): the borrow must be structurally ordered before
            # any decref this process later emits for the same ref
            for oid in spec.return_ids:
                self.addref(oid)
            # r18: peer-to-peer fast path — resolve the actor's
            # endpoint once, stream the call to its host, take the
            # reply inline; falls back to the head-routed submit
            # whenever the direct plane declines the call
            d = self._direct_caller()
            if d is not None and d.submit(actor_id, spec):
                return spec.return_ids
            self.conn.request({"type": protocol.SUBMIT_ACTOR_TASK,
                               "actor_id": actor_id, "spec": spec})
        return spec.return_ids

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        self.state_op("kill_actor", actor_id=actor_id)

    def cancel_task(self, object_id: str, force: bool = False) -> None:
        self.state_op("cancel_task", object_id=object_id, force=force)

    # ---- control plane ----
    def kv_op(self, op: str, key: str, value: Any = None,
              namespace: str = "default", **kw) -> Any:
        reply = self.conn.request({"type": protocol.KV_OP, "op": op,
                                   "key": key, "value": value,
                                   "namespace": namespace, **kw})
        return reply.get("value")

    def get_function(self, func_id: str) -> bytes:
        return self.kv_op("func_get", func_id)

    def state_op(self, op: str, **kwargs) -> Any:
        reply = self.conn.request({"type": protocol.STATE_OP, "op": op,
                                   "kwargs": kwargs})
        if reply.get("stale"):
            from ray_tpu_torch._private.pubsub import StaleCursorError
            raise StaleCursorError(reply.get("detail", "stale cursor"),
                                   resync=reply.get("resync", 0))
        if reply.get("error"):
            raise RuntimeError(
                f"state op {op!r} failed on the head: {reply['error']}")
        return reply.get("value")

    def get_actor_handle(self, name: str, namespace: str = "default"):
        actors = self.state_op("list_actors")
        for a in actors:
            if a["name"] == name and a["state"] != "DEAD":
                cls = pickle.loads(self.get_function(a["class_id"]))
                from ray_tpu_torch.actor import ActorHandle
                return ActorHandle._from_class(a["actor_id"], cls, 0)
        raise ValueError(f"No actor named {name!r}")

    def node_resources(self) -> dict:
        return self.state_op("cluster_resources")


def _apply_runtime_env(renv: Optional[dict], kv_get=None) -> dict:
    """Apply a runtime_env in this process; returns undo info.

    Parity: reference _private/runtime_env/ plugins: env_vars fanout,
    working_dir (chdir + sys.path), pip (per-host cached venv,
    runtime_env/pip.py) and py_modules (KV-shipped packages,
    runtime_env/py_modules.py); the key set is validated at SUBMISSION
    time (api.validate_runtime_env). Atomic: a failure mid-apply
    reverts whatever was already applied before re-raising — a pooled
    worker must never leak a half-applied env onto later tasks."""
    undo: dict = {"env": {}, "cwd": None, "paths": []}
    if not renv:
        return undo
    try:
        for k, v in (renv.get("env_vars") or {}).items():
            undo["env"][k] = os.environ.get(k)
            os.environ[k] = str(v)
        wd = renv.get("working_dir")
        if wd:
            undo["cwd"] = os.getcwd()
            os.chdir(wd)
            sys.path.insert(0, wd)
            undo["paths"].append(wd)
        if renv.get("pip"):
            from ray_tpu_torch._private.runtime_env import ensure_pip_env
            site = ensure_pip_env(renv["pip"])
            sys.path.insert(0, site)
            undo["paths"].append(site)
        if renv.get("uv"):
            from ray_tpu_torch._private.runtime_env import ensure_uv_env
            site = ensure_uv_env(renv["uv"])
            sys.path.insert(0, site)
            undo["paths"].append(site)
        if renv.get("conda"):
            from ray_tpu_torch._private.runtime_env import ensure_conda_env
            site = ensure_conda_env(renv["conda"])
            sys.path.insert(0, site)
            undo["paths"].append(site)
        # container/image_uri is a spawn-time concern (the scheduler
        # wraps the worker command); nothing to apply in-process
        if renv.get("py_modules"):
            from ray_tpu_torch._private.runtime_env import ensure_py_modules
            for path in ensure_py_modules(renv["py_modules"], kv_get):
                sys.path.insert(0, path)
                undo["paths"].append(path)
    except BaseException:
        _revert_runtime_env(undo)
        raise
    return undo


def _revert_runtime_env(undo: dict) -> None:
    for k, old in undo["env"].items():
        if old is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = old
    if undo["cwd"] is not None:
        os.chdir(undo["cwd"])
    for path in undo.get("paths", []):
        try:
            sys.path.remove(path)
        except ValueError:
            pass


class _StealLedger:
    """Which of a worker's queued task entries the driver stole back
    (UNQUEUE_TASK). Counted per task id: the driver may steal a task,
    then dispatch the same task id to this worker again and steal that
    copy too, so two stale entries wait in the FIFO. One tombstone per
    task id (the JAX package's set) skipped only the first, and the
    second ran here as well as where the task was placed: a duplicate
    execution that could block its worker for good, with tasks
    pipelined behind it (ROADMAP queue 3, item 15). Callers hold the
    executor's queue lock."""

    def __init__(self):
        self._queued: dict[str, int] = {}    # entries received, unstarted
        self._stolen: dict[str, int] = {}    # entries to skip

    def received(self, task_id: str) -> None:
        self._queued[task_id] = self._queued.get(task_id, 0) + 1

    def steal(self, task_id: str) -> bool:
        """True when an unstarted entry of `task_id` is now stolen; an
        entry that started (or ran) refuses, or its tombstone would skip
        a later lineage resubmission of the same id."""
        if not self._queued.get(task_id):
            return False
        self._take(self._queued, task_id)
        self._stolen[task_id] = self._stolen.get(task_id, 0) + 1
        return True

    def start(self, task_id: str) -> bool:
        """One FIFO entry of `task_id` reaches the executor: False to skip
        it (a stolen entry), True to run it."""
        if self._stolen.get(task_id):
            self._take(self._stolen, task_id)
            return False
        self._take(self._queued, task_id)
        return True

    @staticmethod
    def _take(counts: dict, task_id: str) -> None:
        n = counts.get(task_id, 0) - 1
        if n > 0:
            counts[task_id] = n
        else:
            counts.pop(task_id, None)


class WorkerExecutor:
    def __init__(self, ctx: WorkerContext):
        self.ctx = ctx
        self._fn_cache: dict[str, Any] = {}
        self._running_tasks: dict[str, threading.Thread] = {}
        # runtime env stays APPLIED between tasks with the same hash
        # (runtime-env-keyed worker reuse, reference worker_pool.cc);
        # a task with a different env reverts + re-applies
        self._cur_env_hash = None
        self._cur_env_undo: dict = {"env": {}, "cwd": None, "paths": []}
        self._pending_cancels: set[str] = set()
        self._cancel_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="rtpu-exec")
        self._actor: Any = None
        self._actor_spec: Optional[ActorSpec] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.stop_event = threading.Event()
        # worker-side task-event buffer: execution-truth timestamps
        # (queue/env latency = gap vs the driver's RUNNING event),
        # batched + flushed periodically instead of one RPC per event
        # (reference src/ray/core_worker/task_event_buffer.cc)
        self._event_buf: list[dict] = []
        self._event_lock = threading.Lock()
        self._event_last_flush = time.time()
        self._event_flush_s = float(
            os.environ.get("RAY_TPU_TASK_EVENT_FLUSH_S", "2.0"))
        self._event_cap = int(
            os.environ.get("RAY_TPU_TASK_EVENT_BUFFER", "32"))
        threading.Thread(target=self._event_flush_loop,
                         name="rtpu-task-events", daemon=True).start()
        # pipelined-task steal-back (see UNQUEUE_TASK): entries the
        # driver reclaimed before they started; _run_task skips them
        self._queue_lock = threading.Lock()
        self._steals = _StealLedger()
        self._started_tasks: set[str] = set()
        # tasks/actor-calls accepted but not yet completion-reported:
        # TASK_DONE coalesces (lazy) only while OTHER work is in
        # flight — a lone sync round-trip must not eat the ~1 ms
        # coalescing window
        self._inflight = 0
        # r18 worker-direct serving: callers that dialed this worker's
        # own listener, awaiting an inline reply (task_id -> (conn,
        # rid)); the listener port rides the REGISTER frame so the
        # head can resolve this worker as the actor's endpoint
        self._direct_replies: dict[str, tuple] = {}
        self._direct_lock = threading.Lock()
        self._direct_listener = None
        self._direct_port = None
        # the CUDA_VISIBLE_DEVICES this process initialised CUDA on
        self._bound: Optional[str] = None

    # ---- direct actor call serving (r18) ----
    def start_direct_server(self):
        """Open this worker's direct-call listener (caller -> worker
        -> caller, no agent hop); returns the port for the REGISTER
        frame, or None (plane off / bind failed — callers fall back
        to agent-hosted serving)."""
        from ray_tpu_torch._private.config import CONFIG
        if not (CONFIG.direct_actor and CONFIG.direct_actor_worker):
            return None
        try:
            lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lsock.setsockopt(socket.SOL_SOCKET,
                             socket.SO_REUSEADDR, 1)
            lsock.bind(("0.0.0.0", 0))
            lsock.listen(64)
        except OSError:
            return None
        self._direct_listener = lsock
        self._direct_port = lsock.getsockname()[1]
        threading.Thread(target=self._direct_accept_loop,
                         name="rtpu-worker-direct",
                         daemon=True).start()
        return self._direct_port

    def _direct_accept_loop(self) -> None:
        while not self.stop_event.is_set():
            try:
                sock, _ = self._direct_listener.accept()
            except OSError:
                return
            conn = protocol.Connection(sock, self._handle_direct,
                                       name="worker-direct",
                                       server=True)
            conn.start()

    def _handle_direct(self, conn: protocol.Connection,
                       msg: dict) -> None:
        """Messages from direct-dialed callers. Validation IS the
        fence: the worker id is unique per process, so a stale
        endpoint (actor restarted -> new worker/new port) can never
        validate here — it NACKs redirect-to-head."""
        mtype = msg["type"]
        if mtype == protocol.ACTOR_TASK_DIRECT:
            from ray_tpu_torch._private import direct_actor as _da
            spec = msg["spec"]
            aspec = self._actor_spec
            if (msg.get("worker_id") != self.ctx.worker_id
                    or self._actor is None or aspec is None
                    or aspec.actor_id != msg.get("actor_id")):
                _da.nack(conn, msg.get("rid"),
                         "stale_worker_endpoint", False)
                return
            with self._direct_lock:
                self._direct_replies[spec.task_id] = (conn,
                                                      msg.get("rid"))
            self._accept_actor_task(spec, msg)
        elif mtype == protocol.PING:
            conn.reply(msg, ok=True)

    def _reply_direct(self, ent: tuple, task_id: str,
                      stored_list: list, error: bool,
                      extra: dict) -> None:
        """Answer a direct caller inline. Small results (and errors)
        ride the reply; large ones go to the node store via a
        direct_located TASK_DONE so the ordinary directory + pull
        path serves every getter — the reply itself stays small."""
        from ray_tpu_torch._private.config import CONFIG
        from ray_tpu_torch._private.object_transfer import materialize
        conn, rid = ent
        inline, big = [], []
        for s in stored_list:
            if (s.nbytes <= CONFIG.remote_inline_max_bytes
                    or s.is_error):
                inline.append(materialize(s))
                from ray_tpu_torch._private.object_store import \
                    unlink_segment
                for name in s.shm_names:
                    unlink_segment(name)
            else:
                big.append(s)
        try:
            conn.reply({"rid": rid}, inline=inline, located=[],
                       error=error)
        except protocol.ConnectionClosed:
            # caller died mid-call: ship the small results through the
            # node store too (the direct_located path below), so a
            # third-party holder of the return ref still resolves
            big = big + inline
        if big:
            try:
                self.ctx.conn.send(
                    {"type": protocol.TASK_DONE, "task_id": task_id,
                     "results": big, "error": error,
                     "is_actor_task": True, "direct_located": True,
                     "actor_id": extra.get("actor_id"),
                     "name": extra.get("name")})
            except protocol.ConnectionClosed:
                pass

    # ---- message entry (called on reader thread) ----
    def handle(self, conn: protocol.Connection, msg: dict) -> None:
        mtype = msg["type"]
        if mtype == protocol.TASK:
            spec = msg["spec"]
            self._stamp_recv(spec, msg)
            with self._queue_lock:
                self._steals.received(spec.task_id)
                self._inflight += 1
            self._pool.submit(self._run_task, spec, msg.get("cards"))
        elif mtype == protocol.ACTOR_CREATE:
            spec: ActorSpec = msg["spec"]
            if spec.max_concurrency > 1:
                self._pool = ThreadPoolExecutor(
                    max_workers=spec.max_concurrency,
                    thread_name_prefix="rtpu-actor")
            self._pool.submit(self._create_actor, spec, msg.get("cards"))
        elif mtype == protocol.ACTOR_TASK:
            self._accept_actor_task(msg["spec"], msg)
        elif mtype == protocol.CANCEL_TASK:
            self._cancel_running(msg["task_id"])
        elif mtype == protocol.UNQUEUE_TASK:
            # driver steals back a task pipelined behind a BLOCKED task
            # (it would deadlock if the blocked get transitively depends
            # on it). ok only for a task that is genuinely queued and
            # not started (_StealLedger.steal).
            with self._queue_lock:
                ok = self._steals.steal(msg["task_id"])
            conn.reply(msg, ok=ok)
        elif mtype == protocol.TRACE_DUMP:
            conn.reply(msg, dump=_tp.dump())
        elif mtype == protocol.METRICS_DUMP:
            conn.reply(msg, dump=_mp.local_dump())
        elif mtype == protocol.SHUTDOWN:
            self.stop_event.set()
        elif mtype == protocol.PING:
            conn.reply(msg, ok=True)

    def _accept_actor_task(self, aspec: ActorTaskSpec,
                           msg: dict) -> None:
        """Queue one actor call for execution — shared by the classic
        pushed ACTOR_TASK and the r18 direct-dialed path (one entry
        point keeps the per-handle FIFO/async dispatch identical on
        both transports)."""
        self._stamp_recv(aspec, msg)
        with self._queue_lock:
            self._inflight += 1
        method = getattr(type(self._actor), aspec.method_name, None) \
            if self._actor is not None else None
        if method is not None and inspect.iscoroutinefunction(method):
            self._ensure_loop()
            asyncio.run_coroutine_threadsafe(
                self._run_actor_task_async(aspec), self._loop)
        else:
            self._pool.submit(self._run_actor_task, aspec)

    @staticmethod
    def _stamp_recv(spec, msg: dict) -> None:
        """Note message-arrival time and re-parent the spec under the
        scheduler's envelope-carried lease span, so the exec spans
        chain driver → scheduler → worker (the spec's own pickled
        parent is the submit span — the right fallback when the lease
        hop was emitted by an old peer or with tracing off there)."""
        tid = getattr(spec, "trace_id", 0)   # pre-r9-pickled specs
        if tid and _tp.enabled():            # have no trace fields
            tr = msg.get("_trace")
            if tr and tr[0] == tid:
                spec.parent_span = tr[1]
            spec._recv_ns = _tp.now()

    # ---- worker-side task events ----
    def _record_event(self, task_id: str, name: str, state: str,
                      **extra) -> None:
        ev = {"task_id": task_id, "name": name, "state": state,
              "ts": time.time(), "worker_id": self.ctx.worker_id,
              **extra}
        with self._event_lock:
            self._event_buf.append(ev)
            should = (len(self._event_buf) >= self._event_cap
                      or time.time() - self._event_last_flush
                      >= self._event_flush_s)
            if should:
                # claim the window now so a burst of events doesn't
                # spawn one flush thread each before the first one runs
                self._event_last_flush = time.time()
        if should:
            # never block the caller (async actors record from the
            # event-loop thread): flush on a short-lived thread
            threading.Thread(target=self.flush_events,
                             daemon=True).start()

    def _event_flush_loop(self) -> None:
        while not self.stop_event.wait(self._event_flush_s):
            self.flush_events()

    def flush_events(self) -> None:
        with self._event_lock:
            if not self._event_buf:
                return
            batch, self._event_buf = self._event_buf, []
            self._event_last_flush = time.time()
        try:
            self.ctx.state_op("record_task_events", events=batch)
        except Exception:
            pass   # head unreachable (shutdown race): best-effort

    def _cancel_running(self, task_id: str) -> None:
        """Interrupt a running task by raising TaskCancelledError in its
        executor thread (reference CancelTask path: the worker raises in
        the executing thread; tasks blocked in C extensions only observe
        it at the next bytecode boundary — same limitation there)."""
        import ctypes

        from ray_tpu_torch.exceptions import TaskCancelledError
        with self._cancel_lock:
            # registration is popped under this same lock with the
            # pending-exception cleared, so a cancel can never land on a
            # thread after its task is done (it would brick the reused
            # pool thread)
            thread = self._running_tasks.get(task_id)
            if thread is None or not thread.is_alive():
                # Cancel raced ahead of registration (the pool thread
                # hasn't started the task yet): record it so _run_task
                # aborts before user code runs instead of silently
                # completing while the driver shows CANCELLING. Bounded:
                # a cancel that arrives AFTER completion leaves a stale
                # id here (its task never runs again), so cap the set.
                if len(self._pending_cancels) >= 1024:
                    self._pending_cancels.pop()
                self._pending_cancels.add(task_id)
                return
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_long(thread.ident),
                ctypes.py_object(TaskCancelledError))

    def _ensure_loop(self) -> None:
        if self._loop is None:
            self._loop = asyncio.new_event_loop()
            threading.Thread(target=self._loop.run_forever,
                             name="rtpu-actor-loop", daemon=True).start()

    # ---- tracing plane (r9) ----
    @staticmethod
    def _open_exec_span(spec, set_tls: bool = True):
        """Start the worker's span pair for a traced spec: a "recv"
        span covering message-arrival → execution-start (the worker-
        local FIFO queue time, which depth>1 pipelining makes real),
        then the exec span whose id the TASK_DONE will carry. Returns
        opaque state for _close_exec_span, or None when untraced."""
        tid = getattr(spec, "trace_id", 0)
        if not tid or not _tp.enabled():
            return None
        t_start = _tp.now()
        parent = getattr(spec, "parent_span", 0)
        t_recv = getattr(spec, "_recv_ns", None)
        if t_recv is not None:
            sid_r = _tp.new_id()
            _tp.record("worker", "recv", t_recv, t_start, tid, sid_r,
                       parent)
            parent = sid_r
        exec_sid = _tp.new_id()
        if set_tls:
            # nested gets/puts/submissions made by user code parent
            # under the exec span (async actor methods skip this: the
            # event loop interleaves coroutines on one thread)
            _tp.set_current(tid, exec_sid)
        return (tid, exec_sid, parent, t_start, set_tls)

    @staticmethod
    def _close_exec_span(tctx, spec, error: bool):
        """Record the exec span; returns the (trace_id, span_id) pair
        the TASK_DONE message should carry, or None."""
        if tctx is None:
            return None
        tid, exec_sid, parent, t_start, set_tls = tctx
        _tp.record("worker", "exec:" + (spec.name or spec.task_id[:12]),
                   t_start, _tp.now(), tid, exec_sid, parent,
                   {"error": True} if error else None)
        if set_tls:
            _tp.clear_current()
        return (tid, exec_sid)

    # ---- execution ----
    def _load_function(self, func_id: str):
        fn = self._fn_cache.get(func_id)
        if fn is None:
            data = self.ctx.get_function(func_id)
            if data is None:
                raise RuntimeError(f"function {func_id} not found in store")
            fn = cloudpickle.loads(data)
            self._fn_cache[func_id] = fn
        return fn

    def _resolve_args(self, args, kwargs):
        ref_ids = [a.object_id for a in args if isinstance(a, RefMarker)]
        ref_ids += [v.object_id for v in kwargs.values()
                    if isinstance(v, RefMarker)]
        values = {}
        if ref_ids:
            # traced tasks get an explicit arg-fetch span (the classic
            # hidden stall: remote args pulled before exec can start);
            # the GET_OBJECT messages inside carry its context
            with _tp.span("worker", "get_args",
                          extra={"n": len(ref_ids)}):
                got = self.ctx.get_objects(ref_ids, timeout=None)
            values = dict(zip(ref_ids, got))
        conv = lambda v: values[v.object_id] if isinstance(v, RefMarker) else v
        return tuple(conv(a) for a in args), {
            k: conv(v) for k, v in kwargs.items()}

    def _send_results(self, task_id: str, return_ids: list[str],
                      result: Any, num_returns: int, error: bool,
                      **extra) -> None:
        tr = extra.get("_trace")
        t_put = _tp.now() if (tr and _tp.enabled()) else None
        if not error and num_returns > 1:
            if not isinstance(result, (tuple, list)) or \
                    len(result) != num_returns:
                error = True
                result = TaskError(ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{type(result).__name__}"))
        stored_list = []
        if error or num_returns <= 1:
            values = [result] * len(return_ids)
        else:
            values = list(result)
        for oid, value in zip(return_ids, values):
            try:
                stored = serialize(value, object_id=oid)
            except BaseException as e:  # noqa: BLE001
                # Unserializable result (or shm failure): the task must
                # still complete with an error, never vanish silently
                # with its resources held.
                error = True
                stored = serialize(
                    TaskError(e, format_exception(e)), object_id=oid)
            stored.is_error = error
            stored_list.append(stored)
        if t_put is not None:
            # result serialization/seal span, parented under exec
            _tp.record("worker", "put", t_put, _tp.now(), tr[0],
                       _tp.new_id(), tr[1],
                       {"nbytes": sum(s.nbytes for s in stored_list)})
        # Lazy while other work is in flight: completions emitted in
        # the same tick (pipelined tasks finishing back-to-back, seal
        # notifications, trailing decrefs) coalesce into one frame —
        # the ~1 ms window is far below the driver's completion-
        # processing latency and the worker keeps executing meanwhile.
        # A lone completion (sync round-trip) flushes eagerly instead.
        with self._queue_lock:
            self._inflight = max(0, self._inflight - 1)
            busy = self._inflight > 0
        if extra.get("is_actor_task"):
            # r18 worker-direct: this call's caller dialed us — the
            # completion goes back inline on its connection, never
            # through the agent/head
            with self._direct_lock:
                ent = self._direct_replies.pop(task_id, None)
            if ent is not None:
                self._reply_direct(ent, task_id, stored_list, error,
                                   extra)
                return
        msg = {"type": protocol.TASK_DONE, "task_id": task_id,
               "results": stored_list, "error": error, **extra}
        if not extra.get("is_actor_task"):      # a pooled worker's
            bound = self._bound_report()
            if bound is not None:
                msg["cuda_bound"] = bound
        if busy:
            self.ctx.conn.send_lazy(msg)
        else:
            self.ctx.conn.send(msg)

    def _finish_task_cleanup(self, spec: TaskSpec) -> None:
        """Idempotent post-task cleanup: deregister from the cancel
        table, CLEAR any pending async cancel on this thread (a raced
        cancel must not detonate in the pool thread's idle loop or in
        _send_results), and revert the task's runtime env."""
        import ctypes
        with self._cancel_lock:
            self._running_tasks.pop(spec.task_id, None)
            self._pending_cancels.discard(spec.task_id)
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_long(threading.get_ident()), None)


    def _switch_runtime_env(self, renv: Optional[dict]) -> None:
        from ray_tpu_torch._private.runtime_env import env_hash
        h = env_hash(renv)
        if h == self._cur_env_hash:
            return
        _revert_runtime_env(self._cur_env_undo)
        # two envs may ship DIFFERENT versions of the same package:
        # purge modules imported from the reverted paths or the next
        # env would silently serve stale code
        for path in self._cur_env_undo.get("paths", []):
            prefix = os.path.abspath(path) + os.sep
            for name, mod in list(sys.modules.items()):
                f = getattr(mod, "__file__", None)
                if f and os.path.abspath(f).startswith(prefix):
                    del sys.modules[name]
        self._cur_env_undo = {"env": {}, "cwd": None, "paths": []}
        self._cur_env_hash = None
        self._cur_env_undo = _apply_runtime_env(
            renv, kv_get=lambda k: self.ctx.kv_op("get", k))
        self._cur_env_hash = h

    def _bound_report(self) -> Optional[str]:
        """The `CUDA_VISIBLE_DEVICES` this process initialised CUDA on
        ("*" for none set), once it has: the scheduler then leases this
        worker only those cards."""
        if self._bound is None and _gpu.cuda_bound():
            self._bound = os.environ.get("CUDA_VISIBLE_DEVICES", "*")
        return self._bound

    @staticmethod
    def _pin(cards: Optional[str]) -> None:
        """Pin the process to a GPU lease's cards before its task or
        actor constructor runs; a lease without cards leaves the pin as
        it is. A process bound to other cards refuses the lease (raises)
        rather than run it on them."""
        if cards is not None:
            _gpu.GPUAcceleratorManager.set_visible_accelerators(
                cards.split(","))

    def _run_task(self, spec: TaskSpec,
                  cards: Optional[str] = None) -> None:
        from ray_tpu_torch.exceptions import TaskCancelledError
        with self._queue_lock:
            if not self._steals.start(spec.task_id):
                # stolen back by the driver while queued: it was (or
                # will be) re-dispatched elsewhere — skip silently
                self._inflight = max(0, self._inflight - 1)
                return
            self._started_tasks.add(spec.task_id)
        t0 = time.time()
        t0m = time.monotonic()      # exec histogram: step-immune clock
        tctx = self._open_exec_span(spec)
        self._record_event(spec.task_id, spec.name, "EXEC_STARTED")
        try:
            try:
                with self._cancel_lock:
                    if spec.task_id in self._pending_cancels:
                        self._pending_cancels.discard(spec.task_id)
                        raise TaskCancelledError(spec.task_id)
                    self._running_tasks[spec.task_id] = \
                        threading.current_thread()
                # env first: the function/args may only UNPICKLE under
                # the declared working_dir/env (the actor path does the
                # same). Kept applied for reuse by same-env tasks.
                self._switch_runtime_env(
                    getattr(spec, "runtime_env", None))
                self._pin(cards)
                fn = self._load_function(spec.func_id)
                args, kwargs = self._resolve_args(spec.args, spec.kwargs)
                result = fn(*args, **kwargs)
                error = False
            except BaseException as e:  # noqa: BLE001
                result = e if isinstance(e, TaskError) else TaskError(
                    e, format_exception(e), task_name=spec.name)
                error = True
            finally:
                self._finish_task_cleanup(spec)
        except TaskCancelledError as e:
            # the async cancel landed INSIDE the finally (between task
            # completion and the pending-exc clear): redo the cleanup —
            # the exception has fired, so this pass cannot be interrupted
            # again — and report the task cancelled.
            self._finish_task_cleanup(spec)
            result = TaskError(e, format_exception(e),
                               task_name=spec.name)
            error = True
        tr = self._close_exec_span(tctx, spec, error)
        _mp.observe_exec(time.monotonic() - t0m)
        extra = {"name": spec.name}
        if tr is not None:
            extra["_trace"] = tr
        self._send_results(spec.task_id, spec.return_ids, result,
                           spec.num_returns, error, **extra)
        self._record_event(spec.task_id, spec.name,
                           "EXEC_FAILED" if error else "EXEC_FINISHED",
                           duration_s=time.time() - t0)
        with self._queue_lock:
            self._started_tasks.discard(spec.task_id)

    def _create_actor(self, spec: ActorSpec,
                      cards: Optional[str] = None) -> None:
        try:
            # permanent: this worker is dedicated to the actor for life
            self._switch_runtime_env(getattr(spec, "runtime_env", None))
            self._pin(cards)
            cls = self._load_function(spec.class_id)
            args, kwargs = self._resolve_args(spec.init_args,
                                              spec.init_kwargs)
            self._actor = cls(*args, **kwargs)
            self._actor_spec = spec
            err = False
            err_repr = ""
        except BaseException as e:  # noqa: BLE001
            err = True
            err_repr = format_exception(e)
            sys.stderr.write(f"actor creation failed:\n{err_repr}")
        self.ctx.conn.send({"type": protocol.TASK_DONE,
                            "task_id": f"create:{spec.actor_id}",
                            "results": [], "error": err,
                            "error_repr": err_repr,
                            "is_actor_create": True,
                            "actor_id": spec.actor_id})

    def _invoke_actor_method(self, spec: ActorTaskSpec):
        args, kwargs = self._resolve_args(spec.args, spec.kwargs)
        if spec.method_name == "__rtpu_apply__":
            # escape hatch (reference actor.__ray_call__): run an
            # arbitrary function against the actor instance — compiled
            # DAGs use it to install their channel exec loops on user
            # actors without requiring cooperation from the class
            fn = cloudpickle.loads(args[0])
            return fn(self._actor, *args[1:], **kwargs)
        method = getattr(self._actor, spec.method_name)
        return method(*args, **kwargs)

    def _run_actor_task(self, spec: ActorTaskSpec) -> None:
        t0 = time.time()
        t0m = time.monotonic()      # exec histogram: step-immune clock
        tctx = self._open_exec_span(spec)
        self._record_event(spec.task_id, spec.name, "EXEC_STARTED")
        try:
            result = self._invoke_actor_method(spec)
            error = False
        except BaseException as e:  # noqa: BLE001
            result = TaskError(e, format_exception(e), task_name=spec.name)
            error = True
        tr = self._close_exec_span(tctx, spec, error)
        _mp.observe_exec(time.monotonic() - t0m)
        extra = {"name": spec.name}
        if tr is not None:
            extra["_trace"] = tr
        self._send_results(spec.task_id, spec.return_ids, result,
                           spec.num_returns, error, is_actor_task=True,
                           actor_id=spec.actor_id, **extra)
        self._record_event(spec.task_id, spec.name,
                           "EXEC_FAILED" if error else "EXEC_FINISHED",
                           duration_s=time.time() - t0)

    async def _run_actor_task_async(self, spec: ActorTaskSpec) -> None:
        t0 = time.time()
        t0m = time.monotonic()      # exec histogram: step-immune clock
        tctx = self._open_exec_span(spec, set_tls=False)
        self._record_event(spec.task_id, spec.name, "EXEC_STARTED")
        try:
            method = getattr(self._actor, spec.method_name)
            args, kwargs = self._resolve_args(spec.args, spec.kwargs)
            result = await method(*args, **kwargs)
            error = False
        except BaseException as e:  # noqa: BLE001
            result = TaskError(e, format_exception(e), task_name=spec.name)
            error = True
        tr = self._close_exec_span(tctx, spec, error)
        _mp.observe_exec(time.monotonic() - t0m)
        extra = {"name": spec.name}
        if tr is not None:
            extra["_trace"] = tr
        self._send_results(spec.task_id, spec.return_ids, result,
                           spec.num_returns, error, is_actor_task=True,
                           actor_id=spec.actor_id, **extra)
        self._record_event(spec.task_id, spec.name,
                           "EXEC_FAILED" if error else "EXEC_FINISHED",
                           duration_s=time.time() - t0)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--addr", required=True)
    parser.add_argument("--worker-id", required=True)
    args = parser.parse_args()
    host, port = args.addr.rsplit(":", 1)

    executor_box: dict = {}

    def handler(conn, msg):
        executor_box["exec"].handle(conn, msg)

    def on_close(conn):
        # Driver went away: nothing useful left to do.
        os._exit(0)

    _tp.set_role("worker", args.worker_id)
    conn = protocol.connect((host, int(port)), handler, on_close,
                            name=f"worker-{args.worker_id}")
    # the worker is a hot emitter (TASK_DONE bursts, decref floods):
    # coalesce its fire-and-forget frames
    conn.enable_coalescing()
    ctx = WorkerContext(conn, args.worker_id)
    _context.set_ctx(ctx)
    executor = WorkerExecutor(ctx)
    executor_box["exec"] = executor
    direct_port = executor.start_direct_server()
    from ray_tpu_torch import native as _native
    conn.send({"type": protocol.REGISTER, "worker_id": args.worker_id,
               "pid": os.getpid(),
               # which wire engine this worker runs (native frame
               # pump/codec vs pure Python) — lets the head spot
               # mixed-mode fleets when debugging perf regressions
               "wire_native": _native.frame_engine_enabled(),
               # r18: this worker's direct-call serving port (None
               # when the plane is off) — resolves as the actor's
               # endpoint once the head learns it
               "direct_port": direct_port})
    executor.stop_event.wait()
    executor.flush_events()
    try:
        conn.flush()             # drain any coalescing-queued frames
    except protocol.ConnectionClosed:
        pass
    conn.close()
    # Daemonic pool threads may be mid-task; hard-exit like the reference's
    # worker does on graceful shutdown after draining.
    os._exit(0)


if __name__ == "__main__":
    main()
