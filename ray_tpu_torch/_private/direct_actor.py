"""Direct actor call plane (r18): peer-to-peer submission + inline replies.

Reference parity: the L0 core worker submits actor tasks worker-to-
worker with the GCS only resolving the actor's location
(src/ray/core_worker/transport/actor_task_submitter.cc + the
sequential actor submit queue). Here the head answers a one-time
``ACTOR_RESOLVE`` with the actor's endpoint — the hosting agent's (or
head's) listener address, the actor's worker id, its restart epoch,
and the node incarnation — the caller caches it and streams
``ACTOR_TASK_DIRECT`` frames over ONE dialed connection, and replies
return inline on the same connection. Steady-state actor calls touch
the head zero times; the head stays the owner of actor lifecycle
through the caller's coalesced ``ACTOR_INFLIGHT_DELTA`` mirror (the
r16 decref-delta discipline), so actor death/restart still produces
``ActorDiedError``/requeue with first-terminal-wins semantics.

Ordering: calls submitted through one handle ride one TCP stream to
the hosting node, which forwards them to the actor's worker in arrival
order — the per-handle submission-order guarantee ``actor.py``
promises holds on the direct path. On any failure (NACK redirect,
endpoint death) the caller flips the actor to STICKY head-routed
fallback: the NACKed calls re-enter the head's queue in submission
order via the mirror, and every later call takes the head path behind
them, so a direct call can never overtake an earlier fallback call.
The driver re-enables direct mode once its inflight/queued books for
the actor are empty (all prior calls reached a terminal state); worker
callers, which cannot observe head-path completion, stay head-routed
for the actor's lifetime after a fallback — sound, and restarts are
rare.

Split of roles in this module:
- ``PendingDirectCalls``: host-side registry (agent and head-as-host)
  of calls forwarded to a worker whose reply the dialed caller is
  still owed. Worker death NACKs every pending call (started=True —
  ambiguous, routed through the head's retry budget).
- ``WorkerDirectCaller``: the caller side for worker/client processes
  (the driver's caller lives in runtime.py where the bookkeeping is
  in-process and free). Holds the endpoint + connection caches, the
  reply-future table, the inline-result cache consumed by get(), and
  the coalesced inflight-delta buffer.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private import tracing_plane as _tp
from ray_tpu_torch._private.config import CONFIG as _CFG

# Negative-resolve cache TTL: an actor that resolved pending/dead/
# non-direct is not re-resolved for this long, so a pending actor's
# caller doesn't pay one resolve round-trip per call while it starts.
_NEG_TTL_S = 0.5


def new_stats() -> dict:
    """One counter dict shape for every party (caller and host), so
    /metrics and state ops render uniformly."""
    return {
        "direct_calls": 0,        # caller: calls sent direct
        "direct_replies": 0,      # caller: inline replies applied
        "inline_bytes": 0,        # caller: bytes landed via replies
        "fallbacks": 0,           # caller: calls sent head-routed
                                  #   while the actor is in fallback
        "redirects": 0,           # caller: NACKs / dead-conn failures
        "resolves": 0,            # caller: ACTOR_RESOLVE round trips
        "stale_replies": 0,       # caller: replies for calls another
                                  #   path already resolved (dropped)
        "served": 0,              # host: direct calls forwarded
        "nacks": 0,               # host: calls NACKed (stale endpoint,
                                  #   fenced node, head-disconnected)
        "served_bytes": 0,        # host: inline reply bytes emitted
    }


class PendingDirectCalls:
    """Host-side table of direct calls awaiting their worker's
    TASK_DONE: task_id -> (caller conn, rid, worker_id).
    The popper owns the reply."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_task: dict[str, tuple] = {}

    def add(self, task_id: str, conn, rid, worker_id: str) -> None:
        with self._lock:
            self._by_task[task_id] = (conn, rid, worker_id)

    def pop(self, task_id: str) -> Optional[tuple]:
        with self._lock:
            return self._by_task.pop(task_id, None)

    def pop_worker(self, worker_id: str) -> list[tuple]:
        """Every pending entry bound to a dead worker, as
        (task_id, conn, rid)."""
        with self._lock:
            hits = [(t, e[0], e[1])
                    for t, e in self._by_task.items()
                    if e[2] == worker_id]
            for t, *_ in hits:
                self._by_task.pop(t, None)
            return hits

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_task)


def dial_cached(cache: dict, lock, addr: tuple,
                poller=None, handler=None,
                on_close=None) -> Optional[protocol.Connection]:
    """Shared endpoint-connection cache (driver and worker callers):
    return the live cached connection for ``addr`` or dial a fresh
    one; a concurrent dial keeps the winner already in the cache and
    closes the loser. None when the endpoint refuses.

    ``handler``/``on_close`` customize the dialed connection for
    planes that receive server-PUSHED frames on it (the serve/llm
    token stream) — the default drops unsolicited frames, which is
    right for the call/reply direct plane."""
    with lock:
        c = cache.get(addr)
        if c is not None and not c.closed:
            return c
    try:
        c = protocol.connect(addr, handler or (lambda conn, m: None),
                             on_close=on_close,
                             name=f"direct-{addr[0]}:{addr[1]}",
                             poller=poller)
    except OSError:
        return None
    with lock:
        existing = cache.get(addr)
        if existing is not None and not existing.closed:
            try:
                c.close()
            except Exception:
                pass
            return existing
        cache[addr] = c
    return c


def nack(conn, rid, reason: str, started: bool) -> None:
    """Answer a direct call with a redirect-to-head NACK. ``started``
    tells the caller whether the task may have begun executing
    (ambiguous — charge the retry budget) or provably never reached
    the worker (safe requeue)."""
    try:
        conn.reply({"rid": rid}, redirect=True, started=bool(started),
                   reason=reason)
    except protocol.ConnectionClosed:
        pass


class WorkerDirectCaller:
    """Caller-side direct plane for worker/client contexts.

    The context owns one instance; ``submit`` returns True when the
    call went direct (the reply future drives completion) and False
    when the caller should take the head-routed path."""

    def __init__(self, ctx):
        self._ctx = ctx                       # WorkerContext/Client
        self._lock = threading.Lock()
        # reply arrival signal: _on_reply/_fail notify under _lock;
        # wait_inline blocks here instead of polling (a sleep-poll
        # cost ~1 ms per sync call — the reply callback runs AFTER
        # the future's waiters wake, so polling always lost the race)
        self._cv = threading.Condition(self._lock)
        self._endpoints: dict[str, dict] = {}     # actor_id -> ep
        self._neg: dict[str, float] = {}          # actor_id -> retry t
        self._conns: dict[tuple, protocol.Connection] = {}
        self._fallback: set[str] = set()          # sticky head-routed
        # task_id -> (future, actor_id); oid -> task_id for get()
        self._pending: dict[str, tuple] = {}
        self._actor_pending: dict[str, int] = {}   # per-actor inflight
        # task ids whose get() stalled out and fell back to the head:
        # resolution authority transferred — a late reply still ships
        # its done delta (a slow call resolves via the head's seal)
        # but must NOT populate the local cache, or a zombie value
        # could shadow the head's first-terminal-wins outcome
        self._head_owned: set[str] = set()
        self._oid_task: dict[str, str] = {}
        self._results: dict[str, Any] = {}        # oid -> StoredObject
        self.stats = new_stats()
        self.last_redirect_reason: Optional[str] = None
        # coalesced ACTOR_INFLIGHT_DELTA buffer (r16 decref-delta
        # discipline): adds flush eagerly-ish so the head's pin lands
        # before the caller's own later decrefs can release an arg
        # ref; dones ride the window (delaying a release is safe).
        # The window is ADAPTIVE (r20): a fixed 25 ms window amortizes
        # a 1k calls/s sync caller to <0.1 head frames/call but bills
        # a sparse caller (an RL env-runner pacing ~60 act()/s against
        # env steps) nearly one frame per call — near-empty frames
        # widen the next window up to the cap, near-full frames snap
        # it back so high-rate callers keep the tight window. Nothing
        # in the delta is latency-critical (args ride a call-lifetime
        # borrow), so only crash-loss scope grows with the window.
        self._delta_lock = threading.Lock()
        self._delta_buf: list = []
        self._delta_window_ms: Optional[float] = None   # None = base
        self._delta_flusher = protocol.FlushLoop(
            self.flush_delta, self._delta_delay_ms,
            "rtpu-direct-delta")

    def _delta_delay_ms(self) -> float:
        base = _CFG.direct_actor_delta_delay_ms
        cur = self._delta_window_ms
        return base if cur is None else max(base, cur)

    # ------------------------------------------------------ gating
    def enabled(self) -> bool:
        return bool(_CFG.direct_actor) and \
            self._ctx.conn.peer_speaks_direct_actor()

    # ---------------------------------------------------- endpoints
    def _endpoint(self, actor_id: str) -> Optional[dict]:
        with self._lock:
            ep = self._endpoints.get(actor_id)
            if ep is not None:
                refresh = ep.get("_refresh_at")
                if (refresh is not None
                        and time.monotonic() > refresh
                        and not self._actor_pending.get(actor_id)):
                    # quiet moment on a provisional (agent-hosted)
                    # endpoint: drop it and re-resolve — the worker's
                    # own socket may be known by now
                    self._endpoints.pop(actor_id, None)
                else:
                    return ep
            if self._neg.get(actor_id, 0) > time.monotonic():
                return None
        try:
            rep = self._ctx.conn.request(
                {"type": protocol.ACTOR_RESOLVE, "actor_id": actor_id},
                timeout=10.0)
        except (protocol.ConnectionClosed, TimeoutError):
            return None
        self.stats["resolves"] += 1
        if not rep.get("direct"):
            with self._lock:
                self._neg[actor_id] = time.monotonic() + _NEG_TTL_S
            return None
        ep = {"host": rep["host"], "port": int(rep["port"]),
              "worker_id": rep["worker_id"],
              "node_id": rep.get("node_id"),
              "epoch": int(rep.get("epoch", 0)),
              "incarnation": rep.get("incarnation")}
        if rep.get("provisional"):
            # agent-hosted because the worker's own port wasn't known
            # yet: re-resolve once the stream quiesces to upgrade to
            # the worker's socket (never mid-stream — two inbound
            # channels to one worker could reorder the handle's calls)
            ep["_refresh_at"] = time.monotonic() + 1.0
        with self._lock:
            self._endpoints[actor_id] = ep
        return ep

    def _dec_actor_pending(self, actor_id: str) -> None:
        """Caller holds self._lock."""
        n = self._actor_pending.get(actor_id, 0) - 1
        if n <= 0:
            self._actor_pending.pop(actor_id, None)
        else:
            self._actor_pending[actor_id] = n

    def _invalidate(self, actor_id: str, sticky: bool = True) -> None:
        with self._lock:
            self._endpoints.pop(actor_id, None)
            if sticky:
                self._fallback.add(actor_id)

    def on_actor_died(self, actor_id: str) -> None:
        """The caller just surfaced an ActorDiedError for this actor:
        drop its cached endpoint AND the negative-resolve memo so a
        restarted incarnation is re-resolved on the very next call
        instead of waiting out a stale-endpoint NACK round-trip (or
        the _NEG_TTL_S backoff from a resolve that raced the restart).
        The sticky fallback flag is cleared only when no calls are in
        flight — with pending books the NACK/fail ordering discipline
        still owns the flag."""
        with self._lock:
            self._endpoints.pop(actor_id, None)
            self._neg.pop(actor_id, None)
            if not self._actor_pending.get(actor_id):
                self._fallback.discard(actor_id)

    def _conn_for(self, ep: dict) -> Optional[protocol.Connection]:
        return dial_cached(self._conns, self._lock,
                           (ep["host"], ep["port"]))

    # ------------------------------------------------------- submit
    def submit(self, actor_id: str, spec) -> bool:
        if not self.enabled():
            return False
        with self._lock:
            if actor_id in self._fallback:
                self.stats["fallbacks"] += 1
                return False
        ep = self._endpoint(actor_id)
        if ep is None:
            return False
        conn = self._conn_for(ep)
        if conn is None:
            self._invalidate(actor_id, sticky=False)
            return False
        # chaos rules match by peer node id: a partition of the
        # hosting node must park this plane's frames too
        if ep.get("node_id"):
            conn.meta.setdefault("chaos_peer", ep["node_id"])
        # arg-ref protection: the caller holds an extra borrow on each
        # pinned arg for the call's lifetime (released on completion),
        # so the mirror-add — whose head-side pin used to be the only
        # guard — can coalesce lazily without opening a delete window.
        # The ADDREF rides the caller's conn AHEAD of any later decref
        # of the same ref (FIFO), exactly the submit-pin discipline of
        # the head-routed path.
        for oid in spec.pinned_refs:
            self._ctx.addref(oid)
        self._park_delta(("add", actor_id, spec))
        msg = {"type": protocol.ACTOR_TASK_DIRECT, "spec": spec,
               "actor_id": actor_id, "worker_id": ep["worker_id"],
               "epoch": ep["epoch"],
               "node_incarnation": ep["incarnation"]}
        if _tp.enabled() and getattr(spec, "trace_id", 0):
            msg["_trace"] = (spec.trace_id,
                             getattr(spec, "parent_span", 0))
        with self._lock:
            self._pending[spec.task_id] = (None, actor_id)
            self._actor_pending[actor_id] = \
                self._actor_pending.get(actor_id, 0) + 1
            for oid in spec.return_ids:
                self._oid_task[oid] = spec.task_id
        try:
            fut = conn.request_async(msg)
        except protocol.ConnectionClosed:
            with self._lock:
                self._pending.pop(spec.task_id, None)
                self._dec_actor_pending(actor_id)
                for oid in spec.return_ids:
                    self._oid_task.pop(oid, None)
            self._invalidate(actor_id, sticky=False)
            # mirror hygiene: retract the add we just parked, release
            # the call-lifetime borrow (the head-routed resubmission
            # the caller falls back to pins through its own path)
            self._park_delta(("done", actor_id, spec.task_id, False,
                              [], True))
            if spec.pinned_refs:
                self._ctx.decref_batch(list(spec.pinned_refs))
            return False
        with self._lock:
            if spec.task_id in self._pending:
                self._pending[spec.task_id] = (fut, actor_id)
        self.stats["direct_calls"] += 1
        fut.add_done_callback(
            lambda f, a=actor_id, s=spec: self._on_reply(a, s, f))
        return True

    # -------------------------------------------------- completion
    def _on_reply(self, actor_id: str, spec, fut) -> None:
        t0 = _tp.now() if _tp.enabled() else 0
        try:
            rep = fut.result(timeout=0)
        except BaseException:
            self._fail(actor_id, spec, started=True, reason="conn_lost")
            return
        if rep.get("redirect"):
            self._fail(actor_id, spec,
                       started=bool(rep.get("started")),
                       reason=rep.get("reason", "redirect"))
            return
        with self._lock:
            if self._pending.pop(spec.task_id, None) is None:
                self.stats["stale_replies"] += 1
                return                  # another path already resolved
            self._dec_actor_pending(actor_id)
            head_owned = spec.task_id in self._head_owned
            self._head_owned.discard(spec.task_id)
            if not head_owned:
                for stored in rep.get("inline", ()):
                    self._results[stored.object_id] = stored
                    self.stats["inline_bytes"] += stored.nbytes
            self._cv.notify_all()
        self.stats["direct_replies"] += 1
        if _tp.enabled() and getattr(spec, "trace_id", 0):
            _tp.record("direct", "reply:" + (spec.name or ""), t0,
                       _tp.now(), spec.trace_id, _tp.new_id(),
                       getattr(spec, "parent_span", 0))
        # the done entry carries the inline results to the head, which
        # seals them as the owner-side copy (exactly where the head-
        # routed path put them) — coalesced, so N calls amortize into
        # one frame and the head pays a store insert, not a route
        self._park_delta(("done", actor_id, spec.task_id,
                          bool(rep.get("error")),
                          list(rep.get("located", ())), False,
                          list(rep.get("inline", ()))))
        if spec.pinned_refs:
            self._ctx.decref_batch(list(spec.pinned_refs))

    def _fail(self, actor_id: str, spec, started: bool,
              reason: str) -> None:
        """A direct call came back NACKed or its connection died:
        sticky-fallback the actor and route the call itself back
        through the head's retry machinery via an EAGER mirror entry
        (the head owns requeue-vs-error: never-started calls requeue
        free, ambiguous ones charge the retry budget). Ordering: the
        fail delta is FLUSHED before the fallback flag publishes — a
        submit that observes the flag and goes head-routed rides the
        same connection BEHIND the delta, so the head order-stamps
        the NACKed call ahead of it."""
        with self._lock:
            if self._pending.pop(spec.task_id, None) is None:
                self.stats["stale_replies"] += 1
                return
            self._dec_actor_pending(actor_id)
            self._head_owned.discard(spec.task_id)
            self._cv.notify_all()
        self.stats["redirects"] += 1
        self.last_redirect_reason = reason      # debug surface
        self._park_delta(
            ("fail", actor_id, spec.task_id, bool(started)))
        self.flush_delta()   # before the fallback flag publishes
        self._invalidate(actor_id, sticky=True)
        if spec.pinned_refs:
            # the head's requeue re-pins through its own machinery;
            # release the call-lifetime borrow
            self._ctx.decref_batch(list(spec.pinned_refs))

    # ------------------------------------------------- get() hooks
    def take_inline(self, oid: str):
        """Inline-reply StoredObject for a return oid, or None. NOT
        popped — a ref may be gotten more than once; the entry dies
        with the ref (release hook) or at actor cleanup."""
        with self._lock:
            return self._results.get(oid)

    def wait_inline(self, oid: str,
                    timeout: Optional[float]) -> Optional[Any]:
        """Wait for oid's direct reply: the StoredObject on success,
        None when the caller should take the normal head-routed GET
        path — no direct call pending, reply resolved without an
        inline result for this oid (located large result, NACK, error
        routed through the head), or the stall budget expired (the
        silent-partition escape hatch: the head errors its mirrored
        in-flight calls, and the fallback get resolves that)."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        stall_deadline = time.monotonic() + \
            max(0.1, _CFG.direct_actor_stall_s)
        # _on_reply/_fail pop the pending entry, write the inline
        # results, and notify — all under this lock — so "entry gone +
        # cache miss" conclusively means the head path owns resolution
        with self._cv:
            while True:
                got = self._results.get(oid)
                if got is not None:
                    return got
                tid = self._oid_task.get(oid)
                if tid is None:
                    return None          # never a direct call
                if tid in self._head_owned:
                    return None          # already stalled out once
                if tid not in self._pending:
                    return None          # resolved without inline
                now = time.monotonic()
                if now > stall_deadline:
                    # stall fallback: resolution authority transfers
                    # to the head for THIS call — a late reply still
                    # ships its done delta (slow calls resolve via the
                    # head's seal) but won't populate the local cache
                    self._head_owned.add(tid)
                    return None
                if deadline is not None and now > deadline:
                    return None          # caller deadline: head path
                budget = stall_deadline - now
                if deadline is not None:
                    budget = min(budget, deadline - now)
                self._cv.wait(min(0.2, max(0.001, budget)))

    def release(self, oids) -> None:
        """Ref released (decref flush): drop the cached inline
        results — ownership accounting for inline-returned values."""
        with self._lock:
            for oid in oids:
                self._results.pop(oid, None)
                self._oid_task.pop(oid, None)

    # ------------------------------------------------ mirror delta
    def _park_delta(self, entry: tuple) -> None:
        with self._delta_lock:
            self._delta_buf.append(entry)
            n = len(self._delta_buf)
        if n >= max(1, _CFG.direct_actor_delta_max):
            self.flush_delta()
        else:
            self._delta_flusher.wake()

    def flush_delta(self) -> None:
        with self._delta_lock:
            if not self._delta_buf:
                return
            batch, self._delta_buf = self._delta_buf, []
        # adapt the next collect window to this frame's fill, steering
        # toward half-full frames (delta_max/2 entries): an emptier
        # frame (sparse caller) doubles the window toward the cap, a
        # fuller one (high-rate caller already amortizing) halves it
        # toward the base. Geometric steps both ways — the window
        # tracks rate shifts within a few flushes and a mid-rate
        # caller hovers around the half-full target instead of
        # sawtoothing between cap and base.
        base = _CFG.direct_actor_delta_delay_ms
        cap = max(base, _CFG.direct_actor_delta_delay_max_ms)
        cur = self._delta_window_ms or base
        if len(batch) >= max(1, _CFG.direct_actor_delta_max) // 2:
            self._delta_window_ms = max(base, cur / 2)
        else:
            self._delta_window_ms = min(cap, cur * 2)
        adds, dones = [], []
        for e in batch:
            if e[0] == "add":
                adds.append((e[1], e[2]))
            elif e[0] == "done":
                dones.append({"actor_id": e[1], "task_id": e[2],
                              "error": e[3], "located": e[4],
                              "retract": e[5],
                              "inline": e[6] if len(e) > 6 else []})
            else:                                    # "fail"
                dones.append({"actor_id": e[1], "task_id": e[2],
                              "failed": True, "started": e[3]})
        try:
            self._ctx.conn.send({"type": protocol.ACTOR_INFLIGHT_DELTA,
                                 "adds": adds, "dones": dones,
                                 "caller": getattr(self._ctx,
                                                   "worker_id", None)})
        except protocol.ConnectionClosed:
            pass

    def shutdown(self) -> None:
        self._delta_flusher.stop()
        try:
            self.flush_delta()
        except Exception:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except Exception:
                pass
