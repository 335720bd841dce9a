"""Request router for LLM serving: depth balancing + mid-stream failover.

Port of `ray_tpu/serve/llm/router.py`, complete; tokens ride the port's
push stream (`stream.py`) or `next_tokens` polling.

`LLMHandle` is the consumer-side entry point. Unlike the generic
`DeploymentHandle` (power-of-two on request counts), it balances on
OUTSTANDING TOKEN DEPTH — the tokens each replica still owes — because
a replica holding two 500-token generations is busier than one holding
five 4-token ones, and request-count routing cannot see that.

Failover is the consumer's job (the engine is deliberately dumb about
it): when a stream connection drops, a replica dies, or an engine
reports its requests `drained` (the controller routing a SUSPECT node
around), the handle re-submits the generation — prompt plus every
token already consumed — to a surviving replica under a bumped attempt
number. The token sequence numbering makes the handoff exactly-once:
the consumer only ever appends token `len(emitted)`, and the fence in
the stream client drops frames from superseded attempts or stale
incarnations, so a zombie replica still decoding into a partition
cannot duplicate or interleave output.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import ray_tpu_torch

_FAILOVER_MAX = 4


class LLMHandle:
    """Routes generations across an LLM deployment's replica groups."""

    def __init__(self, name: str, controller=None):
        from ray_tpu_torch.serve import _CONTROLLER_NAME
        self._name = name
        self._controller = controller or ray_tpu_torch.get_actor(
            _CONTROLLER_NAME)
        self._lock = threading.Lock()
        self._replicas: List = []
        self._refreshed = 0.0
        # actor_id -> outstanding token depth this handle has routed
        self._depth: Dict[str, int] = {}
        self._cooldown: Dict[str, float] = {}   # actor_id -> t_failed

    # -------------------------------------------------- replica set
    def _refresh(self, force: bool = False) -> None:
        with self._lock:
            if not force and time.time() - self._refreshed < 5.0 \
                    and self._replicas:
                return
        reps = ray_tpu_torch.get(
            self._controller.get_replicas.remote(self._name))
        with self._lock:
            self._replicas = reps
            self._refreshed = time.time()

    def _is_suspect(self, replica) -> bool:
        """r17 SUSPECT avoidance, best-effort: when this process is
        the head runtime, map the replica's actor record to its node
        and skip nodes in the SUSPECT liveness state (a gray failure
        in progress — the node is still routable but a worse bet than
        any healthy peer)."""
        try:
            from ray_tpu_torch._private import context as _context
            ctx = _context.maybe_ctx()
            cluster = getattr(ctx, "cluster", None)
            controller = getattr(ctx, "controller", None)
            if cluster is None or controller is None:
                return False
            rec = controller.get_actor(replica._actor_id)
            return bool(rec is not None and rec.node_id
                        and cluster.is_suspect(rec.node_id))
        except BaseException:
            return False

    def _pick(self, exclude=()):
        self._refresh()
        with self._lock:
            reps = list(self._replicas)
        if not reps:
            self._refresh(force=True)
            with self._lock:
                reps = list(self._replicas)
        now = time.monotonic()
        best, best_depth = None, None
        fallback = None
        for r in reps:
            aid = r._actor_id
            if aid in exclude:
                continue
            fallback = fallback or r
            if now - self._cooldown.get(aid, -1e9) < 2.0:
                continue
            if self._is_suspect(r):
                continue
            d = self._depth.get(aid, 0)
            if best_depth is None or d < best_depth:
                best, best_depth = r, d
        if best is None:
            best = fallback      # everyone suspect/cooling: degrade
        if best is None:
            raise RuntimeError(
                f"deployment {self._name!r} has no usable replicas")
        return best

    def _note_failure(self, replica) -> None:
        with self._lock:
            self._cooldown[replica._actor_id] = time.monotonic()

    def _depth_add(self, replica, n: int) -> None:
        with self._lock:
            aid = replica._actor_id
            self._depth[aid] = max(0, self._depth.get(aid, 0) + n)

    # ------------------------------------------------------ serving
    def generate(self, prompt: Sequence[int], max_tokens: int = 16,
                 stop: Sequence[int] = (),
                 timeout_s: float = 60.0) -> "TokenStream":
        """Submit one generation; returns a lazy TokenStream iterator
        of token ids."""
        return TokenStream(self, [int(t) for t in prompt],
                           int(max_tokens),
                           [int(t) for t in stop], timeout_s)

    def queue_wait_p95(self, window_s: Optional[float] = None) -> float:
        """Max queue-wait p95 across replicas — plug this into
        `Autoscaler(queue_latency_source=handle.queue_wait_p95)` (the
        r11 injectable signal) or let the serve controller's
        `target_queue_latency_s` consume the same number from replica
        reports."""
        self._refresh()
        with self._lock:
            reps = list(self._replicas)
        worst = 0.0
        for r in reps:
            try:
                st = ray_tpu_torch.get(r.handle_request.remote(
                    "engine_stats", (), {}, False), timeout=5.0)
                worst = max(worst, float(st.get("queue_wait_p95", 0.0)))
            except BaseException:
                pass
        return worst

    def stats(self) -> List[dict]:
        self._refresh()
        with self._lock:
            reps = list(self._replicas)
        out = []
        for r in reps:
            try:
                out.append(ray_tpu_torch.get(r.handle_request.remote(
                    "engine_stats", (), {}, False), timeout=5.0))
            except BaseException:
                pass
        return out


class TokenStream:
    """Iterator over one generation's tokens with transparent failover.

    Push mode (CONFIG.llm_stream): frames arrive on the peer-dialed
    stream connection; `__next__` just waits on the sink queue. Polled
    mode: `next_tokens` actor calls with server-side parking and
    client-side adaptive backoff. Either way the consumer sees each
    token exactly once and a terminal error at most once.
    """

    def __init__(self, handle: LLMHandle, prompt: List[int],
                 max_tokens: int, stop: List[int], timeout_s: float):
        from ray_tpu_torch._private.config import CONFIG
        self._h = handle
        self._prompt = prompt
        self._max_tokens = max_tokens
        self._stop = stop
        self._timeout_s = timeout_s
        self._push = bool(CONFIG.llm_stream)
        self.emitted: List[int] = []
        self.finish_reason: Optional[str] = None
        self._pending: List[int] = []
        self._failovers = 0
        self._replica = None
        self._rid = None
        self._attempt = 0
        self._sink: queue.Queue = queue.Queue()
        self._cursor = 0          # engine-side tokens consumed (attempt)
        self._owed = 0            # depth this stream added to replica
        self._backoff = 0.0
        self.ttft_s: Optional[float] = None
        self.t_last: Optional[float] = None
        self._t_submit = time.monotonic()
        self._submit(first=True)

    # ---------------------------------------------------- submission
    def _submit(self, first: bool = False, exclude=()) -> None:
        last_err = None
        tries = 0
        while tries < _FAILOVER_MAX:
            tries += 1
            try:
                replica = self._h._pick(exclude=exclude)
            except RuntimeError as e:
                # Every replica we know about is excluded. The
                # controller may already be standing up a replacement
                # (liveness kill, drain): force-refresh the set and
                # retry — a fresh actor id is not in `exclude`.
                last_err = e
                time.sleep(0.5)
                self._h._refresh(force=True)
                continue
            base = len(self.emitted)
            prompt = self._prompt + self.emitted
            max_tokens = self._max_tokens - base
            if max_tokens <= 0:
                self.finish_reason = "length"
                return
            try:
                acc = ray_tpu_torch.get(replica.handle_request.remote(
                    "generate", (prompt,),
                    {"max_tokens": max_tokens, "stop": self._stop,
                     "attempt": self._attempt}, False),
                    timeout=self._timeout_s)
            except BaseException as e:
                last_err = e
                self._h._note_failure(replica)
                exclude = tuple(exclude) + (replica._actor_id,)
                continue
            self._replica = replica
            self._rid = acc["rid"]
            self._inc = acc["incarnation"]
            self._stream_addr = acc.get("stream")
            self._cursor = 0
            self._owed = max_tokens
            self._h._depth_add(replica, max_tokens)
            # fresh sink per attempt: frames a dead attempt already
            # delivered can never masquerade as the new one's
            self._sink = queue.Queue()
            if self._push and not self._stream_addr:
                # engine replica runs with the stream plane off
                # (RAY_TPU_LLM_STREAM=0 server-side): poll instead
                self._push = False
            if self._push:
                from ray_tpu_torch.serve.llm.stream import stream_client
                ok = stream_client().subscribe(
                    tuple(self._stream_addr), self._rid, self._inc,
                    self._attempt, 0, self._sink)
                if not ok:
                    self._h._note_failure(replica)
                    exclude = tuple(exclude) + (replica._actor_id,)
                    continue
            return
        raise RuntimeError(
            f"llm generate failed after {tries} attempts") from last_err

    def _failover(self, why: str) -> None:
        self._failovers += 1
        if self._failovers > _FAILOVER_MAX:
            raise RuntimeError(
                f"generation lost after {self._failovers - 1} "
                f"failovers (last: {why})")
        dead = self._replica
        if dead is not None:
            self._h._note_failure(dead)
            self._h._depth_add(dead, -self._owed)
            self._owed = 0
        if self._push and self._rid:
            from ray_tpu_torch.serve.llm.stream import stream_client
            stream_client().unsubscribe(self._rid)
        self._attempt += 1
        self._submit(exclude=(dead._actor_id,) if dead is not None
                     else ())

    # ----------------------------------------------------- consuming
    def __iter__(self):
        return self

    def __next__(self) -> int:
        while True:
            if self._pending:
                tok = self._pending.pop(0)
                now = time.monotonic()
                if not self.emitted:
                    self.ttft_s = now - self._t_submit
                self.t_last = now
                self.emitted.append(tok)
                return tok
            if self.finish_reason is not None:
                raise StopIteration
            if self._push:
                self._pump_push()
            else:
                self._pump_polled()

    def _accept(self, base: int, toks: List[int]) -> None:
        """Overlap-trimmed append: only tokens at exactly the next
        engine-side cursor extend the stream (replay/live races and
        re-deliveries collapse to no-ops)."""
        if base > self._cursor:
            return        # gap: impossible from a correct engine; drop
        skip = self._cursor - base
        fresh = toks[skip:]
        if fresh:
            self._pending.extend(fresh)
            self._cursor += len(fresh)
            if self._replica is not None:
                self._h._depth_add(self._replica, -len(fresh))
                self._owed = max(0, self._owed - len(fresh))

    def _pump_push(self) -> None:
        try:
            msg = self._sink.get(timeout=self._timeout_s)
        except queue.Empty:
            self._failover("token timeout")
            return
        if msg.get("type") == "llm_closed":
            self._failover("stream connection lost")
            return
        if msg.get("unknown"):
            self._failover("replica lost request state")
            return
        self._accept(msg["base"], msg.get("toks", []))
        if msg.get("done"):
            reason = msg.get("reason")
            if reason == "drained":
                self._failover("replica drained")
                return
            if msg.get("err"):
                raise RuntimeError(f"generation failed: {msg['err']}")
            self._finish(reason)

    def _pump_polled(self) -> None:
        try:
            out = ray_tpu_torch.get(self._replica.handle_request.remote(
                "next_tokens", (self._rid,),
                {"cursor": self._cursor}, False),
                timeout=self._timeout_s)
        except BaseException:
            self._failover("poll failed")
            return
        if out.get("incarnation") != self._inc \
                or out.get("attempt") != self._attempt:
            self._failover("stale replica state")
            return
        toks = out.get("toks", [])
        self._accept(self._cursor, toks)
        if out.get("done"):
            reason = out.get("reason")
            if reason == "drained":
                self._failover("replica drained")
                return
            if out.get("err"):
                raise RuntimeError(
                    f"generation failed: {out['err']}")
            self._finish(reason)
        elif not toks:
            # dry poll: adaptive backoff on top of the server-side
            # park, so an idle generation costs ~2 calls/s, not a spin
            self._backoff = min(0.25, (self._backoff or 0.01) * 2)
            time.sleep(self._backoff)
        else:
            self._backoff = 0.0

    def _finish(self, reason: Optional[str]) -> None:
        self.finish_reason = reason or "stop"
        if self._replica is not None:
            self._h._depth_add(self._replica, -self._owed)
            self._owed = 0
        if self._push and self._rid:
            from ray_tpu_torch.serve.llm.stream import stream_client
            stream_client().unsubscribe(self._rid)

    def tokens(self) -> List[int]:
        """Drain to completion and return every generated token."""
        for _ in self:
            pass
        return list(self.emitted)

    def cancel(self) -> None:
        if self.finish_reason is not None:
            return
        self.finish_reason = "cancelled"
        if self._push and self._rid:
            from ray_tpu_torch.serve.llm.stream import stream_client
            stream_client().unsubscribe(self._rid)
        try:
            self._replica.handle_request.remote(
                "cancel", (self._rid,), {}, False)
        except BaseException:
            pass
