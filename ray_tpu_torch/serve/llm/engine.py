"""Continuous-batching LLM engine: the core and the serving class.

Port of `EngineCore` and `LLMEngine` of `ray_tpu/serve/llm/engine.py`.
`EngineCore` is the pure scheduler + model driver. Every `step()` first ADMITS waiting requests
(prefill into free KV pages) and then DECODES every in-flight sequence
by one token, so a short request admitted mid-flight finishes while a
long one is still generating (iteration-level scheduling). No threads;
it steps synchronously.

The same admission, eviction, cancel, drain, stats and event dicts as
the JAX core. What differs: a `device` (default: the card) and, for a
replica over tensor-parallel ranks, the replica's `group` in place of
the mesh (`replica_group.py`: at each model seam rank 0 broadcasts the
step's inputs and every rank runs its shard), direct calls in place of
the jit caches, and numpy batches moved with `torch.as_tensor(...,
device=...)`.

`LLMEngine` wraps a core with a step thread, polled token buffers,
drain, the TTFT/TPOT histograms and the push `TokenStreamServer`.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import uuid
from collections import deque
from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.metrics_plane import serving_metrics
from ray_tpu_torch.models import decode as _dec
from ray_tpu_torch.models.config import PRESETS, TransformerConfig
from ray_tpu_torch.models.convert import init_for_serving
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.serve.llm import replica_group as _rg
from ray_tpu_torch.serve.llm.kv_cache import (PageAllocator,
                                              pages_from_budget, pages_needed)
from ray_tpu_torch.serve.llm.stream import TokenStreamServer

FINISH_STOP = "stop"
FINISH_LENGTH = "length"
FINISH_DRAINED = "drained"


def _bucket(n: int, lo: int = 16, hi: int = 1 << 30) -> int:
    """Prefill pad bucket: next power of two, so a prompt's kernel
    shapes come from at most log2(max_seq_len) sizes."""
    b = lo
    while b < n:
        b <<= 1
    return min(b, hi)


@dataclasses.dataclass
class _Seq:
    rid: str
    prompt: List[int]
    max_tokens: int
    stop: frozenset
    attempt: int = 0
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    emitted: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    evictions: int = 0

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.emitted)

    @property
    def remaining(self) -> int:
        return max(0, self.max_tokens - len(self.emitted))


class EngineCore:
    """Deterministic (greedy) continuous-batching scheduler.

    step() events are dicts: {rid, token, seq, done, reason, first,
    attempt}. `seq` indexes into this attempt's emitted tokens.
    `params` must already be on `device` (default: the card). With a
    `group` (rank 0 of a replica's `ReplicaGroup`), `params` is rank 0's
    tp shard and the cache holds its kv heads.
    """

    def __init__(self, config, params, device=None,
                 num_pages: int = 0, page_size: int = 16,
                 max_batch: int = 8, group=None):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        self.group = group
        tp = 1 if group is None else group.size
        local = params["layers"][0]["wk"].shape[1] // config.head_dim
        if local * tp != config.kv_heads:
            raise ValueError(f"params hold {local} kv heads a rank; "
                             f"{config.kv_heads} over tp={tp} needs "
                             f"{config.kv_heads // tp}")
        self.config = config
        self.page_size = int(page_size)
        self.max_batch = int(max_batch)
        self.max_pages_per_seq = pages_needed(config.max_seq_len,
                                              self.page_size)
        if not num_pages:
            # default pool: every decode lane can hold a full-length
            # sequence
            num_pages = self.max_batch * self.max_pages_per_seq
        self.num_pages = int(num_pages)
        self.alloc = PageAllocator(self.num_pages)
        self.model = Transformer(config)
        self.params = params
        self._cache = _dec.init_paged_cache(config, self.num_pages,
                                            self.page_size,
                                            device=self.device,
                                            kv_heads=local)
        self._waiting: deque = deque()
        self._running: List[_Seq] = []
        self._by_rid: Dict[str, _Seq] = {}
        self._queue_waits: deque = deque(maxlen=1024)  # (t, wait_s)
        self.counters = {"admitted": 0, "evictions": 0, "finished": 0,
                         "tokens": 0, "steps": 0}

    # ------------------------------------------------------ intake
    def submit(self, prompt: Sequence[int], max_tokens: int = 16,
               stop: Sequence[int] = (), rid: Optional[str] = None,
               attempt: int = 0,
               submit_t: Optional[float] = None) -> str:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        max_tokens = int(max_tokens)
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        total = len(prompt) + max_tokens
        if total > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                f"exceeds max_seq_len {self.config.max_seq_len}")
        if pages_needed(total, self.page_size) > self.num_pages:
            raise ValueError(
                f"request needs {pages_needed(total, self.page_size)} "
                f"pages; pool holds {self.num_pages}")
        rid = rid or uuid.uuid4().hex[:12]
        if rid in self._by_rid:
            raise ValueError(f"duplicate request id {rid!r}")
        seq = _Seq(rid=rid, prompt=prompt, max_tokens=max_tokens,
                   stop=frozenset(int(t) for t in stop),
                   attempt=int(attempt),
                   submit_t=(time.monotonic() if submit_t is None
                             else submit_t))
        self._waiting.append(seq)
        self._by_rid[rid] = seq
        return rid

    def cancel(self, rid: str) -> bool:
        seq = self._by_rid.pop(rid, None)
        if seq is None:
            return False
        if seq in self._running:
            self._running.remove(seq)
        elif seq in self._waiting:
            self._waiting.remove(seq)
        if seq.pages:
            self.alloc.free(seq.pages)
            seq.pages = []
        return True

    def drain(self) -> List[dict]:
        """Stop everything in flight and hand back re-dispatchable
        descriptors; `emitted` rides along so a survivor continues
        rather than restarts."""
        out = []
        for seq in list(self._running) + list(self._waiting):
            out.append({"rid": seq.rid, "prompt": list(seq.prompt),
                        "emitted": list(seq.emitted),
                        "max_tokens": seq.max_tokens,
                        "stop": sorted(seq.stop),
                        "attempt": seq.attempt})
            self.cancel(seq.rid)
        return out

    # ------------------------------------------------------- stepping
    @property
    def has_work(self) -> bool:
        return bool(self._waiting or self._running)

    def _page_table(self, seq: _Seq) -> np.ndarray:
        pt = np.full((self.max_pages_per_seq,), -1, np.int32)
        pt[:len(seq.pages)] = seq.pages
        return pt

    def _prefill(self, seq: _Seq, toks: List[int]) -> int:
        """Prefill prompt+emitted into the sequence's pages; returns the
        greedy next token."""
        s_pad = _bucket(len(toks), hi=self.config.max_seq_len)
        padded = np.zeros((s_pad,), np.int32)
        padded[:len(toks)] = toks
        table = self._page_table(seq)
        if self.group is not None:
            self.group.send_step(_rg.KIND_PREFILL, (padded, table),
                                 len(toks))
        logits, self._cache = _dec.prefill(
            self.model, self.params,
            torch.as_tensor(padded, device=self.device), len(toks),
            torch.as_tensor(table, device=self.device),
            self._cache, self.page_size, group=self.group)
        return int(logits.argmax())

    def _decode(self, tokens: np.ndarray, positions: np.ndarray,
                pts: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One decode step over the padded batch; greedy next tokens."""
        dev = self.device
        if self.group is not None:
            self.group.send_step(_rg.KIND_DECODE,
                                 (tokens, positions, pts, active))
        logits, self._cache = _dec.decode_step(
            self.model, self.params, self._cache,
            torch.as_tensor(tokens, device=dev),
            torch.as_tensor(positions, device=dev),
            torch.as_tensor(pts, device=dev),
            torch.as_tensor(active, device=dev), self.page_size,
            group=self.group)
        return logits.argmax(dim=-1).cpu().numpy()

    def _emit(self, events: List[dict], seq: _Seq, token: int) -> None:
        first = not seq.emitted
        seq.emitted.append(token)
        self.counters["tokens"] += 1
        done, reason = False, None
        if token in seq.stop:
            done, reason = True, FINISH_STOP
        elif len(seq.emitted) >= seq.max_tokens:
            done, reason = True, FINISH_LENGTH
        events.append({"rid": seq.rid, "token": token,
                       "seq": len(seq.emitted) - 1, "first": first,
                       "done": done, "reason": reason,
                       "attempt": seq.attempt})
        if done:
            self.counters["finished"] += 1
            self.cancel(seq.rid)

    def _evict_one(self, keep: _Seq) -> bool:
        """Preempt the youngest running sequence other than `keep`,
        returning its pages to the pool; the victim re-queues at the
        FRONT of the waiting line with its emitted tokens intact (it
        re-prefills prompt+emitted and continues)."""
        for victim in reversed(self._running):
            if victim is keep:
                continue
            self._running.remove(victim)
            self.alloc.free(victim.pages)
            victim.pages = []
            victim.evictions += 1
            self._waiting.appendleft(victim)
            self.counters["evictions"] += 1
            return True
        return False

    @torch.inference_mode()
    def step(self) -> List[dict]:
        """One engine iteration: admit, then decode everyone once."""
        events: List[dict] = []
        self.counters["steps"] += 1

        # ---- per-iteration admission: prefill into free pages
        while self._waiting and len(self._running) < self.max_batch:
            seq = self._waiting[0]
            toks = seq.prompt + seq.emitted
            need = pages_needed(len(toks), self.page_size)
            pages = self.alloc.alloc(need)
            if pages is None:
                break                      # pool dry: decode continues
            self._waiting.popleft()
            seq.pages = pages
            now = time.monotonic()
            if seq.admit_t is None:        # first admission only
                seq.admit_t = now
                self._queue_waits.append((now, now - seq.submit_t))
            token = self._prefill(seq, toks)
            self._running.append(seq)
            self.counters["admitted"] += 1
            self._emit(events, seq, token)

        # ---- decode every in-flight sequence by one token
        batch = [s for s in self._running]
        for seq in list(batch):
            if seq not in self._running:
                continue       # evicted by an earlier seq's page grab
            # page for the incoming token's KV write, evicting the
            # youngest other sequence if the pool is dry
            while pages_needed(seq.total_len, self.page_size) \
                    > len(seq.pages):
                got = self.alloc.alloc(1)
                if got is not None:
                    seq.pages.extend(got)
                    continue
                if not self._evict_one(seq):
                    # alone and out of pages: feasibility was checked
                    # at submit, so this cannot happen; guard anyway
                    self.cancel(seq.rid)
                    events.append({"rid": seq.rid, "token": None,
                                   "seq": len(seq.emitted), "first": False,
                                   "done": True, "reason": "oom",
                                   "attempt": seq.attempt})
                    batch.remove(seq)
                    break
        batch = [s for s in batch if s in self._running]
        if not batch:
            return events
        B = self.max_batch
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        pts = np.full((B, self.max_pages_per_seq), -1, np.int32)
        active = np.zeros((B,), bool)
        for i, seq in enumerate(batch):
            tokens[i] = seq.emitted[-1]
            positions[i] = seq.total_len - 1
            pts[i] = self._page_table(seq)
            active[i] = True
        next_tokens = self._decode(tokens, positions, pts, active)
        for i, seq in enumerate(batch):
            self._emit(events, seq, int(next_tokens[i]))
        return events

    # ------------------------------------------------------- signals
    def queue_wait_p95(self, window_s: float = 30.0) -> float:
        now = time.monotonic()
        waits = [w for t, w in self._queue_waits if now - t <= window_s]
        if not waits:
            return 0.0
        waits.sort()
        return waits[min(len(waits) - 1,
                         int(0.95 * (len(waits) - 1) + 0.999))]

    def outstanding_tokens(self) -> int:
        return sum(s.remaining for s in self._running) \
            + sum(s.remaining for s in self._waiting)

    def stats(self) -> dict:
        return {"waiting": len(self._waiting),
                "running": len(self._running),
                "free_pages": self.alloc.free_pages,
                "num_pages": self.num_pages,
                "outstanding_tokens": self.outstanding_tokens(),
                "queue_wait_p95": self.queue_wait_p95(),
                **self.counters}


def _to_device(tree, device: torch.device):
    """Every tensor of a params tree (dicts and lists) on `device`, each
    in its own dtype; the tree fetched from the object store is left
    behind, so its shared-memory views are released."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


class LLMEngine:
    """Serve deployment class: one continuous-batching engine.

    Port of `LLMEngine` of `ray_tpu/serve/llm/engine.py`, in process or
    as a Serve replica (`serve_llm`). `model` is a preset name, a
    TransformerConfig kwargs dict or a config. `weights` is an ObjectRef
    of a params dict (each tensor is moved to `device` in its own
    dtype), the params dict itself (e.g. `params_from_jax` or
    `init_for_serving` output, already on `device`), or None to
    initialise from `seed`. `device=None` is the card. A step thread
    drives the core; tokens reach consumers over the push stream
    (`stream.py`, subscribe at the `stream` address `generate` returns)
    or through `next_tokens` polling.

    `mesh` is an axes dict (e.g. {"dp": 1, "tp": 2}): the replica is
    then `tp` rank processes (`replica_group.py`), this one rank 0, the
    others actors started with `ray_actor_options` (default: a card
    each on the card, nothing on the CPU); each rank holds its shard of
    the weights and a cache of its kv heads, and `kv_budget_bytes` is
    per rank. `dp` must be 1 (Serve's replicas are the dp) and every
    other axis 1. A step that fails (a rank died, a collective passed
    its timeout) ends every open request with the error, and
    `check_health` raises from then on, so Serve replaces the replica.
    """

    def __init__(self, model="tiny", weights=None, mesh=None,
                 num_pages: int = 0, page_size: int = 0,
                 max_batch: int = 0, kv_budget_bytes: int = 0,
                 seed: int = 0, device=None,
                 ray_actor_options: Optional[dict] = None):
        if isinstance(model, str):
            config = PRESETS[model]()
        elif isinstance(model, dict):
            config = TransformerConfig(**model)
        else:
            config = model
        tp = _rg.tp_of_mesh(mesh, config)
        if not (weights is None or isinstance(weights, Mapping)
                or hasattr(weights, "object_id")):
            raise TypeError(
                f"LLMEngine takes an ObjectRef, the params dict or None as "
                f"weights, got {type(weights).__name__}")
        device = resolve_device(device)
        page_size = int(page_size or CONFIG.llm_page_size)
        max_batch = int(max_batch or CONFIG.llm_max_batch)
        if not num_pages and kv_budget_bytes:
            num_pages = pages_from_budget(config, page_size,
                                          kv_budget_bytes,
                                          tp_shards=tp or 1)
        self._error: Optional[str] = None
        self._ranks = None
        t0 = time.perf_counter()
        if tp is None:
            params = self._weights(config, weights, seed, device)
        else:
            params = self._start_ranks(config, weights, seed, device, tp,
                                       num_pages, page_size, max_batch,
                                       ray_actor_options)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.weights_s = time.perf_counter() - t0
        try:
            self.core = EngineCore(
                config, params, device=device, num_pages=num_pages,
                page_size=page_size, max_batch=max_batch,
                group=None if self._ranks is None else self._ranks.group)
        except BaseException:
            if self._ranks is not None:
                self._ranks.abort()
            raise
        if self._ranks is not None:
            self._ranks.start()
        self.incarnation = uuid.uuid4().hex[:8]
        self._lock = threading.Lock()        # core + buffers
        self._cond = threading.Condition(self._lock)
        # rid -> {"toks": [...], "done", "reason", "err", "t_done",
        #         "attempt", "submit_t", "last_tok_t"}
        self._buf: Dict[str, dict] = {}
        self._metrics = serving_metrics()
        self._stream = None
        if CONFIG.llm_stream:
            self._stream = TokenStreamServer(self.incarnation,
                                             self._backlog)
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="llm-engine-step",
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def _weights(config, weights, seed: int, device):
        """The whole model on `device`, from `weights` or `seed`."""
        if weights is None:
            return init_for_serving(Transformer(config), seed, device)
        if isinstance(weights, Mapping):
            return weights
        import ray_tpu_torch
        return _to_device(ray_tpu_torch.get(weights), device)

    def _start_ranks(self, config, weights, seed: int, device, tp: int,
                     num_pages: int, page_size: int, max_batch: int,
                     actor_options):
        """Start ranks 1..tp-1, load every rank's shard (theirs in their
        processes while this one loads rank 0's) and return rank 0's."""
        import ray_tpu_torch
        if isinstance(weights, Mapping) and tp > 1:
            weights = ray_tpu_torch.put(weights)   # for the followers
        self._ranks = _rg.RankGroup(tp, device, actor_options)
        try:
            if not num_pages:
                num_pages = max_batch * pages_needed(config.max_seq_len,
                                                     page_size)
            loads = self._ranks.setup(config, weights, seed, num_pages,
                                      page_size, max_batch)
            params = _rg.rank_params(Transformer(config), weights, seed, tp,
                                     0, device)
            self._ranks.cache_bytes = ray_tpu_torch.get(loads, timeout=600)
        except BaseException:
            self._ranks.abort()
            raise
        return params

    # ---------------------------------------------------- step thread
    def _loop(self) -> None:
        try:
            if self.core.device.type == "cuda":
                # this thread's CUDA context, before its first cuBLAS call
                torch.cuda.set_device(self.core.device)
            while not self._stop.is_set():
                with self._lock:
                    busy = self.core.has_work
                    if not busy and self.core.group is not None:
                        self.core.group.keepalive()
                if not busy:
                    self._kick.wait(0.05)
                    self._kick.clear()
                    continue
                with self._lock:
                    events = self.core.step()
                    self._ingest(events)
                delay = CONFIG.llm_step_delay_s
                if delay > 0:               # chaos pacing, 0 in production
                    time.sleep(delay)
        except Exception as e:
            self._fail(e)
            raise

    def _fail(self, exc: Exception) -> None:
        """The step raised (e.g. a CUDA error, or a tp rank that died):
        end every open request with the error, so no poller or
        subscriber waits on a thread that is gone, and refuse new ones.
        A replica over tp ranks frees its other ranks."""
        err = f"{type(exc).__name__}: {exc}"
        now = time.monotonic()
        events = []
        if self._ranks is not None:
            self._ranks.abort()
        with self._lock:
            self._error = err
            for rid, b in self._buf.items():
                if not b["done"]:
                    b.update(done=True, reason="error", err=err, t_done=now)
                    events.append({"rid": rid, "token": None,
                                   "seq": len(b["toks"]), "first": False,
                                   "done": True, "reason": "error",
                                   "err": err, "attempt": b["attempt"]})
            self._cond.notify_all()
        if self._stream is not None and events:
            self._stream.publish(events)

    def _ingest(self, events: List[dict]) -> None:
        """Record step output into the polled buffers and wake parked
        pollers; push to stream subscribers."""
        now = time.monotonic()
        for ev in events:
            b = self._buf.get(ev["rid"])
            if b is None:
                continue
            if ev["token"] is not None:
                if not b["toks"] and self._metrics:
                    self._metrics["ttft"].observe(now - b["submit_t"])
                elif b["toks"] and self._metrics:
                    self._metrics["tpot"].observe(now - b["last_tok_t"])
                b["last_tok_t"] = now
                b["toks"].append(ev["token"])
                if self._metrics:
                    self._metrics["tokens"].inc()
            if ev["done"]:
                b["done"] = True
                b["reason"] = ev["reason"]
                b["t_done"] = now
        self._cond.notify_all()
        self._sweep(now)
        if self._stream is not None:
            self._stream.publish(events)

    def _sweep(self, now: float) -> None:     # holds self._lock
        dead = [rid for rid, b in self._buf.items()
                if b["done"] and now - b["t_done"] > 120.0]
        for rid in dead:
            self._buf.pop(rid, None)

    def _backlog(self, rid: str, cursor: int) -> Optional[dict]:
        """Stream-subscribe replay: everything from `cursor` on."""
        with self._lock:
            b = self._buf.get(rid)
            if b is None:
                return None
            return {"rid": rid, "attempt": b["attempt"],
                    "base": cursor, "toks": list(b["toks"][cursor:]),
                    "done": b["done"], "reason": b["reason"],
                    "err": b["err"]}

    # ------------------------------------------------------ serve API
    def ping(self):
        return "pong"

    def check_health(self) -> None:
        """Raises once a step has failed: Serve then stops counting this
        replica as live and starts another."""
        if self._error is not None:
            raise RuntimeError(f"the engine's step failed: {self._error}")

    def generate(self, prompt, max_tokens: int = 16, stop=(),
                 rid: Optional[str] = None, attempt: int = 0) -> dict:
        """Accept one generation; tokens arrive via the push stream
        (subscribe at `stream` with `rid`) or next_tokens polling."""
        submit_t = time.monotonic()
        with self._lock:
            self.check_health()
            rid = self.core.submit(prompt, max_tokens=max_tokens,
                                   stop=stop, rid=rid, attempt=attempt,
                                   submit_t=submit_t)
            self._buf[rid] = {"toks": [], "done": False, "reason": None,
                              "err": None, "t_done": 0.0,
                              "attempt": int(attempt),
                              "submit_t": submit_t, "last_tok_t": 0.0}
        self._kick.set()
        return {"rid": rid, "attempt": int(attempt),
                "incarnation": self.incarnation,
                "stream": (self._stream.addr if self._stream else None)}

    def next_tokens(self, rid: str, cursor: int = 0,
                    wait_s: Optional[float] = None,
                    limit: int = 256) -> dict:
        """Polled fallback (CONFIG.llm_stream=0): park up to wait_s for
        tokens past `cursor`: bounded server-side waits instead of
        client busy-polling."""
        wait_s = CONFIG.llm_stream_wait_s if wait_s is None else wait_s
        deadline = time.monotonic() + max(0.0, wait_s)
        with self._cond:
            while True:
                b = self._buf.get(rid)
                if b is None:
                    raise RuntimeError(
                        f"unknown request {rid!r} on this replica")
                if len(b["toks"]) > cursor or b["done"]:
                    toks = b["toks"][cursor:cursor + limit]
                    return {"toks": toks, "cursor": cursor + len(toks),
                            "done": (b["done"] and
                                     cursor + len(toks) >= len(b["toks"])),
                            "reason": b["reason"], "err": b["err"],
                            "attempt": b["attempt"],
                            "incarnation": self.incarnation}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"toks": [], "cursor": cursor, "done": False,
                            "reason": None, "err": None,
                            "attempt": b["attempt"],
                            "incarnation": self.incarnation}
                self._cond.wait(remaining)

    def cancel(self, rid: str) -> bool:
        with self._lock:
            self._buf.pop(rid, None)
            return self.core.cancel(rid)

    def drain(self) -> List[dict]:
        """Stop admission and decode, return re-dispatchable in-flight
        descriptors. Subscribers see a terminal 'drained' frame and fail
        over; the descriptors carry emitted tokens so the survivor
        resumes mid-generation."""
        with self._lock:
            descs = self.core.drain()
            now = time.monotonic()
            drained_events = []
            for d in descs:
                b = self._buf.get(d["rid"])
                if b is not None:
                    b["done"] = True
                    b["reason"] = FINISH_DRAINED
                    b["t_done"] = now
                drained_events.append(
                    {"rid": d["rid"], "token": None, "seq": 0,
                     "first": False, "done": True,
                     "reason": FINISH_DRAINED, "attempt": d["attempt"]})
            self._cond.notify_all()
        if self._stream is not None and drained_events:
            self._stream.publish(drained_events)
        return descs

    def engine_stats(self) -> dict:
        with self._lock:
            st = self.core.stats()
        st["incarnation"] = self.incarnation
        st["stream"] = self._stream.addr if self._stream else None
        # the port's own instrumentation (the JAX engine has none, so
        # EngineCore.stats() stays key for key the same): this process's
        # kernel launches, the seconds the weights took to fetch and
        # place (or init), and the device's peak allocation
        st["kernel_launches"] = {"flash_fwd": flash_attention.launches,
                                 "rms_norm": rms_norm.launches}
        st["weights_s"] = self.weights_s
        st["cache_bytes"] = _rg.cache_bytes(self.core._cache)
        if self._ranks is not None:
            # rank 0's launches above; ranks 1.. from their processes
            st["tp"] = self._ranks.tp
            st["tp_backend"] = self._ranks.backend
            st["kernel_launches_by_rank"] = (
                [st["kernel_launches"]] + self._ranks.launches())
            st["cache_bytes_by_rank"] = ([st["cache_bytes"]]
                                         + self._ranks.cache_bytes)
            st["tp_pids"] = [os.getpid()] + self._ranks.pids
            # the cards the runtime pinned each rank's process to
            st["tp_cards"] = ([os.environ.get("CUDA_VISIBLE_DEVICES")]
                              + self._ranks.cards)
        if self.core.device.type == "cuda":
            st["device_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.core.device)
        return st

    def __serve_stats__(self) -> dict:
        """Merged into a replica's pushed report: the queue-latency p95
        that latency-target autoscaling reads."""
        with self._lock:
            return {"queue_wait_p95": self.core.queue_wait_p95(),
                    "outstanding_tokens": self.core.outstanding_tokens()}

    def close(self):
        """Stop the step thread (after its current step) and the
        stream listener."""
        self._stop.set()
        self._kick.set()
        if threading.current_thread() is not self._thread:
            self._thread.join()
        if self._ranks is not None:
            self._ranks.close()
        if self._stream is not None:
            self._stream.close()

    def __del__(self):
        # The step thread holds the engine, so this runs only once that
        # thread has ended: what may still be open is the listener.
        stream = getattr(self, "_stream", None)
        if stream is not None:
            stream.close()
