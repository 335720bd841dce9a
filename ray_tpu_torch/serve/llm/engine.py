"""Continuous-batching LLM engine core.

Port of `EngineCore` of `ray_tpu/serve/llm/engine.py`: the pure
scheduler + model driver. Every `step()` first ADMITS waiting requests
(prefill into free KV pages) and then DECODES every in-flight sequence
by one token, so a short request admitted mid-flight finishes while a
long one is still generating (iteration-level scheduling). No threads;
it steps synchronously.

The same admission, eviction, cancel, drain, stats and event dicts as
the JAX core. What differs: a `device` (default: the card) in place of
the mesh, direct calls in place of the jit caches, and numpy batches
moved with `torch.as_tensor(..., device=...)`.
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.models import decode as _dec
from ray_tpu_torch.models.transformer import Transformer
from ray_tpu_torch.ops.dispatch import resolve_device
from ray_tpu_torch.serve.llm.kv_cache import PageAllocator, pages_needed

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
    `params` must already be on `device` (default: the card).
    """

    def __init__(self, config, params, device=None,
                 num_pages: int = 0, page_size: int = 16,
                 max_batch: int = 8):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
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
                                            device=self.device)
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
        logits, self._cache = _dec.prefill(
            self.model, self.params,
            torch.as_tensor(padded, device=self.device), len(toks),
            torch.as_tensor(self._page_table(seq), device=self.device),
            self._cache, self.page_size)
        return int(logits.argmax())

    def _decode(self, tokens: np.ndarray, positions: np.ndarray,
                pts: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One decode step over the padded batch; greedy next tokens."""
        dev = self.device
        logits, self._cache = _dec.decode_step(
            self.model, self.params, self._cache,
            torch.as_tensor(tokens, device=dev),
            torch.as_tensor(positions, device=dev),
            torch.as_tensor(pts, device=dev),
            torch.as_tensor(active, device=dev), self.page_size)
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
