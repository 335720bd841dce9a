"""Serving cells: `LLMEngine` in this process, requests in through
`generate`, tokens read off its push stream as a Serve router reads them.

One consumer thread timestamps every token frame; one submitter thread
calls `generate` and subscribes (so a `generate` that waits for the
engine's lock never delays a timestamp). The window's numbers are read
from those timestamps; the engine's own counters and admission waits
from `EngineCore`. After the window the engine is closed and freed,
then a sample of the requests served tokens (finished or in flight at
the close), drawn from the seed with the longest among them, is run
through the plain reference (`judge`).
"""
from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from gpubench import core, counts, judge, load, weights
from gpubench.trace import Profile, slice_s


class Req:
    __slots__ = ("rid", "prompt", "max_tokens", "due", "submit",
                 "accepted", "toks", "times", "done", "reason", "failed",
                 "finished")

    def __init__(self, rid: str, prompt: List[int], max_tokens: int,
                 due: float = 0.0):
        self.rid, self.prompt, self.max_tokens = rid, prompt, max_tokens
        self.due, self.submit, self.accepted = due, None, None
        self.finished = threading.Event()
        self.toks: List[int] = []
        self.times: List[float] = []
        self.done, self.reason, self.failed = False, None, False


class Session:
    """The engine of one cell: weights from the seed, the cache, warm-up."""

    def __init__(self, cell: dict, seed: int, device):
        from ray_tpu_torch.serve.llm.engine import LLMEngine
        conf = cell["config"]
        serving = conf["serving"]
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = core.model_config(conf)
        dims = core.dims(conf)
        self.model = counts.sizes(dims)
        self.dtype = self.cfg.activation_dtype
        params = weights.make_params(dims, seed, device, self.dtype,
                                     stacked=True)
        self.num_pages = pool_pages(self.cfg, params, serving, device)
        self.engine = LLMEngine(model=self.cfg, weights=params,
                                device=device, num_pages=self.num_pages,
                                page_size=serving["page_size"],
                                max_batch=serving["max_batch"])
        del params
        self.max_batch = serving["max_batch"]

    def warm(self, prompt_lens: List[int]) -> None:
        """One request at each prefill pad bucket the traffic can reach
        (`_bucket`: powers of two from 16), all at once, two tokens each:
        every prefill shape and the decode step at the full batch."""
        from ray_tpu_torch.serve.llm.engine import _bucket
        top = self.cfg.max_seq_len
        buckets = sorted({_bucket(n, hi=top) for n in prompt_lens})
        rng = load.rng(self.seed, 99)
        reqs = [Req(f"warm{b}", rng.integers(0, self.cfg.vocab_size,
                                             min(b, top - 2)).tolist(), 2)
                for b in buckets]
        client = Client(self.engine)
        try:
            for r in reqs:
                client.submit(r)
            client.wait(lambda: all(r.done for r in reqs), 600.0)
        finally:
            client.stop()
        if any(r.failed for r in reqs):
            raise RuntimeError("warm-up request failed: " + ", ".join(
                f"{r.rid} {r.reason}" for r in reqs if r.failed))

    def close(self) -> int:
        """Close the engine, free its weights and cache; returns the
        device's peak bytes, read before anything is freed."""
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        self.engine.close()
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return peak


def pool_pages(cfg, params, serving: dict, device) -> int:
    """The KV pool in pages. With `gpu_memory_utilization`, on a card, as
    vLLM sizes it: that share of the card's memory less the peak of one
    profiled decode step at the full batch, every row at the longest
    context (the weights and the step's working memory); the rest, in
    pages. Otherwise `max_batch` rows of `max_seq_len` (the engine's
    default pool)."""
    from ray_tpu_torch.models import decode
    from ray_tpu_torch.models.transformer import Transformer
    ps, rows = serving["page_size"], serving["max_batch"]
    per_row = -(-cfg.max_seq_len // ps)
    util = serving.get("gpu_memory_utilization")
    if not util or device.type != "cuda":
        return rows * per_row
    cache = decode.init_paged_cache(cfg, 1, ps, device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    i32 = dict(dtype=torch.int32, device=device)
    with torch.inference_mode():
        decode.decode_step(
            Transformer(cfg), params, cache, torch.zeros(rows, **i32),
            torch.full((rows,), cfg.max_seq_len - 1, **i32),
            torch.zeros((rows, per_row), **i32),
            torch.ones(rows, dtype=torch.bool, device=device), ps)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del cache
    torch.cuda.empty_cache()
    total = torch.cuda.mem_get_info(device)[1]
    return int((util * total - peak)
               // decode.cache_page_bytes(cfg, ps))


class Client:
    """Submitter and consumer threads over one engine's push stream."""

    def __init__(self, engine):
        from ray_tpu_torch.serve.llm.stream import stream_client
        self.engine, self.stream = engine, stream_client()
        self.sink: queue.Queue = queue.Queue()
        self.reqs: Dict[str, Req] = {}
        self.cond = threading.Condition()
        self._halt = threading.Event()
        self._consumer = threading.Thread(target=self._consume,
                                          name="gpubench-consumer",
                                          daemon=True)
        self._consumer.start()

    def submit(self, r: Req) -> None:
        r.submit = time.perf_counter()
        try:
            acc = self.engine.generate(r.prompt, max_tokens=r.max_tokens,
                                       rid=r.rid)
        except Exception as e:                  # refused: counts as failed
            self._finish(r, f"refused: {e}", failed=True)
            return
        r.accepted = time.perf_counter()
        with self.cond:
            self.reqs[r.rid] = r
        if not self.stream.subscribe(acc["stream"], r.rid,
                                     acc["incarnation"], 0, 0, self.sink):
            self._finish(r, "unsubscribable", failed=True)

    def _finish(self, r: Req, reason, failed: bool) -> None:
        with self.cond:
            r.done, r.reason, r.failed = True, reason, failed
            self.cond.notify_all()
        r.finished.set()

    def _consume(self) -> None:
        while not self._halt.is_set():
            try:
                msg = self.sink.get(timeout=0.05)
            except queue.Empty:
                continue
            now = time.perf_counter()
            with self.cond:
                r = self.reqs.get(msg.get("req") or msg.get("rid"))
            if r is None or r.done:
                continue
            if msg.get("type") != "llm_tok" or msg.get("unknown") \
                    or msg.get("err"):
                self._finish(r, msg.get("err") or msg.get("type"), True)
                continue
            if msg["base"] > len(r.toks):
                self._finish(r, "gap in the stream", True)
                continue
            fresh = msg["toks"][len(r.toks) - msg["base"]:]
            with self.cond:
                r.toks.extend(fresh)
                r.times.extend([now] * len(fresh))
            if msg["done"]:
                self._finish(r, msg["reason"],
                             failed=msg["reason"] not in ("length", "stop"))

    def wait(self, pred: Callable[[], bool], timeout: float) -> bool:
        deadline = time.perf_counter() + timeout
        with self.cond:
            while not pred():
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self.cond.wait(min(left, 0.1))
        return True

    def stop(self) -> None:
        self._halt.set()
        self._consumer.join()
        for rid in list(self.reqs):
            self.stream.unsubscribe(rid)


# --------------------------------------------------------- spans (trace 1)
def install_spans(core_, windows: Sequence[int] = ()
                  ) -> Callable[[], None]:
    """`record_function` ranges around the engine's step and its two
    calls into the model, named with what the counts need: the prompt's
    true length, and a decode step's active rows and their contexts
    (`model.decode:<rows>:<contexts>`), then for each of `windows`
    (ascending) the rows' sum of min(context, W). Returns the undo."""
    from torch.profiler import record_function
    step, prefill, decode = core_.step, core_._prefill, core_._decode

    def span_step():
        with record_function("engine.step"):
            return step()

    def span_prefill(seq, toks):
        with record_function(f"model.prefill:{len(toks)}"):
            return prefill(seq, toks)

    def span_decode(tokens, positions, pts, active):
        ctx = positions[active].astype(np.int64) + 1
        fields = [int(active.sum()), int(ctx.sum())] + [
            int(np.minimum(ctx, w).sum()) for w in windows]
        with record_function("model.decode:" + ":".join(map(str, fields))):
            return decode(tokens, positions, pts, active)

    core_.step, core_._prefill, core_._decode = (span_step, span_prefill,
                                                 span_decode)

    def undo():
        for name in ("step", "_prefill", "_decode"):
            core_.__dict__.pop(name, None)
    return undo


# ------------------------------------------------------------- the window
def run_window(session: Session, schedule, seconds: float, trace: bool,
               closed_loop: bool, wait_first_s: float) -> dict:
    """Drive one window. `schedule`: for an open loop, a list of Req with
    `due` set (seconds from the window's start); for a closed loop, a
    list of per-client request lists, each client sending its next when
    the last ends. Returns the record the metric readers take."""
    eng = session.engine
    ecore = eng.core
    counters0 = dict(ecore.counters)
    t0 = end = 0.0
    issued: List[Req] = []
    users: List[threading.Thread] = []
    used: List[int] = []
    halt = threading.Event()
    prof = Profile() if trace else None
    prof_at = (seconds - slice_s(seconds), seconds)
    undo = (install_spans(ecore, counts.windows_of(session.model))
            if trace else None)
    client = Client(eng)

    # every user has a thread of its own, so a `generate` that waits for
    # the engine's lock holds back that user alone
    def closed_user(reqs: List[Req]) -> None:
        for r in reqs:
            if halt.is_set() or time.perf_counter() >= end:
                return
            r.due = time.perf_counter() - t0
            issued.append(r)
            client.submit(r)
            while not r.finished.wait(0.5):
                if halt.is_set():
                    return

    def open_user(r: Req) -> None:
        issued.append(r)
        client.submit(r)

    def start(target, *args) -> None:
        th = threading.Thread(target=target, args=args, daemon=True,
                              name="gpubench-user")
        users.append(th)
        th.start()

    def arrivals() -> None:
        for r in schedule:
            delay = t0 + r.due - time.perf_counter()
            if delay > 0 and halt.wait(delay):
                return
            start(open_user, r)

    t0 = time.perf_counter()
    end = t0 + seconds
    if closed_loop:
        for reqs in schedule:
            start(closed_user, reqs)
        sched = None
    else:
        sched = threading.Thread(target=arrivals, daemon=True,
                                 name="gpubench-arrivals")
        sched.start()
    traced = None
    try:
        # the pool's pages held by live sequences, once a second; the
        # profiler (trace runs) over the window's last slice
        marks = ([t0 + prof_at[0]] if prof is not None else []) + [end]
        while True:
            used.append(ecore.alloc.used_pages)
            now = time.perf_counter()
            if len(marks) > 1 and now >= marks[0]:
                prof.start()
                marks.pop(0)
            if now >= end:
                break
            time.sleep(max(0.0, min(1.0, marks[0] - now)))
        counters1 = dict(ecore.counters)
        qwait = ecore.queue_wait_p95(window_s=seconds)
        waiting = len(ecore._waiting)
        if prof is not None:
            traced = prof.stop()
        # requests due in the window get their first token, however late
        halt.set()
        if sched is not None:
            sched.join()
        for th in list(users):
            th.join()
        due = list(issued)
        client.wait(lambda: all(r.toks or r.done for r in due),
                    wait_first_s)
        waited = time.perf_counter() - t0
    finally:
        halt.set()
        client.stop()
        if undo is not None:
            undo()
    window = {"t0": t0, "seconds": seconds}
    return {"requests": issued, "window": window, "trace": traced,
            "closed_loop": closed_loop,
            "waited_s": waited,
            "counters": {k: counters1[k] - counters0[k] for k in counters1},
            "queue_wait_p95_s": qwait, "waiting_at_end": waiting,
            "max_batch": session.max_batch,
            "pages_used": used, "num_pages": session.num_pages,
            "traced_slice": prof_at if trace else None}


def summarize(rec: dict) -> dict:
    """The window's timings, relative to its start: tokens received in
    it, every gap between two tokens of a request that ends in it (a
    frame of n tokens counts n gaps of a nth each), and every due
    request's time to its first token (a request without one counts the
    time until the wait for it ended, and in an open loop as failed; in
    a closed loop it is the loop's own request still in flight)."""
    t0, T = rec["window"]["t0"], rec["window"]["seconds"]
    tokens, gaps, ttft, failed = 0, [], [], 0
    for r in rec["requests"]:
        times = [t - t0 for t in r.times]
        tokens += sum(1 for t in times if 0 <= t <= T)
        i = 1
        while i < len(times):
            j = i
            while j + 1 < len(times) and times[j + 1] == times[i]:
                j += 1
            if times[i] <= T:
                n = j - i + 1
                gaps += [(times[i] - times[i - 1]) / n] * n
            i = j + 1
        if r.failed:
            failed += 1
        if times:
            ttft.append(times[0] - r.due)
        else:
            failed += 0 if r.failed or rec.get("closed_loop") else 1
            ttft.append(rec.get("waited_s", T) - r.due)
    return {"tokens_in_window": tokens, "gaps_s": gaps, "ttft_s": ttft,
            "attempted": len(rec["requests"]), "failed": failed,
            "late_s": [r.submit - t0 - r.due for r in rec["requests"]
                       if r.submit is not None],
            "accept_s": [r.accepted - r.submit for r in rec["requests"]
                         if r.accepted is not None]}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, closed_loop: bool, schedule_fn,
             control: bool = False) -> dict:
    """Set up, warm, run the window, check; the record for the readers."""
    seed = core.seed_of(seed)
    phases = {"imports": time.perf_counter() - t_start}
    before = allocated(device)
    session = Session(cell, seed, device)
    phases["weights_and_engine"] = time.perf_counter() - t_start
    schedule, prompt_lens = schedule_fn(session.cfg, cell["params"], seed,
                                        seconds)
    session.warm(prompt_lens)
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    phases["warm"] = setup_s
    p = cell["params"]
    rec = run_window(session, schedule, seconds, trace, closed_loop,
                     wait_first_s=float(p.get("wait_first_s", 60.0)))
    rec["setup_s"], rec["setup_phases_s"] = setup_s, phases
    rec.update(summarize(rec))
    rec["model"] = session.model
    served = [r for r in rec["requests"] if r.toks and not r.failed]
    gc.unfreeze()
    peak = session.close()
    rec["peak_bytes"] = peak
    del session
    used, c = rec["pages_used"], rec["counters"]
    rec["notes"] = {"failed": sorted({str(r.reason) for r in
                                      rec["requests"] if r.failed}),
                    # the engine's side beside what the consumers got
                    "output_tok_s": rec["tokens_in_window"] / seconds,
                    "engine_tokens": c["tokens"],
                    "stream_delivered_pct": 100.0 * rec[
                        "tokens_in_window"] / max(1, c["tokens"]),
                    "batch_occupancy_pct": 100.0 * (
                        c["tokens"] - c["admitted"]) / max(
                        1, c["steps"] * rec["max_batch"]),
                    "without_a_token": sum(1 for r in rec["requests"]
                                           if not r.toks),
                    "pool_pages": rec["num_pages"],
                    "pages_used_mean_max": [sum(used) / len(used),
                                            max(used)],
                    "waiting_at_end": rec["waiting_at_end"],
                    "late_p90_s": core.percentile(rec["late_s"], 90),
                    "generate_wait_p50_p90_s": [
                        core.percentile(rec["accept_s"], q)
                        for q in (50, 90)],
                    "ttft_p50_p75_p90_p95_max_s": [
                        core.percentile(rec["ttft_s"], q)
                        for q in (50, 75, 90, 95, 100)]}
    # the judge's room: what the session leaves allocated, the judge
    # lacks (its weights and the reference's activations)
    held = allocated(device) - before
    rec["notes"]["held_after_close_bytes"] = held
    if held > 0:
        rec["checks"] = {"logit_gap": core.check(
            None, cell["limits"]["logit_gap"],
            why=f"{held} bytes of the engine still allocated on the card "
                f"after its close; the judge did not run")}
        rec["sample"] = {}
        return rec
    rec["checks"], rec["sample"] = judge.serving(
        cell, seed, served, device,
        sample_tokens=int(p.get("sample_tokens", 400)), control=control)
    return rec


def allocated(device) -> int:
    """Bytes allocated to tensors on the card (0 off it), once cuBLAS has
    let go of its workspaces: it keeps one for each stream it ran on,
    which no session owns and the next product makes again."""
    if device.type != "cuda":
        return 0
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated(device)

