"""Cluster metrics plane (r11): runtime-instrumented time series,
cluster-wide scrape, and the latency signals consumers read.

The r9 tracing plane answers "what happened to this task"; this module
answers "what is the cluster doing right now". Three pieces:

1. **Runtime instrumentation** — first-class runtime series registered
   through the existing :mod:`ray_tpu_torch.util.metrics` API in every
   process. Two source shapes:

   * *Live histograms*, observed at event time because they cannot be
     reconstructed later: task latency split by phase — queue wait
     (from the scheduler's ``_queued_at`` stamp, observed at dispatch),
     exec (worker-side), e2e submit→done (head-side) — each an
     O(log buckets) observe behind one memoized :func:`enabled` gate.
   * *Sampled mirrors* of the plain int counters the hot paths already
     keep (``protocol.WIRE_STATS``/``POLLER_STATS``,
     ``OBJECT_PLANE_STATS``, shm ``SEGMENT_POOL``, delegated-lease
     ledgers): gauges refreshed by per-process **samplers** only when a
     scrape happens, so the hot paths never touch a metrics lock.

   ``RAY_TPU_METRICS=0`` disables everything: no series are ever
   registered and every observe short-circuits on the gate — zero
   metric bytes, the ``RAY_TPU_TRACE=0`` discipline.

2. **Cluster collection** — pull-based, like ``trace_dump``: the head
   fans a ``METRICS_DUMP`` frame to its local workers and every agent
   (agents drain their own workers off the poller thread and reply
   with the whole node), then merges the per-process registry
   snapshots with ``node``/``worker`` labels. Histogram series merge
   by summing aligned buckets; sources that stop answering expire
   after ``RAY_TPU_METRICS_TTL_S`` so removed workers/nodes cannot
   linger in ``/metrics`` forever. The head keeps a short retention
   ring of per-scrape aggregates for dashboard sparklines and windowed
   latency signals.

3. **Consumers** — the dashboard's ``/metrics`` exposition switches
   from head-local to cluster-aggregated, ``/api/metrics_summary``
   serves the JSON view, and the autoscaler reads
   :meth:`ClusterCollector.queue_wait_p95` as its queue-latency
   scale-up signal (``RAY_TPU_AUTOSCALE_QUEUE_LATENCY_S``).

Reference parity: the reference runtime ships per-component
OpenCensus metrics through each raylet to a head-side exporter
(src/ray/stats/metric_defs.cc + dashboard/modules/reporter); here the
transport is the existing control wire and the registry is our own.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import tracing_plane as _tp

# --------------------------------------------------------------- gate
# (gen, enabled): memoized per CONFIG generation — the per-emission
# gate costs a tuple index, not an env lookup (same discipline as
# tracing_plane.enabled / native.frame_engine_enabled).
_state: tuple = (-1, False)


def enabled() -> bool:
    global _state
    from ray_tpu_torch._private.config import CONFIG
    gen = CONFIG._gen
    st = _state
    if st[0] == gen:
        return st[1]
    _state = (gen, bool(CONFIG.metrics))
    return _state[1]


# -------------------------------------------------- runtime series
# Latency histograms share the registry's default boundaries
# (1 ms … 60 s): queue waits and exec times in this runtime span that
# whole range, and identical boundaries everywhere make the cluster
# merge exact bucket-for-bucket.
class _RuntimeMetrics:
    """The runtime's own series, registered lazily on first use while
    the plane is enabled — a process that never emits (or runs with
    RAY_TPU_METRICS=0) never registers anything."""

    def __init__(self):
        from ray_tpu_torch._private.config import CONFIG
        from ray_tpu_torch.util.metrics import (
            DEFAULT_HISTOGRAM_BOUNDARIES, DEFAULT_REGISTRY, Gauge,
            Histogram)
        reg = DEFAULT_REGISTRY
        # quantile() resolves at bucket granularity, so the p95-vs-
        # threshold comparison is only exact AT a bucket bound: when
        # the autoscale threshold is configured, make it one (every
        # process sees the same env, keeping the cluster merge
        # aligned; a straggler still merges via the union-of-bounds
        # fallback). Boundaries are immutable once a series exists, so
        # the threshold is captured at this process's FIRST registry
        # use — set the env before init; changing it via a later
        # CONFIG.reload() moves the trigger but p95 then resolves at
        # the nearest pre-existing bound.
        qw_bounds = set(DEFAULT_HISTOGRAM_BOUNDARIES)
        if CONFIG.autoscale_queue_latency_s > 0:
            qw_bounds.add(float(CONFIG.autoscale_queue_latency_s))
        self.queue_wait = Histogram(
            "ray_tpu_task_queue_wait_s",
            "Task queue wait: enqueue to dispatch, per scheduler node",
            boundaries=sorted(qw_bounds), tag_keys=("node",),
            registry=reg)
        self.exec = Histogram(
            "ray_tpu_task_exec_s",
            "Task execution wall time (worker-side)", registry=reg)
        self.e2e = Histogram(
            "ray_tpu_task_e2e_s",
            "Task end-to-end: submit to head-side done, per executing "
            "node", tag_keys=("node",), registry=reg)
        g = lambda name, desc, tags=(): Gauge(  # noqa: E731
            name, desc, tag_keys=tags, registry=reg)
        self.wire = g("ray_tpu_wire_frames",
                      "Process socket frames/messages (WIRE_STATS "
                      "mirror)", ("counter",))
        self.poller = g("ray_tpu_poller",
                        "Shared read-loop stats: passes, frames, "
                        "bytes, busy_ms, max_pass_ms", ("counter",))
        self.object_plane = g("ray_tpu_object_plane",
                              "Object-plane counters (pulls, serves, "
                              "dedup hits, bytes)", ("counter",))
        self.pull_inflight = g("ray_tpu_pull_inflight",
                               "Pull-manager in-flight transfers")
        self.pull_inflight_bytes = g("ray_tpu_pull_inflight_bytes",
                                     "Pull-manager in-flight bytes")
        self.shm_pool = g("ray_tpu_shm_pool",
                          "shm segment pool: bytes, segments, reused, "
                          "misses, released", ("counter",))
        self.lease_outstanding = g(
            "ray_tpu_lease_outstanding",
            "Delegated tasks granted to an agent and not yet reported "
            "done (head-side ledger)", ("node",))
        self.lease_batches = g(
            "ray_tpu_lease_batches",
            "NODE_LEASE_BATCH frames sent per agent", ("node",))
        self.lease_tasks = g(
            "ray_tpu_tasks_leased",
            "Tasks granted via bulk leases per agent", ("node",))
        self.lease_revoked = g(
            "ray_tpu_lease_revoked",
            "Delegated tasks reclaimed by revoke/steal, as reported "
            "by each agent", ("node",))
        self.delegate = g("ray_tpu_delegate",
                          "Agent-side delegated-lease counters",
                          ("counter",))
        self.head_wal = g("ray_tpu_head_wal",
                          "Head-HA WAL telemetry (r15): wal_bytes/"
                          "records/fsyncs, fsync_p99_ms, compactions, "
                          "last_snapshot_age_s, replayed/deduped "
                          "completion counts", ("counter",))
        self.head_shard = g(
            "ray_tpu_head_shard",
            "Striped head-table occupancy/contention (r16): entries, "
            "max_stripe, contended lock acquisitions per table — "
            "proves the stripes spread load", ("table", "counter"))
        self.decref_delta = g(
            "ray_tpu_decref_delta",
            "Batched decref-delta counters (r16): agent-side frames/"
            "entries/releases coalesced (plus buffered + forwarded "
            "fallbacks); head-side frames/entries applied and "
            "replayed frames deduped", ("counter",))
        self.direct_actor = g(
            "ray_tpu_direct_actor",
            "Direct actor call plane counters (r18): caller-side "
            "direct calls/replies/inline bytes/fallbacks/redirects/"
            "resolves, host-side served/nacks/served bytes, and the "
            "head's head-routed-send + mirror-delta counts",
            ("party", "counter"))
        self.node_liveness = g(
            "ray_tpu_node_liveness",
            "Per-node liveness (r17): 1 for the node's current state "
            "(alive / suspect / draining / dead)", ("node", "state"))
        self.node_heartbeat_age = g(
            "ray_tpu_node_heartbeat_age_s",
            "Seconds since each node's last heartbeat (r17 liveness "
            "plane)", ("node",))
        self.membership = g(
            "ray_tpu_membership",
            "Partition-tolerant membership counters (r17): suspected/"
            "recovered/deaths/fenced node transitions, fenced frames "
            "dropped, fence notices sent, stale-attempt terminal "
            "drops", ("counter",))
        self.channel = g(
            "ray_tpu_channel",
            "Wire-channel ring telemetry (r13/r20): tx/rx frame and "
            "logical read/write counts, writer_block_ms (time writers "
            "spent waiting on reader acks — ring pressure), "
            "reader_wait_ms, plus live ring occupancy; the staleness "
            "signal the Sebulba RL subsystem tunes against",
            ("counter",))
        self.rl = g(
            "ray_tpu_rl",
            "Sebulba RL counters (r20): env steps, trajectory shards "
            "written/consumed, inference requests/forwards/batched "
            "obs, weight publishes, learner version, staleness, "
            "failovers", ("counter",))


class _ServingMetrics:
    """Serving-plane series (r19 LLM engine): registered lazily like
    the runtime set, but only in processes that actually serve —
    importing the engine in a process that never generates registers
    nothing."""

    def __init__(self):
        from ray_tpu_torch.util.metrics import (Counter, DEFAULT_REGISTRY,
                                          Histogram)
        reg = DEFAULT_REGISTRY
        # Token-level latencies live well under the default 1 ms …
        # 60 s task boundaries' useful range, so give TTFT/TPOT their
        # own sub-millisecond-to-seconds ladder.
        bounds = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0]
        self.ttft = Histogram(
            "ray_tpu_llm_ttft_s",
            "LLM time-to-first-token: submit to first emitted token "
            "(engine-side, includes queue wait + prefill)",
            boundaries=bounds, registry=reg)
        self.tpot = Histogram(
            "ray_tpu_llm_tpot_s",
            "LLM time-per-output-token: inter-token gap during decode",
            boundaries=bounds, registry=reg)
        self.tokens = Counter(
            "ray_tpu_llm_tokens",
            "LLM tokens emitted by this engine replica", registry=reg)


_mx: Optional[_RuntimeMetrics] = None
_mx_lock = threading.Lock()
_sv: Optional[_ServingMetrics] = None


def serving_metrics() -> Optional[dict]:
    """TTFT/TPOT histograms + token counter for the LLM engine, or
    None while the plane is disabled (callers skip their observes)."""
    if not enabled():
        return None
    global _sv
    m = _sv
    if m is None:
        with _mx_lock:
            m = _sv
            if m is None:
                _sv = m = _ServingMetrics()
    return {"ttft": m.ttft, "tpot": m.tpot, "tokens": m.tokens}


def _metrics() -> _RuntimeMetrics:
    global _mx
    m = _mx
    if m is None:
        with _mx_lock:
            m = _mx
            if m is None:
                _mx = m = _RuntimeMetrics()
    return m


# ------------------------------------------------ hot-path observes
def observe_queue_wait(seconds: float, node_id: str) -> None:
    """Scheduler dispatch: enqueue → lease, from the `_queued_at`
    stamp the queue already keeps (enqueue pays nothing)."""
    if enabled():
        _metrics().queue_wait.observe(seconds, {"node": node_id})


def observe_exec(seconds: float) -> None:
    """Worker-side task execution wall time."""
    if enabled():
        _metrics().exec.observe(seconds)


def submit_stamp(spec) -> None:
    """Head-side submit: stamp the spec so the done path can observe
    e2e without a lookup (the attribute survives the agent round-trip
    because the head keeps the mirrored spec object)."""
    if enabled():
        spec._submit_mono = time.monotonic()


def observe_task_done(spec, node_id: str) -> None:
    """Head-side completion: submit → done, against the submit stamp
    (missing on specs submitted while the plane was disabled)."""
    if not enabled():
        return
    t0 = getattr(spec, "_submit_mono", None)
    if t0 is not None:
        _metrics().e2e.observe(time.monotonic() - t0,
                               {"node": node_id or ""})


# ---------------------------------------------------------- samplers
# Per-process refresh hooks that copy the hot paths' plain int
# counters into registry gauges at SCRAPE time. Keyed by name so a
# re-created owner (tests start/stop runtimes in one process)
# replaces its predecessor instead of stacking.
_samplers: Dict[str, Callable[[], None]] = {}
_samplers_lock = threading.Lock()


def set_sampler(name: str, fn: Optional[Callable[[], None]]) -> None:
    with _samplers_lock:
        if fn is None:
            _samplers.pop(name, None)
        else:
            _samplers[name] = fn


def _builtin_sampler() -> None:
    """Process-agnostic mirrors: wire/poller frame counters, object-
    plane counters, shm pool — all module-level plain dicts that exist
    in every runtime process."""
    from ray_tpu_torch._private import protocol
    from ray_tpu_torch._private.object_store import SEGMENT_POOL
    from ray_tpu_torch._private.object_transfer import OBJECT_PLANE_STATS
    m = _metrics()
    m.wire.set_many([({"counter": k}, v)
                     for k, v in protocol.WIRE_STATS.items()])
    ps = protocol.POLLER_STATS
    m.poller.set_many([
        ({"counter": "passes"}, ps["passes"]),
        ({"counter": "frames"}, ps["frames"]),
        ({"counter": "bytes"}, ps["bytes"]),
        ({"counter": "busy_ms"}, ps["busy_ns"] / 1e6),
        ({"counter": "max_pass_ms"}, ps["max_pass_ns"] / 1e6),
    ])
    m.object_plane.set_many([({"counter": k}, v)
                             for k, v in OBJECT_PLANE_STATS.items()])
    m.shm_pool.set_many([({"counter": k.replace("pool_", "")}, v)
                         for k, v in SEGMENT_POOL.stats().items()])
    # Optional planes: mirror only in processes that imported them
    # (sys.modules guard — a scrape must not trigger heavy imports).
    wc = sys.modules.get("ray_tpu_torch.experimental.wire_channel")
    if wc is not None:
        st = wc.CH_STATS
        rows = [({"counter": k}, v) for k, v in st.items()
                if not k.endswith("_ns")]
        rows += [({"counter": "writer_block_ms"},
                  st["writer_block_ns"] / 1e6),
                 ({"counter": "reader_wait_ms"},
                  st["reader_wait_ns"] / 1e6)]
        rows += [({"counter": k}, v)
                 for k, v in wc.ring_stats().items()]
        m.channel.set_many(rows)
    sb = sys.modules.get("ray_tpu_torch.rllib.sebulba.stats")
    if sb is not None:
        m.rl.set_many([({"counter": k}, v)
                       for k, v in sb.RL_STATS.items()])


def run_samplers() -> None:
    if not enabled():
        return
    try:
        _builtin_sampler()
    except Exception:
        pass
    with _samplers_lock:
        fns = list(_samplers.values())
    for fn in fns:
        try:
            fn()
        except Exception:
            pass        # a broken sampler must never break a scrape


# --------------------------------------------------------- snapshots
def local_dump() -> dict:
    """This process's registry snapshot (samplers refreshed), shaped
    for the METRICS_DUMP pull protocol."""
    if not enabled():
        return {"enabled": False, "metrics": {}}
    run_samplers()
    from ray_tpu_torch.util.metrics import DEFAULT_REGISTRY
    return {"enabled": True, "pid": os.getpid(),
            "role": _tp._role, "name": _tp._role_name,
            "metrics": DEFAULT_REGISTRY.collect()}


def _cdf_at(buckets: tuple, bound: float) -> int:
    """Cumulative count of a histogram's bucket tuple at `bound`: the
    count of the greatest bound <= it (the exact step-function read of
    a CDF over sorted boundaries). The one reader both the cluster
    merge and the windowed delta use, so they cannot drift."""
    best = 0
    for bo, c in buckets:
        if bo <= bound:
            best = c
        else:
            break
    return best


def _merge_hist(a: tuple, b: tuple) -> tuple:
    """Sum two cumulative histogram values. Aligned boundaries (the
    overwhelmingly common case: every process registers the same
    series definition) sum bucket-for-bucket; differing boundary sets
    merge on the union via the CDF step read."""
    ta, ca, ba = a
    tb, cb, bb = b
    if len(ba) == len(bb) and all(x[0] == y[0]
                                  for x, y in zip(ba, bb)):
        buckets = tuple((x[0], x[1] + y[1]) for x, y in zip(ba, bb))
        return (ta + tb, ca + cb, buckets)
    bounds = sorted({bo for bo, _ in ba} | {bo for bo, _ in bb})
    return (ta + tb, ca + cb,
            tuple((bo, _cdf_at(ba, bo) + _cdf_at(bb, bo))
                  for bo in bounds))


def hist_delta(new: tuple, old: tuple) -> tuple:
    """new - old for cumulative histogram values (windowed
    distributions from two ring samples). Boundary sets usually match;
    when the cluster merge's union-of-bounds fallback introduced a
    bound absent from `old`, read old's CDF at the greatest bound <=
    it — treating it as 0 would count every pre-window observation
    below the new bound as in-window."""
    tn, cn, bn = new
    to, co, bo = old
    return (tn - to, max(0, cn - co),
            tuple((b, max(0, c - _cdf_at(bo, b))) for b, c in bn))


def quantile(hist_value: Optional[tuple], q: float) -> Optional[float]:
    """Bucket-resolution quantile estimate of a cumulative histogram
    value: the upper bound of the first bucket whose cumulative count
    covers rank q (inf when the rank falls past the last bound; None
    when the histogram is empty)."""
    if not hist_value:
        return None
    total, count, buckets = hist_value
    if count <= 0:
        return None
    rank = q * count
    for b, c in buckets:
        if c >= rank:
            return float(b)
    return float("inf")


def prune_node_series(expired: set) -> None:
    """Drop this process's runtime histogram series tagged with
    cluster nodes that have TTL-expired: under node churn (the
    autoscaler's whole purpose) the head's e2e/queue-wait histograms
    would otherwise grow one dead series per retired node forever.
    Sampled gauges already self-clean via set_many replace-all."""
    m = _mx
    if m is None or not expired:
        return
    pred = lambda key: dict(key).get("node") in expired  # noqa: E731
    m.queue_wait.prune_series(pred)
    m.e2e.prune_series(pred)


def merge_dumps(entries: Sequence[dict]) -> dict:
    """Merge per-process registry snapshots into one cluster snapshot.

    Each entry is ``{"labels": {"node": ..., "worker": ...},
    "metrics": <registry collect()>}``. Every series key is extended
    with the entry's labels — except labels the metric already tags
    itself with (e.g. the queue-wait histogram carries its scheduler's
    ``node``, which for in-process nodes differs from the process's) —
    so per-process series stay distinguishable; series that still
    collide (same tags from two sources, e.g. an agent-tagged
    histogram observed in two processes) merge by type: histograms sum
    aligned buckets, counters add, gauges keep the last value."""
    merged: Dict[str, dict] = {}
    for e in entries:
        labels = e.get("labels") or {}
        for name, snap in (e.get("metrics") or {}).items():
            m = merged.get(name)
            if m is None:
                m = merged[name] = {"type": snap["type"],
                                    "description":
                                        snap.get("description", ""),
                                    "series": {}}
            elif m["type"] != snap["type"]:
                continue            # name clash across types: skip
            for tags, value in snap["series"].items():
                have = {k for k, _ in tags}
                key = tags + tuple(
                    (k, str(v)) for k, v in sorted(labels.items())
                    if k not in have)
                cur = m["series"].get(key)
                if cur is None:
                    m["series"][key] = value
                elif m["type"] == "histogram":
                    m["series"][key] = _merge_hist(cur, value)
                elif m["type"] == "counter":
                    m["series"][key] = cur + value
                else:
                    m["series"][key] = value
    return merged


def aggregate_histogram(merged: dict, name: str) -> Optional[tuple]:
    """Sum every series of one histogram metric into a single
    cluster-wide (total, count, buckets) value."""
    snap = merged.get(name)
    if not snap or snap.get("type") != "histogram":
        return None
    out: Optional[tuple] = None
    for value in snap["series"].values():
        out = value if out is None else _merge_hist(out, value)
    return out


def prometheus_text(merged: dict) -> str:
    from ray_tpu_torch.util.metrics import render_prometheus
    return render_prometheus(merged)


# ------------------------------------------------- cluster collector
class ClusterCollector:
    """Head-side scrape fan-out + merge + retention.

    ``collect()`` requests every process's registry snapshot under one
    shared deadline (the tracing plane's fan-out machinery, with
    METRICS_DUMP), folds the replies into a source cache keyed by
    (node, worker), and merges every source seen within
    ``RAY_TPU_METRICS_TTL_S`` — one missed reply doesn't flap the
    exposition, and a removed worker/node expires instead of
    lingering. Each collection appends one aggregate sample to the
    retention ring (``RAY_TPU_METRICS_RING``) that the dashboard
    sparklines and the autoscaler's windowed p95 read. Collections are
    rate-limited by ``RAY_TPU_METRICS_MIN_SCRAPE_S``: concurrent
    pullers (Prometheus + dashboard + autoscaler) share one fan-out.
    """

    def __init__(self, runtime):
        self._rt = runtime
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._collecting = False
        # (node_id, worker_id) -> (monotonic_ts, labels, metrics)
        self._sources: Dict[tuple, tuple] = {}
        # node_id -> last monotonic ts the node was seen ALIVE: series
        # labeled with a node past its TTL are filtered even when they
        # live in a healthy process's registry (the head's own e2e
        # histogram tags the executing node, which may be long dead).
        # Only ids that were EVER cluster nodes are subject to the
        # filter — a user metric may tag "node" with its own values.
        self._node_seen: Dict[str, float] = {}
        self._node_ever: set = set()
        self._ring: deque = deque(maxlen=4096)
        self._last_collect = 0.0
        self._last_merged: Optional[dict] = None

    # ------------------------------------------------------ scrape
    def collect(self, timeout: float = 3.0) -> dict:
        """Cluster-merged registry snapshot (rate-limited fan-out)."""
        from ray_tpu_torch._private.config import CONFIG
        if not enabled():
            return {}
        now = time.monotonic()
        with self._lock:
            fresh = (self._last_merged is not None
                     and now - self._last_collect
                     < max(0.0, CONFIG.metrics_min_scrape_s))
            if fresh:
                return self._last_merged
            if self._collecting:
                # a fan-out is already in flight (a slow gather can
                # outlive the rate-limit window): wait for its result
                # instead of doubling the cluster dump traffic
                self._cv.wait(timeout)
                return self._last_merged or {}
            self._collecting = True
            self._last_collect = now    # claim before the slow fan-out
        try:
            entries = self._gather(timeout)
            alive_nodes = {n.node_id for n in
                           self._rt.cluster.alive_nodes()}
            alive_nodes.add(self._rt.head_node_id)
            # every id the cluster has EVER registered (dead records
            # included) is subject to node-TTL filtering below
            ever_ids = {n.node_id for n in self._rt.cluster.nodes()}
            now = time.monotonic()
            ttl = max(0.0, CONFIG.metrics_ttl_s)
            # source-table bookkeeping is cheap — take the lock for it,
            # but run the O(total-series) merge/filter OUTSIDE so
            # concurrent ring()/stats()/_windowed() readers never stall
            # behind a large-cluster merge (safe: `_collecting` makes
            # this body single-flight, so nothing else mutates
            # _sources/_node_* between the two lock sections)
            with self._lock:
                for key, labels, metrics in entries:
                    self._sources[key] = (now, labels, metrics)
                alive = {}
                for key, (ts, labels, metrics) in self._sources.items():
                    if now - ts <= ttl:
                        alive[key] = (ts, labels, metrics)
                self._sources = alive
                self._node_ever.update(ever_ids)
                self._node_ever.update(alive_nodes)
                for nid in alive_nodes:
                    self._node_seen[nid] = now
                self._node_seen = {nid: ts for nid, ts
                                   in self._node_seen.items()
                                   if now - ts <= ttl}
                keep = set(self._node_seen)
                ever = set(self._node_ever)
            merged = merge_dumps([
                {"labels": labels, "metrics": metrics}
                for ts, labels, metrics in alive.values()])
            # node-level expiry: a dead node's series vanish after
            # the TTL even when a healthy process's registry still
            # tags them (head-side e2e labels the EXECUTING node).
            # Only ids that were ever cluster nodes are filtered —
            # user metrics may tag "node" with foreign values.
            prune_node_series(ever - keep)
            for snap in merged.values():
                kept = {}
                for k, v in snap["series"].items():
                    n = dict(k).get("node")
                    if n in (None, "") or n not in ever or n in keep:
                        kept[k] = v
                snap["series"] = kept
            sample = self._sample(merged)
            with self._lock:
                self._last_merged = merged
                ring_cap = int(CONFIG.metrics_ring)
                if ring_cap > 0:
                    if self._ring.maxlen != ring_cap:
                        self._ring = deque(self._ring, maxlen=ring_cap)
                    self._ring.append(sample)
        finally:
            with self._lock:
                self._collecting = False
                self._cv.notify_all()
        return merged

    def _gather(self, timeout: float) -> List[tuple]:
        """[(source_key, labels, metrics), ...] for every process that
        answered: the head's own registry, its local workers, and each
        agent (which drains its own workers)."""
        from ray_tpu_torch._private import protocol
        rt = self._rt
        head_nid = rt.head_node_id
        out: List[tuple] = [
            ((head_nid, ""), {"node": head_nid, "worker": ""},
             local_dump().get("metrics") or {})]
        targets: List[tuple] = []
        sched = rt.scheduler
        if sched is not None:
            for wid, conn in sched.worker_conns():
                targets.append((("worker", head_nid, wid), conn))
        for node in rt.cluster.alive_nodes():
            nsched = node.scheduler
            conn = getattr(nsched, "conn", None)
            if conn is not None and conn.peer_speaks_metrics():
                targets.append((("agent", node.node_id, ""), conn))
            elif (node.node_id != head_nid
                  and hasattr(nsched, "worker_conns")):
                # in-process (cluster-sim) node: no agent process to
                # drain it — fan to its subprocess workers directly
                for wid, wconn in nsched.worker_conns():
                    targets.append((("worker", node.node_id, wid),
                                    wconn))
        for (kind, nid, wid), t0, t1, rep in _tp.fanout_dumps(
                targets, timeout, extra={"timeout": timeout},
                mtype=protocol.METRICS_DUMP):
            if kind == "worker":
                d = rep.get("dump") or {}
                if d.get("metrics"):
                    out.append(((nid, wid),
                                {"node": nid, "worker": wid},
                                d["metrics"]))
            else:
                for d in rep.get("processes") or ():
                    if not d.get("metrics"):
                        continue
                    w = d.get("worker", "")
                    out.append(((nid, w), {"node": nid, "worker": w},
                                d["metrics"]))
        return out

    # --------------------------------------------------- retention
    @staticmethod
    def _gauge_total(merged: dict, name: str,
                     counter: Optional[str] = None) -> float:
        snap = merged.get(name)
        if not snap:
            return 0.0
        total = 0.0
        for tags, v in snap["series"].items():
            if counter is not None and ("counter", counter) not in tags:
                continue
            try:
                total += float(v)
            except (TypeError, ValueError):
                pass
        return total

    def _sample(self, merged: dict) -> dict:
        """One retention-ring entry: cumulative cluster aggregates
        (subtractable, so consumers derive windowed distributions and
        rates from any two samples)."""
        e2e = aggregate_histogram(merged, "ray_tpu_task_e2e_s")
        return {
            "ts": time.time(),
            "mono": time.monotonic(),
            "queue_wait": aggregate_histogram(
                merged, "ray_tpu_task_queue_wait_s"),
            "exec": aggregate_histogram(merged, "ray_tpu_task_exec_s"),
            "e2e": e2e,
            "tasks_done": int(e2e[1]) if e2e else 0,
            "wire_frames": self._gauge_total(
                merged, "ray_tpu_wire_frames", "tx_frames")
                + self._gauge_total(
                    merged, "ray_tpu_wire_frames", "rx_frames"),
            "pull_inflight_bytes": self._gauge_total(
                merged, "ray_tpu_pull_inflight_bytes"),
            "sources": len(self._sources),
        }

    def ring(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    # ----------------------------------------------------- signals
    def _windowed(self, phase: str, window_s: float) -> Optional[tuple]:
        """Cluster histogram delta over the last `window_s`: newest
        sample minus the cluster state AT the window start (the latest
        sample older than the cutoff). When the ring doesn't reach
        back that far the process-lifetime cumulative value stands in
        — everything recorded is "recent" from the ring's view."""
        with self._lock:
            samples = list(self._ring)
        if not samples:
            return None
        newest = samples[-1]
        cur = newest.get(phase)
        if cur is None:
            return None
        base = None
        cutoff = newest["mono"] - window_s
        for s in samples[:-1]:
            if s["mono"] >= cutoff:
                break
            if s.get(phase) is not None:
                base = s[phase]     # latest sample BEFORE the cutoff
        return cur if base is None else hist_delta(cur, base)

    def _collect_async(self, timeout: float) -> None:
        """Kick a collect on its own thread unless one is fresh or
        already in flight (collect() re-checks both under its lock, so
        the unlocked peek here only avoids pointless thread spawns)."""
        from ray_tpu_torch._private.config import CONFIG
        fresh = (self._last_merged is not None
                 and time.monotonic() - self._last_collect
                 < max(0.0, CONFIG.metrics_min_scrape_s))
        if fresh or self._collecting:
            return
        threading.Thread(target=self.collect, kwargs={"timeout": timeout},
                         name="rtpu-metrics-collect", daemon=True).start()

    def queue_wait_p95(self, window_s: Optional[float] = None,
                       timeout: float = 2.0,
                       block: bool = True) -> Optional[float]:
        """Cluster task queue-wait p95 over the recent window — the
        autoscaler's latency signal. Triggers a (rate-limited) collect
        so a 1 Hz caller keeps the ring warm on its own; None when no
        tasks waited in the window. ``block=False`` kicks the fan-out
        on a background thread and reads the newest ring sample — a
        wedged agent then costs signal freshness, never the caller's
        loop (the autoscaler's reconcile tick also drives demand
        scaling and launch bookkeeping)."""
        from ray_tpu_torch._private.config import CONFIG
        if not enabled():
            return None
        if window_s is None:
            window_s = CONFIG.autoscale_queue_latency_window_s
        if block:
            self.collect(timeout=timeout)
        else:
            self._collect_async(timeout)
        return quantile(self._windowed("queue_wait", window_s), 0.95)

    # ----------------------------------------------------- summary
    def summary(self, timeout: float = 3.0) -> dict:
        """JSON view for /api/metrics_summary: latest cluster
        aggregates + per-sample rates for the sparkline ring."""
        from ray_tpu_torch._private.config import CONFIG
        merged = self.collect(timeout=timeout)
        with self._lock:
            samples = list(self._ring)
            n_sources = len(self._sources)
        window = CONFIG.autoscale_queue_latency_window_s

        def pcts(phase: str) -> dict:
            h = self._windowed(phase, window)
            fin = lambda v: (None if v is None or v == float("inf")  # noqa: E731
                             else v)      # keep the JSON strict-valid
            return {"p50": fin(quantile(h, 0.50)),
                    "p95": fin(quantile(h, 0.95)),
                    "p99": fin(quantile(h, 0.99)),
                    "count": int(h[1]) if h else 0}

        spark: List[dict] = []
        for prev, cur in zip(samples, samples[1:]):
            dt = max(1e-6, cur["mono"] - prev["mono"])
            qd = (hist_delta(cur["queue_wait"], prev["queue_wait"])
                  if cur.get("queue_wait") and prev.get("queue_wait")
                  else None)
            q95 = quantile(qd, 0.95)
            # clamp at 0: a TTL-expired node shrinks the cluster
            # cumulative, which is not a negative rate
            spark.append({
                "ts": cur["ts"],
                "tasks_per_s": round(max(
                    0.0, cur["tasks_done"] - prev["tasks_done"]) / dt, 2),
                "queue_p95_ms": (round(q95 * 1e3, 3)
                                 if q95 not in (None, float("inf"))
                                 else None),
                "wire_frames_per_s": round(max(
                    0.0, cur["wire_frames"] - prev["wire_frames"]) / dt, 1),
                "pull_inflight_mb": round(
                    cur["pull_inflight_bytes"] / 2 ** 20, 2),
            })
        shm = merged.get("ray_tpu_shm_pool", {}).get("series", {})
        reused = sum(v for k, v in shm.items()
                     if ("counter", "reused") in k)
        misses = sum(v for k, v in shm.items()
                     if ("counter", "misses") in k)
        return {
            "enabled": enabled(),
            "sources": n_sources,
            "window_s": window,
            "queue_wait": pcts("queue_wait"),
            "exec": pcts("exec"),
            "e2e": pcts("e2e"),
            "tasks_done_total": (samples[-1]["tasks_done"]
                                 if samples else 0),
            "shm_pool_hit_rate": (round(reused / (reused + misses), 3)
                                  if reused + misses else None),
            "lease_outstanding": self._gauge_total(
                merged, "ray_tpu_lease_outstanding"),
            "ring": spark,
        }

    def stats(self) -> dict:
        with self._lock:
            return {"sources": len(self._sources),
                    "ring_len": len(self._ring)}
