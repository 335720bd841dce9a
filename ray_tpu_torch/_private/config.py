"""Central runtime config registry with env-var override.

Parity: reference src/ray/common/ray_config_def.h (219 RAY_CONFIG
entries, each overridable via a RAY_<name> env var, materialised into a
RayConfig singleton) — scaled to this runtime's knob set. Every entry
is overridable via ``RAY_TPU_<NAME>`` (upper-cased) read at first
access; ``CONFIG.reload()`` re-reads the environment (tests).

Usage::

    from ray_tpu_torch._private.config import CONFIG
    timeout = CONFIG.heartbeat_timeout_s

Adding a knob: one ``_define`` line here — call sites never hardcode.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True)
class ConfigEntry:
    name: str
    default: Any
    parse: Callable[[str], Any]
    doc: str


_REGISTRY: Dict[str, ConfigEntry] = {}


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _define(name: str, default: Any, doc: str) -> None:
    parse: Callable[[str], Any]
    if isinstance(default, bool):
        parse = _parse_bool
    elif isinstance(default, int):
        parse = int
    elif isinstance(default, float):
        parse = float
    else:
        parse = str
    _REGISTRY[name] = ConfigEntry(name, default, parse, doc)


# ---------------------------------------------------------------- knobs
_define("heartbeat_timeout_s", 3.0,
        "Node declared dead after this long without a heartbeat "
        "(reference gcs_health_check_manager period*threshold).")
_define("suspect_s", 1.5,
        "Suspicion threshold for gray failures (r17): a node whose "
        "last heartbeat is older than this (but younger than "
        "heartbeat_timeout_s) enters SUSPECT — routing, rebalance, "
        "spillback, and PG planning skip it, the pull manager "
        "deprioritizes it as a source, and the autoscaler excludes "
        "its capacity — but NO recovery runs, so the next heartbeat "
        "restores it for free (a 2 s blip costs routing preference, "
        "not a node-death recovery). Must be < heartbeat_timeout_s; "
        "0 disables the suspect state.")
_define("chaos", False,
        "Enable the protocol-level network fault-injection layer "
        "(r17): tests/chaos.py can then partition, blackhole, slow, "
        "or probabilistically drop frames per connection pair under "
        "seeded rules (both wire engines). Off (default) the layer "
        "is never constructed and the wire behavior is byte-"
        "identical to a build without it. NEVER enable in "
        "production.")
_define("chaos_seed", 0,
        "Seed for the chaos layer's probabilistic frame-drop rules, "
        "so a failing chaos run replays deterministically.")
_define("reconnect_backoff_base_s", 0.25,
        "Initial delay between an agent's head-redial attempts after "
        "a lost head connection; doubles per failure (jittered "
        "+/-50%) up to reconnect_backoff_cap_s instead of hammering "
        "the dead address at a fixed rate.")
_define("reconnect_backoff_cap_s", 2.0,
        "Ceiling on the agent's jittered exponential reconnect "
        "backoff.")
_define("spill_delay_s", 1.0,
        "Queued-task age before the scheduler offers it back to the "
        "cluster for spillback to another node.")
_define("worker_spawn_timeout_s", 60.0,
        "Worker process must register within this long or its spawn "
        "slot is reaped.")
_define("inline_threshold_bytes", 100 * 1024,
        "Buffers below this size ride inline in the pickle stream; "
        "larger ones get their own shm segment (reference plasma "
        "promotion threshold semantics).")
_define("object_store_memory", 0,
        "Object store residency cap in bytes; 0 = unbounded. Past the "
        "cap, LRU unpinned objects spill to disk.")
_define("node_memory_bytes", 8 * 1024 ** 3,
        "Schedulable 'memory' resource reported per node.")
_define("worker_pool_max", 0,
        "Reusable task-worker pool soft cap; 0 = max(2*CPU, 8). Actor-"
        "pinned workers are dedicated processes outside the cap.")
_define("task_event_history", 10_000,
        "Bounded task-event history length in the controller.")
_define("remote_inline_max_bytes", 64 * 1024,
        "Task results at or below this size are forwarded inline from a "
        "node agent to the head (owner-inline parity, reference "
        "core_worker.h AllocateReturnObject); larger results stay in "
        "the agent's store and register a location.")
_define("auth_token", "",
        "Shared secret for listener authentication. When set, every "
        "accepted connection must present it (raw first frame, "
        "constant-time compare) BEFORE any message is deserialized; "
        "workers/agents inherit it via the environment. Strongly "
        "recommended with bind_host=0.0.0.0 — the wire is pickle.")
_define("bind_host", "127.0.0.1",
        "Head listener bind host. Set 0.0.0.0 (or a NIC address) to "
        "accept remote node agents; loopback by default.")
_define("port", 0,
        "Head listener port; 0 picks an ephemeral port.")
_define("lineage_max_resubmits", 3,
        "Cap on per-task lineage re-executions when a node death "
        "orphans a still-referenced object (reference task_manager "
        "ResubmitTask bookkeeping).")
_define("head_snapshot_path", "",
        "When set, the head periodically snapshots all controller "
        "tables (actors, nodes, PGs, KV, lineage, object directory) to "
        "this file and REHYDRATES from it on restart (reference GCS "
        "persistence: gcs_init_data.cc + redis_store_client.h). Empty "
        "disables head fault tolerance.")
_define("head_snapshot_period_s", 1.0,
        "Controller snapshot period when head_snapshot_path is set and "
        "the WAL is disabled (RAY_TPU_HEAD_WAL=0). With the WAL on, "
        "snapshots are taken by compaction instead of on a timer.")
_define("head_wal", True,
        "Write-ahead-log head state changes (r15) when "
        "head_snapshot_path is set: task submit/terminal, lease "
        "grants, mirror routing, refcount/pin batches, directory and "
        "KV/actor/node/PG transitions are group-commit fsynced so a "
        "restarted head rehydrates to the exact pre-crash frontier "
        "(snapshot + WAL tail) instead of the last 1 Hz snapshot. "
        "0 reverts to snapshot-only persistence.")
_define("head_wal_path", "",
        "Head WAL file path; empty defaults to "
        "<head_snapshot_path>.wal.")
_define("head_wal_fsync_ms", 5.0,
        "Group-commit window: records buffered within it share one "
        "write+fsync (the WAL's per-event durability cost is a list "
        "append). 0 fsyncs every flush pass immediately.")
_define("head_wal_compact_bytes", 8 * 1024 * 1024,
        "Active WAL segment size that triggers snapshot+truncate "
        "compaction; 0 disables the size trigger.")
_define("head_wal_compact_interval_s", 30.0,
        "Maximum age of a non-empty WAL segment before compaction "
        "runs regardless of size; 0 disables the time trigger.")
_define("head_done_replay_window_s", 15.0,
        "How far back (before the head connection was lost) an agent "
        "replays already-SENT completion-batch entries on rejoin: a "
        "batch can be TCP-delivered but never processed by a dying "
        "head, so the tail of sent entries is replayed and deduped "
        "head-side against the rehydrated mirror (exactly-once "
        "accounting). 0 replays only never-sent buffered entries.")
_define("agent_reconnect_window_s", 60.0,
        "How long a node agent keeps redialing a lost head before "
        "giving up and shutting down (reference raylets tolerate GCS "
        "downtime); 0 restores exit-on-disconnect.")
_define("store_put_block_s", 10.0,
        "Create-queueing backpressure (reference plasma "
        "create_request_queue.cc): when the object store is over "
        "capacity and nothing is spillable (all bytes pinned by "
        "in-flight tasks), a put parks up to this long for space to "
        "free before admitting the object over-cap with a warning. "
        "0 disables blocking.")
_define("memory_monitor_threshold", 0.95,
        "Node memory-usage fraction above which the per-node memory "
        "monitor kills a task worker to relieve pressure (reference "
        "raylet memory_monitor + worker_killing_policy.cc). 0 "
        "disables the monitor.")
_define("memory_monitor_refresh_s", 1.0,
        "Memory monitor poll period.")
_define("worker_pipeline_depth", 4,
        "Tasks dispatched to one worker before its previous task "
        "completes (the worker executes FIFO). Depth >1 overlaps the "
        "completion round-trip with execution — the reference's "
        "worker-lease pipelining. Under saturation, queued tasks ride "
        "the worker's existing resource grant (charged on predecessor "
        "completion), so depth also sets how many TASK/TASK_DONE "
        "frames coalesce per wire write. Blocked workers steal back "
        "their queued tail, so deadlock-safety is depth-independent. "
        "1 restores strict one-at-a-time dispatch.")
_define("wire_batch", True,
        "Micro-batch fire-and-forget control frames (TASK_DONE, decref "
        "floods, multi-spec dispatch) into coalesced writes — one "
        "BatchFrame envelope when the peer negotiated wire MINOR >= 1, "
        "else concatenated single frames in one syscall. 0 restores "
        "strict one-frame-per-send behavior.")
_define("wire_batch_max_frames", 64,
        "Coalescing queue flushes when this many frames are pending "
        "(also the per-frame cap of a DECREF_BATCH, clamped there to "
        "64 so its id list stays within the wire's structural-"
        "encoding bound).")
_define("wire_batch_delay_ms", 1.0,
        "Coalescing window (collect-then-flush): the first lazy frame "
        "opens a window of this width and every frame emitted inside "
        "it rides the same write, so any lazy frame waits at most "
        "~this long plus the flusher thread-wake latency. Reply-"
        "bearing and other eager sends bypass the queue entirely (and "
        "flush it first, preserving per-connection FIFO order).")
_define("wire_native", True,
        "Use the native frame engine (GIL-released socket read pump, "
        "scatter-gather flush, C envelope codec in "
        "native/core.c) for the wire hot path when the native library "
        "is available. 0 restores the pure-Python wire paths without "
        "touching the other native users (channel waits, CRC32C); "
        "RAY_TPU_DISABLE_NATIVE=1 disables all of them.")
_define("wire_native_codec", "auto",
        "Envelope codec selection when the native frame engine is on. "
        "'auto' (default): use the C codec only when the installed "
        "protobuf backend is the pure-Python one (~3x encode/decode "
        "there; the upb/C++ backends already serialize in C and beat "
        "per-frame ctypes calls). '1' forces the C codec, '0' forces "
        "the protobuf codec. Large pickled bodies always take the "
        "zero-copy scatter-gather emit path regardless.")
_define("wire_max_frame_bytes", 1 << 30,
        "Sanity bound on a frame's length prefix. A frame claiming to "
        "be larger is treated as a corrupt/hostile stream and the "
        "connection dies immediately — instead of the reader "
        "attempting a multi-GB allocation. Must comfortably exceed "
        "the largest legitimate frame (pull chunks are 4 MB; state "
        "replies can reach tens of MB).")
_define("shm_pool", True,
        "Reuse freed shm segments for subsequent large-object puts via "
        "a size-classed free pool (segments are renamed, not "
        "unlinked, while pooled) — skips the shm_open/ftruncate/page-"
        "zeroing cost on the large-object hot path. 0 restores "
        "unlink-on-free.")
_define("shm_pool_max_bytes", 256 * 1024 * 1024,
        "Total bytes the shm segment pool may hold; overflow falls "
        "back to the normal unlink-by-name path.")
_define("shm_pool_per_class", 4,
        "Segments kept per power-of-two size class in the shm pool.")
_define("node_rejoin_grace_s", 20.0,
        "After a head restart, how long rehydrated nodes have to "
        "re-register before they are declared dead and their actors/"
        "objects recovered.")
_define("pull_concurrency", 4,
        "Max concurrent object transfers a pull manager runs per "
        "process (reference pull_manager.cc active-pull bound); "
        "excess pulls queue. Requests for an object already in "
        "flight dedup onto the existing transfer regardless.")
_define("pull_max_inflight_bytes", 256 * 1024 * 1024,
        "Byte budget for in-flight pulled objects per pull manager "
        "(reference pull_manager.cc num_bytes_available_): a pull "
        "whose size would exceed it waits for running transfers to "
        "land. A single object larger than the budget is admitted "
        "alone. 0 = unbounded.")
_define("pull_pipeline_depth", 4,
        "Chunk requests a puller keeps in flight per transfer "
        "(reference object_buffer_pool chunked reads are windowed the "
        "same way): 1 restores strict request/reply lockstep, which "
        "makes every transfer latency-bound.")
_define("pull_chunk_retries", 2,
        "Per-pull retries after a dropped/expired chunk: the puller "
        "re-opens a session with the holder and resumes from the "
        "failed chunk index before giving up on that source.")
_define("pull_manifest", True,
        "Manifest (zero-copy) object transfer (r12, wire MINOR >= 5): "
        "pulls ask the holder for a manifest (payload + per-buffer "
        "sizes) and chunk bodies ride the Envelope raw field straight "
        "from the holder's mapped shm into the puller's pre-created "
        "segments — no materialize/pickle copies on either side. "
        "Negotiated per transfer: an old holder ignores the request "
        "flag and serves the blob protocol. 0 restores blob pulls "
        "everywhere.")
_define("pull_cut_through", True,
        "Cut-through relay (r12): a node mid-pull registers as a "
        "PARTIAL holder at its first landed chunk and serves already-"
        "landed chunk ranges to its broadcast children while its own "
        "pull is in flight, making tree depth cost per-chunk instead "
        "of per-object latency. Requires manifest transfers; 0 "
        "restores store-and-forward relay.")
_define("pull_partial_chunk_timeout_s", 20.0,
        "Per-chunk client-side deadline when pulling from a PARTIAL "
        "holder (its own pull may stall): on expiry the chunk counts "
        "as dropped and the normal retry / re-root-on-source "
        "machinery takes over, instead of burning the transfer's "
        "whole deadline on a stalled relay.")
_define("pull_session_ttl_s", 120.0,
        "Pull-session idle TTL on the serving side: sessions a dead "
        "puller abandoned are reaped on the next pull/chunk message "
        "(lazy sweep) and on the puller's connection close, "
        "releasing the materialized blob and the object pin.")
_define("bcast_fanout", 4,
        "Tree-broadcast fanout: each node that completes its copy "
        "serves at most this many children, so the source serves "
        "<= fanout transfers instead of N (reference object-manager "
        "push parity for the 1 GiB x 50-node envelope row).")
_define("bcast_timeout_s", 120.0,
        "Per-broadcast deadline: nodes still missing the object when "
        "it expires are reported as failed in the broadcast result.")
_define("trace", True,
        "Master switch for the distributed tracing plane (r9): span "
        "emission into the per-process flight recorder and trace-"
        "context propagation on the wire (Envelope trace_id/"
        "parent_span fields, MINOR >= 2 peers). 0 disables both — "
        "no spans are recorded and envelopes carry zero extra bytes "
        "(proto3 omits unset fields).")
_define("trace_ring", 4096,
        "Per-process flight-recorder capacity in span events (each a "
        "small tuple; 4096 ~ a few hundred KB). The ring wraps — "
        "newest events win, the watermark keeps counting so drops are "
        "visible. 0 disables recording (same effect as "
        "RAY_TPU_TRACE=0).")
_define("epoll", True,
        "Drive the read side of every head/agent connection from ONE "
        "shared event loop (r10): the native epoll API in core.c "
        "(epoll_wait with the GIL released, level-triggered, each "
        "ready fd drained through its C reassembly buffer) when the "
        "frame engine is on, a select()-based Python loop otherwise. "
        "0 restores a dedicated reader thread per connection. Worker "
        "processes always use per-connection readers (they hold one "
        "or two connections).")
_define("delegate", True,
        "Delegated bulk-lease scheduling (r10): the head grants "
        "agents batches of queued tasks in single NODE_LEASE_BATCH "
        "frames instead of per-spec sends, suppresses per-task "
        "dispatch events, and agents report completions in coalesced "
        "TASK_DONE_BATCH frames. Negotiated per connection (peer "
        "wire MINOR >= 3); 0 restores per-task round-trips. The head "
        "keeps ownership: lease revoke, steal, and lineage resubmit "
        "all still work.")
_define("delegate_lease_batch", 64,
        "Max specs per NODE_LEASE_BATCH: the head-side lease buffer "
        "flushes when this many specs are parked for one agent (or "
        "when the delegate_lease_delay_ms window closes).")
_define("delegate_lease_delay_ms", 1.0,
        "Collect-then-flush window for the head-side lease buffer: "
        "the first parked spec opens a window of this width; every "
        "spec routed to the same agent inside it rides one "
        "NODE_LEASE_BATCH frame.")
_define("delegate_done_batch", 64,
        "Max completions per TASK_DONE_BATCH: the agent-side "
        "completion buffer flushes at this count (or when the "
        "delegate_done_delay_ms window closes, or before any other "
        "state-bearing send — ordering with worker_lost/refcount "
        "traffic is preserved).")
_define("delegate_done_delay_ms", 2.0,
        "Collect-then-flush window for the agent-side completion "
        "buffer.")
_define("delegate_max_inflight", 0,
        "Resource-budget cap on tasks leased to one agent but not "
        "yet reported done; specs beyond it stay parked in the "
        "head-side lease buffer until completions free budget. "
        "0 = unbounded (the agent's own scheduler remains the "
        "authoritative resource ledger either way).")
_define("metrics", True,
        "Master switch for the cluster metrics plane (r11): runtime-"
        "instrumented series (task latency histograms by phase, lease/"
        "poller/object-plane/shm-pool telemetry) registered into the "
        "per-process util.metrics registry, plus the METRICS_DUMP "
        "cluster scrape. 0 disables instrumentation entirely — hot "
        "paths skip every observe behind one memoized gate and no "
        "runtime series are ever registered (zero metric bytes, the "
        "RAY_TPU_TRACE=0 discipline).")
_define("metrics_ttl_s", 15.0,
        "Stale-series expiry in the head-side cluster collector: a "
        "process (worker/agent) that stops answering METRICS_DUMP "
        "keeps its last-seen series in /metrics for this long, then "
        "they disappear — removed nodes/workers cannot linger "
        "forever, while one missed scrape doesn't flap the view.")
_define("metrics_ring", 120,
        "Head-side metrics retention ring: how many collection "
        "samples (one summary per cluster scrape) the head keeps for "
        "the dashboard sparklines and the autoscaler's windowed "
        "queue-latency signal. 0 disables retention.")
_define("metrics_min_scrape_s", 1.0,
        "Rate limit on cluster metrics fan-outs: collections "
        "requested closer together than this (dashboard auto-refresh "
        "+ autoscaler both pulling) reuse the cached merge instead of "
        "re-fanning METRICS_DUMP to every process.")
_define("autoscale_queue_latency_s", 0.0,
        "Autoscaler queue-latency signal (r11): when > 0, the "
        "autoscaler scales UP one node whenever the cluster task "
        "queue-wait p95 over the recent window exceeds this many "
        "seconds — even if resource-shape demand alone would not "
        "trigger a launch (the groundwork for latency-SLO serving "
        "autoscaling). 0 disables the signal.")
_define("autoscale_queue_latency_window_s", 30.0,
        "Window over the metrics retention ring used to compute the "
        "queue-wait p95 for the autoscaler signal (recent "
        "distribution, not the process-lifetime cumulative one).")
_define("autoscale_queue_latency_cooldown_s", 30.0,
        "Minimum seconds between latency-driven scale-ups: the p95 "
        "stays high until new capacity drains the queue, so without a "
        "cooldown the signal would launch a node per update tick.")
_define("channel_ring_depth", 2,
        "Compiled-DAG channel ring slots (r13): how many published-"
        "but-unconsumed messages a channel buffers before the writer "
        "blocks. 1 restores the single-slot r5 behavior (the writer "
        "waits for every reader before each publish — no transfer/"
        "compute overlap); 2 double-buffers, which is what lets an "
        "MPMD pipeline stage compute microbatch m+1 while m is still "
        "in flight to its neighbor. Applies to both the shm and wire "
        "channel transports.")
_define("channel_wire_attach_timeout_s", 30.0,
        "How long a wire-channel reader waits for its attach "
        "handshake with the writer-side channel server before the "
        "endpoint raises (the writer's exec loop may still be "
        "starting).")
_define("elastic", True,
        "Master switch for elastic training (r14): with a "
        "ScalingConfig(elastic=ElasticConfig(...)) the JaxTrainer "
        "reshapes its worker group on node loss/gain (dp mesh shrinks "
        "or grows), auto-restores from the latest checkpoint with "
        "broadcast-tree weight delivery, and keeps step accounting "
        "exact. 0 forces the classic whole-group restart path even "
        "when an ElasticConfig is present.")
_define("elastic_poll_s", 0.25,
        "Driver-side poll period in the elastic training loop: how "
        "often the trainer checks node events (DRAINING/ALIVE/DEAD) "
        "and capacity while waiting on worker results. Smaller reacts "
        "faster to preemption notices at slightly more head traffic.")
_define("elastic_capacity_timeout_s", 60.0,
        "How long an elastic fit() waits for cluster capacity to "
        "reach ElasticConfig.min_workers (initially and after a node "
        "loss) before giving up and surfacing the failure.")
_define("elastic_max_reshapes", 16,
        "Bound on elastic reshapes (node-loss restores + grows) in "
        "one fit(): a cluster flapping faster than training progresses "
        "surfaces as an error instead of looping forever.")
_define("drain_deadline_s", 30.0,
        "Default drain window for a preemption notice "
        "(Autoscaler.on_preemption_notice with deadline_s=None): the "
        "node is released when the drain is acknowledged (elastic "
        "trainer checkpoint flushed) or this many seconds elapse, "
        "whichever comes first.")
_define("head_shards", 8,
        "Stripe count for the head's hot tables (r16): the ref/pin "
        "table, live-task spec mirror, lineage mirror, and object "
        "directory are split into this many independently locked "
        "shards keyed by task/object id, so submits, completions, and "
        "decref storms stop convoying through one controller lock at "
        "100k-task scale. Rounded up to a power of two. 0 (or 1) "
        "reverts to the single-shard pre-r16 topology.")
_define("head_lineage_max", 100_000,
        "Resident-entry cap on the head's lineage mirror (return "
        "object id -> producing spec, kept for lost-copy "
        "reconstruction). FIFO eviction past the cap bounds head "
        "memory under sustained 100k-task in-flight populations; an "
        "evicted entry only disables lineage reconstruction for that "
        "object (reference max_lineage_bytes degrades the same way). "
        "0 = unbounded.")
_define("decref_delta", True,
        "Route worker decref storms through the node agent as "
        "coalesced per-object count deltas (r16 NODE_DECREF_DELTA): "
        "the agent merges its workers' DECREF/DECREF_BATCH traffic "
        "into one seq-numbered {object_id: n} frame per flush window "
        "and the head applies each frame per-shard (one stripe-lock "
        "round trip per shard, not per release), with rejoin replays "
        "deduped by a per-node watermark. Requires the head to speak "
        "wire MINOR >= 7; 0 restores per-connection DECREF_BATCH "
        "forwarding.")
_define("decref_delta_delay_ms", 2.0,
        "Collect-then-flush window for the agent-side decref-delta "
        "buffer (the delegate_done_delay_ms discipline): the first "
        "parked release opens a window of this width; every release "
        "arriving inside it rides the same NODE_DECREF_DELTA frame.")
_define("decref_delta_max", 512,
        "Distinct object ids parked in the agent's decref-delta "
        "buffer that force an immediate flush (bounds both frame size "
        "and how much release traffic an agent crash can lose).")
_define("trace_sample", 64,
        "Trace sampling stride (r16): the head starts a trace for 1 "
        "in this many root task submissions and propagates the "
        "decision in the existing spec/envelope trace fields, so a "
        "sampled task is whole-or-nothing across every process it "
        "touches while unsampled tasks pay zero ring writes and zero "
        "wire bytes (exactly like RAY_TPU_TRACE=0). Nested submissions "
        "inside a sampled trace inherit it. 1 traces every task; 0 "
        "reverts to the pre-r16 always-trace behavior.")
_define("direct_actor", True,
        "Direct actor call plane (r18): callers resolve an actor's "
        "endpoint once (ACTOR_RESOLVE), dial the hosting node's "
        "listener, and stream calls over that one connection with "
        "replies returning inline — the head drops out of the steady-"
        "state path (it stays the lifecycle owner via the caller's "
        "coalesced ACTOR_INFLIGHT_DELTA mirror). Requires the peers "
        "to speak wire MINOR >= 8; stale endpoints NACK with a "
        "redirect-to-head fallback. 0 restores the fully head-routed "
        "actor path (byte-identical to r17).")
_define("direct_actor_worker", True,
        "Serve direct actor calls from the hosting WORKER's own "
        "socket (each worker opens a tiny listener and reports its "
        "port at REGISTER): caller -> worker -> caller, two legs "
        "total. 0 restores agent-hosted direct serving (caller -> "
        "agent -> worker -> agent -> caller), which also remains the "
        "automatic fallback while a worker's port is not yet known "
        "head-side (heartbeat lag) or its listener failed to bind.")
_define("direct_actor_stall_s", 10.0,
        "How long a get() on a direct-call reply future waits before "
        "falling back to the normal head-routed GET path. Covers the "
        "silent-partition case: the hosting node vanished without a "
        "FIN, the head declares it dead and errors the mirrored "
        "in-flight calls, and the fallback get resolves that error "
        "instead of hanging on the dead connection. Must comfortably "
        "exceed heartbeat_timeout_s.")
_define("direct_actor_delta_delay_ms", 25.0,
        "Collect-then-flush window for a remote caller's "
        "ACTOR_INFLIGHT_DELTA buffer (the decref-delta discipline): "
        "the first parked add/done opens a window of this width; "
        "everything arriving inside it rides one frame to the head. "
        "Wide by design — nothing in the delta is latency-critical "
        "(the caller holds a call-lifetime borrow on arg refs, so "
        "the head-side pin is belt-and-braces, and dones only "
        "release pins), and a sync caller at ~1k calls/s amortizes "
        "to well under 0.1 head frames per call.")
_define("direct_actor_delta_max", 64,
        "Buffered ACTOR_INFLIGHT_DELTA entries that force an "
        "immediate flush (bounds frame size and how much mirror "
        "state a caller crash can lose).")
_define("direct_actor_delta_delay_max_ms", 250.0,
        "Ceiling for the ADAPTIVE delta window (r20): a caller whose "
        "delta frames flush near-empty (a sparse caller, e.g. an RL "
        "env-runner pacing tens of act()/s against env stepping) "
        "doubles its collect window per flush up to this cap, so "
        "mirror frames amortize by call count instead of by wall "
        "clock; a near-full frame snaps the window back to "
        "direct_actor_delta_delay_ms. Bounds both mirror lag and "
        "crash-loss scope for slow callers.")
_define("llm_stream", True,
        "LLM serving token transport (serve/llm): 1 streams tokens "
        "over a peer-dialed push connection to the engine replica "
        "(r18-style direct plane — the head never sees a token "
        "frame); 0 falls back to the polled next_tokens actor-call "
        "path through the ordinary request plane.")
_define("llm_page_size", 16,
        "KV-cache page size in token positions. Every sequence's "
        "cache occupancy is a whole number of pages; smaller pages "
        "waste less on short tails but grow the page tables.")
_define("llm_max_batch", 8,
        "Continuous-batching decode width per engine replica: the "
        "step loop decodes up to this many in-flight sequences per "
        "iteration (the decode kernel is compiled once at this "
        "padded width).")
_define("llm_step_delay_s", 0.0,
        "Debug/chaos pacing: sleep this long between engine "
        "iterations. Stretches generations so fault-injection tests "
        "can land a kill or partition mid-stream; keep 0 in "
        "production.")
_define("llm_stream_wait_s", 0.5,
        "Polled token fallback (llm_stream=0): how long next_tokens "
        "parks server-side waiting for fresh tokens before returning "
        "an empty slice — converts client busy-polling into bounded "
        "server-side waits.")
_define("rl_ring_depth", 2,
        "Sebulba RL trajectory rings (rllib/sebulba): wire-channel "
        "ring depth between each env-runner and the learner. The "
        "depth is simultaneously the queue bound and the policy-"
        "staleness bound — a runner blocks writing shard seq when "
        "the learner has not acked seq - depth, so no consumed shard "
        "can be more than depth+2 policy versions behind (producing "
        "+ in-ring + consuming) per runner at publish interval 1.")
_define("rl_infer_max_batch", 64,
        "Sebulba inference actors: admission cap — at most this many "
        "parked act() requests are coalesced into one stacked "
        "forward pass per admission iteration.")
_define("rl_infer_wait_ms", 2.0,
        "Sebulba inference actors: admission window — after the "
        "first act() request arrives, the step loop waits this long "
        "for more callers to park before launching the batched "
        "forward. 0 disables coalescing (one forward per wakeup).")
_define("rl_step_delay_s", 0.0,
        "Debug/chaos pacing: sleep this long per Sebulba inference "
        "forward pass. Stretches rollouts so fault-injection tests "
        "can land a kill or partition mid-stream; keep 0 in "
        "production.")
_define("rl_publish_interval", 1,
        "Sebulba learner: publish refreshed weights to inference "
        "actors every N updates (ray_tpu_torch.put once + broadcast-tree "
        "fanout + versioned set_weights). Larger values trade "
        "staleness for publish bandwidth.")
_define("scheduler_locality", True,
        "Locality-aware node selection: prefer placing a task on a "
        "feasible node already holding the most argument bytes "
        "(object-directory lookup; reference locality_task_spreading "
        "hybrid-policy input). 0 restores pure pack/spread.")


class _Config:
    """Attribute access resolves registry entries with env override."""

    def __init__(self):
        self._cache: Dict[str, Any] = {}
        # Bumped by reload(): per-call-site memos of derived config
        # state (e.g. native.frame_engine_enabled on the per-frame hot
        # path) key on this instead of re-reading the environment.
        # Contract: flipping a RAY_TPU_* env var takes effect after
        # CONFIG.reload() — which the tests and bench already call.
        self._gen: int = 0

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        cache = self.__dict__["_cache"]
        if name in cache:
            return cache[name]
        entry = _REGISTRY.get(name)
        if entry is None:
            raise AttributeError(
                f"unknown config {name!r}; known: {sorted(_REGISTRY)}")
        env = os.environ.get("RAY_TPU_" + name.upper())
        value = entry.default if env is None else entry.parse(env)
        cache[name] = value
        return value

    def reload(self) -> None:
        """Drop cached values so env overrides re-apply (tests)."""
        self.__dict__["_cache"].clear()
        self.__dict__["_gen"] += 1

    def describe(self) -> Dict[str, Dict[str, Any]]:
        """All knobs with current value, default, env var name, doc."""
        return {
            name: {
                "value": getattr(self, name),
                "default": e.default,
                "env": "RAY_TPU_" + name.upper(),
                "doc": e.doc,
            } for name, e in sorted(_REGISTRY.items())}


CONFIG = _Config()
