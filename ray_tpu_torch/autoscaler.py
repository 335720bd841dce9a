"""Autoscaler: demand-driven node scale-up, idle-timeout scale-down.

A copy of `ray_tpu/autoscaler.py`. The pod provider keeps its structure
(a unit of hosts provisioned and terminated together) and launches
agents that publish `GPU` where the JAX package's publish `TPU`. Its
classes are renamed: `TPUCloudAPI` is `GPUCloudAPI`,
`LocalProcessTPUCloud` is `LocalProcessGPUCloud`, and `TPUPodProvider`
is `GPUPodProvider`.

Parity: reference autoscaler v2 (python/ray/autoscaler/v2/ —
`autoscaler.py` + `scheduler.py` bin-packing pending demand into node
types, `instance_manager/` provisioning) — re-shaped for this stack:
the provider abstraction launches in-process nodes by default (the
fake_multi_node analogue, and the honest model for one driver managing
TPU pod hosts); a real deployment implements `NodeProvider` against its
pod/VM API.

Loop (reference autoscaler.py update cycle):
  demand = queued-but-unplaceable resources + infeasible tasks
         + pending placement-group bundles
  scale UP:   first node type whose shape covers an unmet demand unit,
              respecting max_workers
  scale DOWN: non-head nodes idle (all resources free, nothing queued)
              longer than idle_timeout_s
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.scheduler import fits as _fits_with_eps


@dataclasses.dataclass
class NodeTypeConfig:
    name: str
    resources: Dict[str, float]          # per HOST
    min_workers: int = 0
    max_workers: int = 10                # counted in HOSTS
    # hosts per provisioned unit: a TPU pod slice is an atomic group of
    # hosts that provisions — and terminates — together (reference TPU
    # pod types in python/ray/autoscaler/_private/gcp/)
    hosts: int = 1


class NodeProvider:
    """Provisioning backend. The default launches in-process nodes on
    the driver's cluster manager (tests, single-host); subclass for
    real pods/VMs (reference NodeProvider plugins).

    ``create_node`` may return ONE node id or a LIST (an atomic
    multi-host group, e.g. a TPU pod slice); ``group_of`` reports the
    group so scale-down only retires fully-idle groups."""

    def __init__(self, cluster):
        self._cluster = cluster

    def create_node(self, node_type: NodeTypeConfig):
        rec = self._cluster.add_node(
            dict(node_type.resources),
            labels={"ray_tpu.io/node-type": node_type.name})
        return rec.node_id

    def terminate_node(self, node_id: str) -> None:
        self._cluster.remove_node(node_id, graceful=True)

    def group_of(self, node_id: str) -> Optional[List[str]]:
        """Node ids provisioned atomically with `node_id` (a pod
        slice), or None for single-host nodes."""
        return None

    def on_preemption_notice(self, node_id: str,
                             deadline_s: Optional[float] = None) -> None:
        """Cloud preemption warning for `node_id` (GCE preemption
        notice, TPU queued-resource eviction): forward to the attached
        autoscaler's drain-before-kill path. Real providers call this
        from their metadata-watcher/eviction webhook; the node is
        drained (no new work, queued work reclaimed, trainers flush
        checkpoints) and terminated on ack or deadline — instead of
        dying mid-step and costing a lineage-resubmit storm."""
        asc = getattr(self, "_autoscaler", None)
        if asc is not None:
            asc.on_preemption_notice(node_id, deadline_s)

    def shutdown(self) -> None:
        pass


class GPUCloudAPI:
    """The cloud surface a GPU-pod provider needs (the JAX package's
    TPU-pod one, with GPU hosts), stubbed behind an
    interface so deployments plug in their GCE/queued-resources calls
    (reference python/ray/autoscaler/_private/gcp/node.py TPU path:
    tpu.projects.locations.nodes.create with acceleratorType /
    runtimeVersion, delete, list). Each slice is created with
    pre-minted node ids so the autoscaler can track the hosts before
    they register."""

    def create_slice(self, slice_name: str, node_ids: List[str],
                     node_type: NodeTypeConfig,
                     head_address: tuple) -> None:
        raise NotImplementedError

    def delete_slice(self, slice_name: str) -> None:
        raise NotImplementedError


class LocalProcessGPUCloud(GPUCloudAPI):
    """Fake cloud for tests and single-host development (reference
    fake_multi_node/node_provider.py): every slice host is a REAL
    ``node_agent`` subprocess that joins the head over TCP — the full
    registration/heartbeat/object-transfer path, just without VMs."""

    def __init__(self):
        self._slices: Dict[str, list] = {}

    def create_slice(self, slice_name: str, node_ids: List[str],
                     node_type: NodeTypeConfig,
                     head_address: tuple) -> None:
        from ray_tpu_torch.cluster_utils import NodeAgentProcess
        res = dict(node_type.resources)
        num_cpus = float(res.pop("CPU", 2.0))
        num_gpus = float(res.pop("GPU", 0.0))
        res.pop("memory", None)
        agents = []
        for nid in node_ids:
            agents.append(NodeAgentProcess(
                head_address=head_address, num_cpus=num_cpus,
                num_gpus=num_gpus, resources=res or None,
                labels={"ray_tpu.io/node-type": node_type.name,
                        "ray_tpu.io/slice": slice_name},
                node_id=nid))
        self._slices[slice_name] = agents

    def delete_slice(self, slice_name: str) -> None:
        for agent in self._slices.pop(slice_name, []):
            agent.terminate()

    def shutdown(self) -> None:
        for name in list(self._slices):
            self.delete_slice(name)


class GPUPodProvider(NodeProvider):
    """Provisions atomic pod-slice node groups through a GPUCloudAPI.
    Hosts terminate slice-at-a-time (a slice cannot lose single hosts),
    which the autoscaler honours via ``group_of``."""

    def __init__(self, cloud: GPUCloudAPI, head_address: tuple):
        self._cloud = cloud
        self._head_address = tuple(head_address)
        self._node_slice: Dict[str, str] = {}     # node_id -> slice
        self._slice_nodes: Dict[str, List[str]] = {}

    def create_node(self, node_type: NodeTypeConfig) -> List[str]:
        import uuid
        slice_name = f"{node_type.name}-{uuid.uuid4().hex[:6]}"
        node_ids = ["node_" + uuid.uuid4().hex[:8]
                    for _ in range(max(1, node_type.hosts))]
        self._cloud.create_slice(slice_name, node_ids, node_type,
                                 self._head_address)
        for nid in node_ids:
            self._node_slice[nid] = slice_name
        self._slice_nodes[slice_name] = list(node_ids)
        return node_ids

    def terminate_node(self, node_id: str) -> None:
        slice_name = self._node_slice.get(node_id)
        if slice_name is None:
            return
        for nid in self._slice_nodes.pop(slice_name, []):
            self._node_slice.pop(nid, None)
        self._cloud.delete_slice(slice_name)

    def group_of(self, node_id: str) -> Optional[List[str]]:
        slice_name = self._node_slice.get(node_id)
        if slice_name is None:
            return None
        return list(self._slice_nodes.get(slice_name, []))

    def shutdown(self) -> None:
        for slice_name in list(self._slice_nodes):
            self._cloud.delete_slice(slice_name)
        self._slice_nodes.clear()
        self._node_slice.clear()


class Autoscaler:
    def __init__(self, cluster, node_types: List[NodeTypeConfig],
                 provider: Optional[NodeProvider] = None,
                 idle_timeout_s: float = 60.0,
                 update_interval_s: float = 1.0,
                 queue_latency_source=None):
        from ray_tpu_torch._private.config import CONFIG
        self._cluster = cluster
        self._types = {t.name: t for t in node_types}
        self._provider = provider or NodeProvider(cluster)
        self.idle_timeout_s = idle_timeout_s
        self._interval = update_interval_s
        self._idle_since: Dict[str, float] = {}
        self._managed: Dict[str, str] = {}   # node_id -> type name
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.num_scale_ups = 0
        self.num_scale_downs = 0
        # Drain-before-kill (r14): node_id -> monotonic deadline. A
        # preemption notice drains the node (cluster stops routing to
        # it, trainers flush checkpoints); the update sweep terminates
        # it on drain-ack or deadline, whichever first. Providers reach
        # on_preemption_notice through the back-reference below.
        self._draining: Dict[str, float] = {}
        self.num_preemption_notices = 0
        self.num_drained_kills = 0
        self._provider._autoscaler = self
        # Queue-latency signal (r11, RAY_TPU_AUTOSCALE_QUEUE_LATENCY_S
        # > 0 enables): scale up when the cluster task queue-wait p95
        # over the recent window exceeds the threshold — latency-SLO
        # scaling that fires even when every queued shape technically
        # fits (resource-demand scaling can't see slow drains, only
        # unplaceable shapes). `queue_latency_source` overrides where
        # the p95 comes from (tests / external SLO pipelines); the
        # default reads the runtime's cluster metrics collector.
        self.latency_threshold_s = float(
            CONFIG.autoscale_queue_latency_s)
        self.latency_window_s = float(
            CONFIG.autoscale_queue_latency_window_s)
        self.latency_cooldown_s = float(
            CONFIG.autoscale_queue_latency_cooldown_s)
        self._latency_source = (queue_latency_source
                                or self._default_latency_source)
        # None, not 0.0: a fresh host's CLOCK_MONOTONIC can be smaller
        # than the cooldown, which would suppress the first trigger
        self._last_latency_scale_up: Optional[float] = None
        self.num_latency_scale_ups = 0
        self.last_queue_wait_p95: Optional[float] = None
        # launches whose node hasn't registered yet (async providers):
        # counted as planned capacity so repeated updates don't
        # re-launch for the same demand. (node_id, resources, at)
        self._in_flight_launches: List[tuple] = []
        # TPU slice provisioning routinely takes minutes — an expired
        # launch re-triggers for still-unmet demand, so keep this well
        # above real provisioning times (late registrations are also
        # re-adopted by label, see update()).
        self.provision_grace_s = 600.0
        # Heartbeat-derived demand (pending_shapes) lags reality by up
        # to one heartbeat period: a just-finished task can look queued
        # and trigger a spurious slice launch. Such shapes must be
        # unmet in two CONSECUTIVE updates before they scale anything;
        # head-synchronous demand (infeasible list, pending PGs) stays
        # immediate.
        self._prev_hb_demand: Dict[tuple, int] = {}
        cluster.autoscaling_enabled = True
        # type-level feasibility: demand NO node type can ever satisfy
        # is a hard error, not pending demand
        cluster.autoscaler_node_types = [dict(t.resources)
                                         for t in node_types]

    # --------------------------------------------------------- control
    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="ray-tpu-autoscaler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._cluster.autoscaling_enabled = False
        self._cluster.autoscaler_node_types = []

    def _loop(self) -> None:
        import sys
        while self._running:
            try:
                self.update()
            except Exception as e:  # noqa: BLE001
                sys.stderr.write(f"ray_tpu_torch autoscaler: update failed: "
                                 f"{e!r}\n")
            time.sleep(self._interval)

    # ---------------------------------------------------------- demand
    def _unmet_demand(self) -> List[Dict[str, float]]:
        """Resource shapes that cannot be placed on current capacity."""
        demand: List[Dict[str, float]] = []
        # Queued specs beyond each node's own availability are only
        # demand if NO other alive node could absorb them either —
        # spillback (spill_delay_s) will move them before a new node
        # could boot, so simulate placement against the other nodes'
        # effective availability before counting a shape as unmet.
        alive_nodes = self._cluster.alive_nodes()
        # draining nodes can't absorb spillback (routing skips them):
        # their capacity must not mask demand for replacement hosts.
        # SUSPECT nodes (r17 gray failure in progress) are excluded
        # for the same reason — routing skips them, so counting their
        # capacity would hide real demand exactly when a node is
        # flaking; the two-consecutive-sweep stability window below
        # keeps a sub-second blip from launching hosts.
        sim_avail = {n.node_id: dict(n.scheduler.effective_avail())
                     for n in alive_nodes
                     if not getattr(n, "draining", False)
                     and not getattr(n, "suspect", False)}
        hb_unmet: List[Dict[str, float]] = []
        for node in alive_nodes:
            for shape in node.scheduler.pending_shapes():
                placed = False
                for nid, avail in sim_avail.items():
                    if nid == node.node_id:
                        continue   # pending_shapes already proved no fit
                    if self._fits(shape, avail):
                        for k, v in shape.items():
                            avail[k] = avail.get(k, 0.0) - v
                        placed = True
                        break
                if not placed:
                    hb_unmet.append(shape)
        # stability window for the heartbeat-lagged source (see
        # _prev_hb_demand): only shapes unmet twice in a row count
        key = lambda s: tuple(sorted(s.items()))  # noqa: E731
        cur: Dict[tuple, int] = {}
        budget = dict(self._prev_hb_demand)
        for shape in hb_unmet:
            k = key(shape)
            cur[k] = cur.get(k, 0) + 1
            if budget.get(k, 0) > 0:
                budget[k] -= 1
                demand.append(shape)
        self._prev_hb_demand = cur
        # tasks no node fits at all
        with self._cluster._lock:
            infeasible = list(self._cluster._infeasible)
        for spec in infeasible:
            demand.append(dict(getattr(spec, "resources", None)
                               or {"CPU": 1.0}))
        # pending/rescheduling placement groups: bundles without a
        # LIVE node (node death knocks CREATED PGs into RESCHEDULING —
        # their displaced bundles are demand too)
        alive = {n.node_id for n in self._cluster.alive_nodes()}
        for pg in self._cluster.pg_table():
            if pg["state"] not in ("PENDING", "RESCHEDULING"):
                continue
            for bundle, node in zip(pg["bundles"], pg["bundle_nodes"]):
                if node is None or node not in alive:
                    demand.append(dict(bundle))
        return demand

    def _default_latency_source(self) -> Optional[float]:
        """Cluster queue-wait p95 from the runtime's metrics collector
        (r11 metrics plane); None when metrics are off or no tasks
        waited in the window."""
        collector = getattr(getattr(self._cluster, "_rt", None),
                            "metrics", None)
        if collector is None:
            return None
        # non-blocking: the fan-out runs on the collector's own
        # thread, so a wedged agent can never stall this reconcile
        # loop (it also drives demand scale-up and launch bookkeeping)
        return collector.queue_wait_p95(window_s=self.latency_window_s,
                                        block=False)

    def _maybe_latency_scale_up(self, now: float) -> None:
        if self.latency_threshold_s <= 0:
            return
        try:
            p95 = self._latency_source()
        except Exception:
            return                  # a broken signal must never kill
        self.last_queue_wait_p95 = p95      # the reconcile loop
        if p95 is None or p95 <= self.latency_threshold_s:
            return
        if (self._last_latency_scale_up is not None
                and now - self._last_latency_scale_up
                < self.latency_cooldown_s):
            return                  # capacity from the last trigger is
                                    # still draining the backlog
        if self._in_flight_launches:
            # a launched node can't drain anything before it
            # REGISTERS: with slow providers the p95 stays breached
            # through every cooldown window, and re-firing here would
            # march to max_workers for a backlog the pending capacity
            # already covers (the demand path packs into planned
            # capacity for the same reason)
            return
        for t in self._types.values():
            if self._count_type(t.name) + t.hosts > t.max_workers:
                continue
            self._scale_up(t)
            self.num_latency_scale_ups += 1
            self._last_latency_scale_up = now
            return

    # ------------------------------------------ preemption drain (r14)
    def on_preemption_notice(self, node_id: str,
                             deadline_s: Optional[float] = None) -> None:
        """The cloud announced `node_id` will be preempted in
        ~`deadline_s` seconds (RAY_TPU_DRAIN_DEADLINE_S when None).
        Drain-before-kill: the cluster stops leasing to it and reclaims
        its queued backlog NOW (r10 revoke machinery), a DRAINING node
        event tells elastic trainers to flush a checkpoint, and the
        update sweep releases the node once the drain is acknowledged
        or the deadline lapses — never before."""
        from ray_tpu_torch._private.config import CONFIG
        if deadline_s is None:
            deadline_s = CONFIG.drain_deadline_s
        deadline = time.monotonic() + max(0.0, float(deadline_s))
        # a pod slice preempts ATOMICALLY: terminate_node below deletes
        # the whole group, so every member must drain now — not just
        # the host the metadata watcher named
        group = self._provider.group_of(node_id) or [node_id]
        drained_any = False
        for m in group:
            if self._cluster.drain_node(m, deadline_s=float(deadline_s)):
                drained_any = True
        if not drained_any:
            # head / unknown / already-dead node: nothing was drained,
            # so nothing may be scheduled for termination either (a
            # bogus notice must not kill an undrained node at deadline)
            return
        self._draining[node_id] = deadline
        self.num_preemption_notices += 1

    def _drain_sweep(self, now: float) -> None:
        """Terminate drained nodes (every live member acked, or the
        deadline lapsed). A group that dies DURING its drain window
        just drops out of the sweep — the normal death recovery
        already ran, and keeping the entry would wedge the reconcile
        loop on a ghost."""
        for nid, deadline in list(self._draining.items()):
            # snapshot the group BEFORE terminate_node: slice providers
            # pop their membership maps on terminate, and the members
            # must still be cleaned out of _managed afterwards
            group = self._provider.group_of(nid) or [nid]
            recs = [self._cluster.get_node(m) for m in group]
            live = [r for r in recs if r is not None and r.alive]
            if not live:
                self._draining.pop(nid, None)
                continue
            if not (now >= deadline
                    or all(getattr(r, "drain_acked", False)
                           for r in live)):
                continue
            try:
                self._provider.terminate_node(nid)
            except Exception:
                # keep the entry: the node is still alive and still
                # draining cluster-side, so dropping it here would leak
                # an unschedulable host forever — retry next cycle
                # (transient cloud-API errors are the common case)
                import sys
                sys.stderr.write(f"ray_tpu_torch autoscaler: terminate of "
                                 f"drained node {nid} failed; will "
                                 f"retry\n")
                continue
            self._draining.pop(nid, None)
            for m in group:
                self._managed.pop(m, None)
                self._idle_since.pop(m, None)
                self._draining.pop(m, None)
            self.num_drained_kills += 1

    def _fits(self, shape: Dict[str, float],
              resources: Dict[str, float]) -> bool:
        # one feasibility definition for the whole runtime (epsilon'd):
        # scheduler.fits(avail, need)
        return _fits_with_eps(resources, shape)

    def _is_draining(self, node_id: str) -> bool:
        """Draining per THIS autoscaler's sweep or per the cluster's
        drain state (covers slice members drained alongside the keyed
        notice node)."""
        if node_id in self._draining:
            return True
        probe = getattr(self._cluster, "is_draining", None)
        return bool(probe(node_id)) if probe is not None else False

    def _count_type(self, name: str) -> int:
        # Draining nodes are capacity that is already leaving: they
        # don't count toward max_workers, so a preempted node's
        # replacement can launch BEFORE the old host is released
        # (transiently max_workers + draining hosts exist — the
        # preemption overlap, not a cap violation).
        return sum(1 for nid, t in self._managed.items()
                   if t == name and not self._is_draining(nid))

    # ---------------------------------------------------------- update
    def update(self) -> None:
        """One reconcile step (call directly in tests; the background
        loop calls it on update_interval_s)."""
        now = time.monotonic()
        # preemption drains first: a node past its window must release
        # this cycle, and dead-mid-drain entries must never wedge below
        self._drain_sweep(now)
        alive = {n.node_id for n in self._cluster.alive_nodes()}
        # launches leave the in-flight set once the node has
        # REGISTERED with the cluster (alive or since dead — a
        # registered-then-crashed node is dead capacity, not pending
        # capacity) or the grace window lapses
        registered = {n.node_id for n in self._cluster.nodes()}
        self._in_flight_launches = [
            (nid, res, at) for nid, res, at in self._in_flight_launches
            if nid not in registered
            and now - at < self.provision_grace_s]
        inflight_ids = {nid for nid, _, _ in self._in_flight_launches}
        # forget managed nodes that died (else a crashed node counts
        # toward max_workers forever and blocks its own replacement) —
        # but NOT nodes still provisioning (async providers pre-mint
        # ids that register seconds later)
        for nid in list(self._managed):
            if nid not in alive and nid not in inflight_ids:
                self._managed.pop(nid, None)
                self._idle_since.pop(nid, None)
        # adopt nodes carrying our type label that we lost track of
        # (e.g. a slice that registered after the provision grace):
        # unmanaged live nodes would never scale down
        for node in self._cluster.alive_nodes():
            if node.node_id in self._managed or node.is_head:
                continue
            tname = node.labels.get("ray_tpu.io/node-type")
            if tname in self._types:
                self._managed[node.node_id] = tname
        # demand NO node type can satisfy fails fast instead of parking
        self._cluster.fail_type_infeasible(
            lambda shape: any(self._fits(shape, t.resources)
                              for t in self._types.values()))
        # min_workers floors
        for t in self._types.values():
            while self._count_type(t.name) < t.min_workers:
                self._scale_up(t)
        # demand-driven scale up with planned-capacity packing: fill
        # nodes launched THIS cycle before launching more (reference
        # v2 scheduler bin-packs demand into node-type bins)
        planned: List[Dict[str, float]] = [
            dict(res) for _, res, _ in self._in_flight_launches]
        for shape in self._unmet_demand():
            placed = False
            for cap in planned:
                if self._fits(shape, cap):
                    for k, v in shape.items():
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            for t in self._types.values():
                if not self._fits(shape, t.resources):
                    continue
                if (self._count_type(t.name) + t.hosts
                        > t.max_workers):
                    continue
                caps = self._scale_up(t)
                for k, v in shape.items():
                    caps[0][k] = caps[0].get(k, 0.0) - v
                planned.extend(caps)
                break
        # queue-latency signal: scale up when the windowed queue-wait
        # p95 breaches the SLO threshold, even though every shape fits
        self._maybe_latency_scale_up(now)
        # idle scale down (an atomic multi-host group only retires once
        # EVERY member is idle past the timeout)
        idle_map = {}
        for node in self._cluster.alive_nodes():
            nid = node.node_id
            if node.is_head or nid not in self._managed:
                continue
            if self._is_draining(nid):
                continue            # the drain sweep owns its release
            if getattr(node, "suspect", False):
                # r17: a suspect node's is_idle() view is stale by
                # definition — never retire a host mid-gray-failure
                # (if it is truly dead the death path reclaims it)
                self._idle_since.pop(nid, None)
                continue
            if not node.scheduler.is_idle():
                self._idle_since.pop(nid, None)
                idle_map[nid] = False
                continue
            first = self._idle_since.setdefault(nid, now)
            idle_map[nid] = now - first > self.idle_timeout_s
        retired: set = set()
        for nid, expired in idle_map.items():
            if not expired or nid in retired or nid not in self._managed:
                continue
            group = self._provider.group_of(nid) or [nid]
            # dead group members (a crashed slice host) count as
            # retire-ready — they can never become idle, and keeping
            # the survivors alive for them leaks the whole slice. But a
            # member still PROVISIONING (in flight, not yet registered)
            # blocks retirement: terminating mid-boot would thrash.
            if not all(idle_map.get(
                    m, m not in alive and m not in inflight_ids)
                    for m in group):
                continue
            tname = self._managed[nid]
            live_members = [m for m in group if m in self._managed]
            if (self._count_type(tname) - len(live_members)
                    < self._types[tname].min_workers):
                continue
            self._scale_down(nid)
            retired.update(group)

    def _scale_up(self, t: NodeTypeConfig) -> List[Dict[str, float]]:
        """Provision one unit of `t` (1 host, or an atomic multi-host
        slice); returns the per-host planned capacities."""
        out = self._provider.create_node(t)
        nids = [out] if isinstance(out, str) else list(out)
        now = time.monotonic()
        caps = []
        for nid in nids:
            self._managed[nid] = t.name
            self._in_flight_launches.append(
                (nid, dict(t.resources), now))
            caps.append(dict(t.resources))
        self.num_scale_ups += 1
        return caps

    def _scale_down(self, node_id: str) -> None:
        group = self._provider.group_of(node_id) or [node_id]
        self._provider.terminate_node(node_id)
        for nid in group:
            self._managed.pop(nid, None)
            self._idle_since.pop(nid, None)
        self.num_scale_downs += 1

    def stats(self) -> Dict[str, int]:
        p95 = self.last_queue_wait_p95
        if p95 == float("inf"):
            p95 = None          # keep stats() strict-JSON-valid (the
                                # raw inf still trips the trigger)
        return {"managed_nodes": len(self._managed),
                "num_scale_ups": self.num_scale_ups,
                "num_scale_downs": self.num_scale_downs,
                "num_latency_scale_ups": self.num_latency_scale_ups,
                "num_preemption_notices": self.num_preemption_notices,
                "num_drained_kills": self.num_drained_kills,
                "draining_nodes": len(self._draining),
                "last_queue_wait_p95": p95}
