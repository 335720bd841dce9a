"""Seeded chaos soak on the port (`ray_tpu_torch`): the copy of
`tools/chaos_soak.py`, less its RL scenarios, which wait for the port of
`rllib` (ROADMAP queue 1, items 7-8). The r17 kill / partition / blip
scenario matrix with per-scenario exactly-once accounting.

Each scenario joins a fresh node-agent subprocess under a unique
resource tag, drives a drain of N tasks pinned to it, injects its
fault mid-drain, and then audits the head's books:

- every ref resolves to the expected value (zero lost),
- at most one terminal task event per task id (zero double-counted),
- no task left on the live-task table,
- scenario-specific liveness assertions (a blip must trigger ZERO
  recoveries; a partition must end in a fence + fresh re-register).

Runnable standalone::

    python tools/torch_chaos_soak.py --scenarios kill,partition,blip \
        --seeds 1,2,3 --tasks 500

and as one slow-marked pytest entry
(tests/test_torch_membership.py::test_chaos_soak_matrix).
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:          # standalone: python tools/torch_chaos_soak.py
    sys.path.insert(0, _REPO)

SCENARIOS = ("kill", "partition", "blip", "actor_kill",
             "actor_partition", "llm_replica_kill",
             "llm_replica_partition")


def _wait(pred, timeout=30.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return True
        except Exception:
            pass
        time.sleep(step)
    return False


def _join_agent(rt, agents, resources):
    from ray_tpu_torch.cluster_utils import NodeAgentProcess
    known = {n.node_id for n in rt.cluster.alive_nodes()}
    agents.append(NodeAgentProcess(num_cpus=4, resources=resources))
    assert _wait(lambda: len(rt.cluster.alive_nodes()) > len(known), 30), \
        "agent failed to register"
    return [n.node_id for n in rt.cluster.alive_nodes()
            if n.node_id not in known][0]


def run_scenario(rt, agents, scenario: str, seed: int = 0,
                 tasks: int = 500) -> dict:
    """One scenario against a LIVE head runtime (the caller owns its
    lifecycle); returns an accounting report with ``ok``."""
    import ray_tpu_torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "tests"))
    import torch_chaos as chaos

    tag = f"soak_{scenario}_{seed}"
    nid = _join_agent(rt, agents, {tag: 1e9})
    inc0 = rt.controller.node_incarnation(nid)
    deaths0 = rt.cluster.liveness_counters["deaths"]

    @ray_tpu_torch.remote(resources={tag: 1.0})
    def f(x):
        return x * 7

    t0 = time.time()
    refs = [f.remote(i) for i in range(tasks)]
    task_ids = {r.object_id.split("r", 1)[0] for r in refs}
    _wait(lambda: len(set(rt.controller.live_task_ids()) & task_ids)
          <= max(0, tasks - tasks // 5), 60)

    if scenario == "kill":
        chaos.kill_agent(agents[-1])
        assert _wait(lambda: not rt.cluster.get_node(nid).alive, 20), \
            "killed agent not declared dead"
        # replacement capacity under the same tag absorbs the re-place
        _join_agent(rt, agents, {tag: 1e9})
    elif scenario == "partition":
        chaos.partition(rt, nid)
        assert _wait(lambda: not rt.cluster.get_node(nid).alive, 20), \
            "partitioned agent not declared dead"
        time.sleep(0.3)
        chaos.heal(rt, nid)
        assert _wait(lambda: rt.cluster.get_node(nid).alive, 30), \
            "fenced agent did not re-register"
    elif scenario == "blip":
        from ray_tpu_torch._private.config import CONFIG
        chaos.partition(rt, nid)
        time.sleep(max(0.05, CONFIG.suspect_s * 0.4))
        chaos.heal(rt, nid)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")

    vals = ray_tpu_torch.get(refs, timeout=180)
    lost = sum(1 for i, v in enumerate(vals) if v != i * 7)
    term = collections.Counter()
    for ev in rt.controller.list_task_events(1 << 20):
        if (ev["task_id"] in task_ids
                and ev["state"] in ("FINISHED", "FAILED", "CANCELLED")):
            term[ev["task_id"]] += 1
    dups = sum(1 for c in term.values() if c > 1)
    leaked = len(set(rt.controller.live_task_ids()) & task_ids)
    report = {
        "scenario": scenario, "seed": seed, "tasks": tasks,
        "wall_s": round(time.time() - t0, 2),
        "lost": lost, "double_counted": dups,
        "terminal_seen": len(term), "live_leaked": leaked,
        "fence": dict(rt._fence_stats),
        "liveness": dict(rt.cluster.liveness_counters),
    }
    ok = lost == 0 and dups == 0 and leaked == 0
    if scenario == "blip":
        # a sub-suspect blip must be free: no death, no new epoch
        ok = ok and rt.cluster.liveness_counters["deaths"] == deaths0
        ok = ok and rt.controller.node_incarnation(nid) == inc0
    elif scenario == "partition":
        ok = ok and rt.controller.node_incarnation(nid) > inc0
        ok = ok and rt._fence_stats["fence_notices"] >= 1
    report["ok"] = ok
    return report


def run_actor_scenario(rt, agents, scenario: str, seed: int = 0,
                       calls: int = 200) -> dict:
    """r18 direct actor plane gates: kill or partition the hosting
    node MID-DIRECT-CALL stream. Every call must resolve exactly once
    or error with ActorDiedError/ActorError — zero hangs — and a
    partitioned (zombie) endpoint must be fenced: the node re-registers
    under a fresh incarnation and the caller's stream lands on the
    re-placed books, never double-resolving a call."""
    import ray_tpu_torch
    from ray_tpu_torch.exceptions import RayTpuError
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "tests"))
    import torch_chaos as chaos

    kind = scenario.split("_", 1)[1]          # kill | partition
    tag = f"soak_{scenario}_{seed}"
    nid = _join_agent(rt, agents, {tag: 1e9})
    inc0 = rt.controller.node_incarnation(nid)

    @ray_tpu_torch.remote(resources={tag: 1.0})
    class T:
        def bump(self, i):
            return i * 3

    t0 = time.time()
    a = T.options(max_restarts=2, max_task_retries=1).remote()
    assert ray_tpu_torch.get(a.bump.remote(0), timeout=60) == 0
    time.sleep(1.2)        # worker-direct endpoint reaches steady state
    d0 = dict(rt._direct_stats)
    refs = [a.bump.remote(i) for i in range(calls // 2)]
    if kind == "kill":
        rec = rt.controller.get_actor(a._actor_id)
        if rec.worker_id is not None:
            chaos.drop_worker(rt, nid, rec.worker_id)
    else:
        chaos.partition(rt, nid)
        assert _wait(lambda: not rt.cluster.get_node(nid).alive, 20), \
            "partitioned agent not declared dead"
        time.sleep(0.3)
        chaos.heal(rt, nid)
        assert _wait(lambda: rt.cluster.get_node(nid).alive, 30), \
            "fenced agent did not re-register"
    refs += [a.bump.remote(i) for i in range(calls // 2, calls)]
    values, errors, hangs = 0, 0, 0
    wrong = 0
    for i, r in enumerate(refs):
        try:
            v = ray_tpu_torch.get(r, timeout=90)
            values += 1
            if v != i * 3:
                wrong += 1
        except RayTpuError:
            errors += 1
        except Exception:
            hangs += 1              # GetTimeoutError = a hung call
    d1 = rt._direct_stats
    report = {
        "scenario": scenario, "seed": seed, "calls": calls,
        "wall_s": round(time.time() - t0, 2),
        "values": values, "errors": errors, "hangs": hangs,
        "wrong": wrong,
        "direct_calls": d1["direct_calls"] - d0["direct_calls"],
        "redirects": d1["redirects"] - d0["redirects"],
        "stale_replies": d1["stale_replies"] - d0["stale_replies"],
    }
    ok = (hangs == 0 and wrong == 0
          and values + errors == calls
          and report["direct_calls"] > 0)
    if kind == "partition":
        # zombie endpoint fenced: fresh incarnation after the heal
        ok = ok and rt.controller.node_incarnation(nid) > inc0
    report["ok"] = ok
    return report


def run_llm_scenario(rt, agents, scenario: str, seed: int = 0,
                     requests: int = 6, max_tokens: int = 32) -> dict:
    """r19 LLM serving gates: kill or partition a replica group
    MID-GENERATION with concurrent streams in flight. Every accepted
    request must complete on a survivor or error exactly once — and
    because decode is greedy-deterministic, a completed stream must
    equal the tokens an undisturbed engine emits for the same prompt:
    any duplicated, lost, or interleaved zombie token breaks equality.
    """
    import threading

    import ray_tpu_torch
    from ray_tpu_torch import serve as _serve
    from ray_tpu_torch.serve import llm
    from ray_tpu_torch.serve.llm.stream import STREAM_STATS
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "tests"))
    import torch_chaos as chaos

    kind = scenario.split("_")[-1]            # kill | partition
    tag = f"soak_{scenario}_{seed}"
    # controller pinned to the head BEFORE agents join: the chaos
    # target must never host the serve control plane
    ray_tpu_torch.remote(max_concurrency=16, resources={"head": 0.01})(
        _serve.ServeController).options(
            name=_serve._CONTROLLER_NAME, get_if_exists=True).remote()
    # pace the step loop so generations outlive fault detection (the
    # agents — and their workers — inherit this env at spawn)
    os.environ["RAY_TPU_LLM_STEP_DELAY_S"] = "0.08"
    # one replica per agent: each agent carries exactly one tag slot
    nids = [_join_agent(rt, agents, {tag: 1.0}) for _ in range(2)]
    inc0 = {n: rt.controller.node_incarnation(n) for n in nids}

    t0 = time.time()
    handle = llm.serve_llm(
        name=f"llm_{scenario}_{seed}", model="tiny", num_replicas=2,
        num_pages=64, page_size=8, max_batch=8,
        ray_actor_options={"resources": {tag: 1.0}})
    # wait for both replicas to land on DISTINCT agents: the fault
    # must leave a live survivor, or failover has nowhere to go
    def _spread():
        reps = ray_tpu_torch.get(
            handle._controller.get_replicas.remote(handle._name))
        recs = [rt.controller.get_actor(r._actor_id) for r in reps]
        nodes = {rec.node_id for rec in recs if rec is not None}
        return len(recs) == 2 and len(nodes) == 2
    assert _wait(_spread, 60), "replicas did not spread across agents"
    prompts = [[seed % 251 + 1, i + 1, 2 * i + 3, 7]
               for i in range(requests)]
    # undisturbed reference streams, one per prompt, BEFORE the fault
    refs = {i: handle.generate(p, max_tokens=max_tokens,
                               timeout_s=60).tokens()
            for i, p in enumerate(prompts)}

    z0 = STREAM_STATS["zombie_dropped"]
    streams = [handle.generate(p, max_tokens=max_tokens, timeout_s=8)
               for p in prompts]
    # let every stream produce at least one token so the fault lands
    # mid-generation, not pre-admission
    for s in streams:
        next(iter(s))
    victim_aid = streams[0]._replica._actor_id
    rec = rt.controller.get_actor(victim_aid)
    victim_nid = rec.node_id
    if kind == "kill":
        chaos.drop_worker(rt, victim_nid, rec.worker_id)
    else:
        # the token stream is a peer-dialed socket, not the head<->
        # agent wire: tag it with the victim node so the protocol-
        # level partition parks its frames too (a real partition cuts
        # the whole node, not just the control plane)
        from ray_tpu_torch.serve.llm.stream import stream_client
        sc = stream_client()
        for s in streams:
            ad = getattr(s, "_stream_addr", None)
            if ad is not None:
                conn = sc._conns.get((ad[0], int(ad[1])))
                if conn is not None:
                    rc = rt.controller.get_actor(s._replica._actor_id)
                    conn.meta["chaos_peer"] = rc.node_id
        chaos.partition(rt, victim_nid)
        assert _wait(lambda: not rt.cluster.get_node(victim_nid).alive,
                     20), "partitioned agent not declared dead"
        time.sleep(0.3)
        chaos.heal(rt, victim_nid)
        assert _wait(lambda: rt.cluster.get_node(victim_nid).alive, 30), \
            "fenced agent did not re-register"

    done, errors, hangs, mismatches, failovers = 0, 0, 0, 0, 0
    lock = threading.Lock()

    def consume(i, s):
        nonlocal done, errors, hangs, mismatches, failovers
        try:
            toks = s.tokens()
            with lock:
                done += 1
                if list(toks) != list(refs[i]):
                    mismatches += 1
                if s._attempt > 0:
                    failovers += 1
        except RuntimeError:
            with lock:
                errors += 1
        except BaseException:
            with lock:
                hangs += 1

    threads = [threading.Thread(target=consume, args=(i, s))
               for i, s in enumerate(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    hangs += sum(1 for t in threads if t.is_alive())

    report = {
        "scenario": scenario, "seed": seed, "requests": requests,
        "wall_s": round(time.time() - t0, 2),
        "done": done, "errors": errors, "hangs": hangs,
        "mismatches": mismatches, "failovers": failovers,
        "zombie_dropped": STREAM_STATS["zombie_dropped"] - z0,
    }
    ok = (hangs == 0 and mismatches == 0
          and done + errors == requests
          and errors == 0            # a survivor existed: all complete
          and failovers >= 1)        # the fault actually hit a stream
    if kind == "partition":
        ok = ok and rt.controller.node_incarnation(victim_nid) \
            > inc0[victim_nid]
    report["ok"] = ok
    try:
        _serve.shutdown()
    except BaseException:
        pass
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch_chaos_soak")
    p.add_argument("--scenarios", default=",".join(SCENARIOS))
    p.add_argument("--seeds", default="0")
    p.add_argument("--tasks", type=int, default=500)
    args = p.parse_args(argv)

    os.environ.setdefault("RAY_TPU_CHAOS", "1")
    os.environ.setdefault("RAY_TPU_HEARTBEAT_TIMEOUT_S", "1.0")
    os.environ.setdefault("RAY_TPU_SUSPECT_S", "0.7")
    os.environ.setdefault("RAY_TPU_TASK_EVENT_HISTORY", "200000")
    from ray_tpu_torch._private.config import CONFIG
    CONFIG.reload()

    import ray_tpu_torch
    failures = 0
    for seed in (int(s) for s in args.seeds.split(",") if s):
        os.environ["RAY_TPU_CHAOS_SEED"] = str(seed)
        CONFIG.reload()
        rt = ray_tpu_torch.init(num_cpus=1, resources={"head": 4.0})
        agents: list = []
        try:
            for scenario in args.scenarios.split(","):
                scenario = scenario.strip()
                if scenario.startswith("llm_"):
                    rep = run_llm_scenario(rt, agents, scenario,
                                           seed=seed)
                elif scenario.startswith("actor_"):
                    rep = run_actor_scenario(rt, agents, scenario,
                                             seed=seed)
                else:
                    rep = run_scenario(rt, agents, scenario,
                                       seed=seed, tasks=args.tasks)
                flag = "OK " if rep["ok"] else "FAIL"
                print(f"[{flag}] {rep}")
                if not rep["ok"]:
                    failures += 1
        finally:
            sys.path.insert(0, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "..", "tests"))
            import torch_chaos as chaos
            chaos.heal()
            for a in agents:
                a.terminate()
            for a in agents:
                a.wait(5)
            ray_tpu_torch.shutdown()
    print(f"chaos soak: {failures} failing scenario(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
