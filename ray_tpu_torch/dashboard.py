"""Dashboard: HTTP observability endpoints + minimal HTML view.

The counterpart of `ray_tpu/dashboard.py`, over the port's state API,
metrics plane and job client; `/api/cluster` reports the `GPU`
resource as the runtime counts it.

Parity (shape): reference dashboard head (dashboard/head.py:61) with
its per-entity modules — reduced to a driver-thread HTTP server over
the state API + metrics registry. Endpoints:

  GET /api/nodes /api/actors /api/tasks /api/placement_groups
  GET /api/cluster      (total/available resources + object store)
  GET /api/task_summary /api/actor_summary
  GET /api/jobs         (submitted jobs, reference modules/job)
  GET /api/logs         (available job log files)
  GET /api/logs/<job>   (tail of one job's log; ?lines=N)
  GET /api/serve_applications  (serve apps -> deployments/replicas)
  GET /api/timeline     (Chrome-trace JSON of recorded task events —
                         load in Perfetto / chrome://tracing)
  GET /api/metrics_summary  (cluster metrics JSON: windowed task-
                         latency percentiles + sparkline ring, r11)
  GET /metrics          (Prometheus exposition — CLUSTER-aggregated
                         when a runtime is attached: every process's
                         registry merged with node/worker labels;
                         head-local util.metrics otherwise)
  GET /                 (single-page frontend app: tabbed views over
                         the JSON API with utilization + host-stats
                         bars, auto-refreshing; no external assets)
"""
from __future__ import annotations

import json
import threading
from typing import Optional

_SERVER = None

_INDEX_HTML = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><style>
body{font-family:ui-monospace,Menlo,monospace;margin:0;background:#0e1116;
 color:#d6dbe3}
header{display:flex;align-items:baseline;gap:1.2em;padding:.7em 1.2em;
 background:#151a22;border-bottom:1px solid #2a3240}
h1{font-size:1.1em;margin:0;color:#8ab4f8}
#age{color:#6b7686;font-size:.8em}
nav{display:flex;gap:.2em;padding:.4em 1em;background:#11151c}
nav button{background:none;border:0;color:#9aa5b5;font:inherit;
 padding:.35em .8em;cursor:pointer;border-radius:4px}
nav button.on{background:#223049;color:#cfe1ff}
main{padding:1em 1.2em}
h2{color:#8ab4f8;font-size:.95em;margin:1.2em 0 .4em}
table{border-collapse:collapse;margin-bottom:1em;font-size:.85em}
td,th{border:1px solid #2a3240;padding:3px 9px;text-align:left}
th{background:#1a2230;color:#aebdd4}
tr:nth-child(even) td{background:#121823}
.bar{display:inline-block;width:120px;height:9px;background:#222b3a;
 border-radius:4px;vertical-align:middle;margin-right:.5em}
.bar i{display:block;height:100%;border-radius:4px;background:#4f8ef7}
.bar i.hot{background:#e2734b}
.kpis{display:flex;gap:1em;flex-wrap:wrap;margin:.6em 0}
.kpi{background:#151c28;border:1px solid #283142;border-radius:6px;
 padding:.6em 1em;min-width:9em}
.kpi b{display:block;font-size:1.3em;color:#e8eef7}
.kpi span{color:#8a96a8;font-size:.75em}
a{color:#8ab4f8}
i.none{color:#5a6474}
</style></head><body>
<header><h1>ray_tpu_torch</h1><span id="age"></span>
<span style="flex:1"></span>
<a href="/api/timeline" download="timeline.json">timeline</a>
<a href="/metrics">metrics</a></header>
<nav id="nav"></nav><main id="out">loading…</main>
<script>
const TABS={Overview:ovw,Nodes:nodes,Workers:workers,Actors:actors,
            Tasks:tasks,Metrics:metricsTab,Serve:serveApps,Jobs:jobs,
            "Placement Groups":pgs};
let cur="Overview", cache={};
async function J(p){const r=await fetch("/api/"+p);return r.json()}
function esc(x){return String(x).replace(/&/g,"&amp;").replace(/</g,"&lt;")}
function cell(v){return typeof v==="object"&&v!==null?
  esc(JSON.stringify(v)):esc(v)}
function table(rows,keys){
  if(!Array.isArray(rows)) rows=[rows];
  if(!rows.length) return "<i class=none>none</i>";
  keys=keys||Object.keys(rows[0]);
  return "<table><tr>"+keys.map(k=>`<th>${esc(k)}</th>`).join("")+"</tr>"+
    rows.map(r=>"<tr>"+keys.map(k=>`<td>${cell(r[k]??"")}</td>`)
      .join("")+"</tr>").join("")+"</table>";
}
function bar(frac,label){
  const pct=Math.min(100,Math.round(100*frac));
  return `<span class=bar><i class="${pct>85?"hot":""}"
    style="width:${pct}%"></i></span>${label??pct+"%"}`;
}
function kpi(v,l){return `<div class=kpi><b>${v}</b><span>${l}</span></div>`}
async function ovw(){
  const c=await J("cluster"),u=await J("usage");
  let h="<div class=kpis>";
  h+=kpi(u.nodes_alive,"alive nodes"+(u.nodes_dead?
        ` (+${u.nodes_dead} dead)`:""));
  h+=kpi(u.workers,"workers");
  h+=kpi(Object.values(u.actors).reduce((a,b)=>a+b,0)||0,"actors");
  h+=kpi(Object.entries(u.tasks).map(([k,v])=>`${k}:${v}`).join(" ")
         ||"0","task states");
  h+=kpi((c.object_store.bytes/1048576).toFixed(1)+" MB","object store");
  h+=kpi((u.uptime_s/60).toFixed(1)+" min","uptime");
  h+="</div><h2>resources</h2><table><tr><th>resource</th><th>used</th>"+
     "<th>total</th><th></th></tr>";
  for(const k of Object.keys(c.total)){
    const t=c.total[k],a=c.available[k]??0,u=t-a;
    h+=`<tr><td>${esc(k)}</td><td>${u.toFixed(1)}</td>`+
       `<td>${t.toFixed(1)}</td><td>${bar(t?u/t:0)}</td></tr>`;
  }
  return h+"</table>";
}
async function nodes(){
  const ns=await J("nodes");
  let h="<h2>nodes</h2><table><tr><th>node</th><th>state</th>"+
   "<th>head</th><th>resources</th><th>labels</th><th>load</th>"+
   "<th>memory</th><th>workers rss</th></tr>";
  for(const n of ns){
    const s=n.host_stats||{};
    h+=`<tr><td>${esc(n.node_id)}</td>`+
     `<td>${n.alive?"ALIVE":"DEAD "+esc(n.death_cause||"")}</td>`+
     `<td>${n.is_head?"*":""}</td><td>${cell(n.resources)}</td>`+
     `<td>${cell(n.labels)}</td>`+
     `<td>${s.load_1m!=null?bar((s.load_1m||0)/(s.num_cpus||1),
           s.load_1m+" / "+s.num_cpus+" cpus"):""}</td>`+
     `<td>${s.mem_used_pct!=null?bar(s.mem_used_pct/100):""}</td>`+
     `<td>${s.workers_rss_mb!=null?
           s.workers_rss_mb+" MB ("+(s.num_workers||0)+"w)":""}</td></tr>`;
  }
  return h+"</table>";
}
async function workers(){
  return "<h2>workers</h2>"+table(await J("workers"),
   ["node_id","worker_id","pid","state","actor_id","inflight_tasks",
    "blocked_depth","env_hash","age_s"]);
}
async function actors(){return "<h2>actors</h2>"+table(await J("actors"))}
async function tasks(){
  const sum=await J("task_summary"),evs=await J("tasks");
  return "<h2>summary</h2>"+table([sum])+
    "<h2>recent events</h2>"+table(evs.slice(-60).reverse());
}
async function pgs(){
  return "<h2>placement groups</h2>"+table(await J("placement_groups"))}
function fmtMs(s){return s==null?"—":(s*1000).toFixed(s<0.01?2:0)+" ms"}
function spark(label,vals){
  const nums=vals.map(v=>v==null?0:v), w=240, hh=36;
  const max=Math.max(...nums,1e-9);
  const pts=nums.map((v,i)=>
    `${(i/Math.max(nums.length-1,1))*w},${hh-1-(v/max)*(hh-3)}`
  ).join(" ");
  return `<div class=kpi><svg width="${w}" height="${hh}">`+
    `<polyline fill="none" stroke="#4f8ef7" stroke-width="1.5" `+
    `points="${pts}"/></svg><span>${esc(label)} · max `+
    `${Math.round(max*100)/100}</span></div>`;
}
async function metricsTab(){
  const m=await J("metrics_summary");
  if(m.error) return "<i class=none>"+esc(m.error)+"</i>";
  if(!m.enabled)
    return "<i class=none>metrics disabled (RAY_TPU_METRICS=0)</i>";
  let h="<div class=kpis>";
  h+=kpi(m.sources,"processes scraped");
  h+=kpi(m.tasks_done_total,"tasks done");
  h+=kpi(fmtMs(m.queue_wait.p95),"queue wait p95 ≤");
  h+=kpi(fmtMs(m.e2e.p95),"e2e p95 ≤");
  h+=kpi(m.shm_pool_hit_rate==null?"—":
         Math.round(m.shm_pool_hit_rate*100)+"%","shm pool hit rate");
  h+=kpi(m.lease_outstanding,"leased outstanding");
  h+="</div><h2>phase latency (last "+m.window_s+"s, bucket upper "+
     "bounds)</h2>";
  h+=table(["queue_wait","exec","e2e"].map(p=>
    Object.assign({phase:p},m[p])),["phase","count","p50","p95","p99"]);
  h+="<h2>trends (per scrape)</h2><div class=kpis>";
  h+=spark("tasks/s",m.ring.map(r=>r.tasks_per_s));
  h+=spark("queue p95 ms",m.ring.map(r=>r.queue_p95_ms));
  h+=spark("wire frames/s",m.ring.map(r=>r.wire_frames_per_s));
  h+=spark("pull in-flight MB",m.ring.map(r=>r.pull_inflight_mb));
  return h+"</div>";
}
async function serveApps(){
  const apps=await J("serve_applications");
  const names=Object.keys(apps);
  if(!names.length) return "<i class=none>no applications</i>";
  let h="";
  for(const a of names){
    const rec=apps[a];
    h+=`<h2>${esc(a)} <small>(${esc(rec.route_prefix)} → `+
       `${esc(rec.ingress)})</small></h2>`;
    h+=table(Object.entries(rec.deployments).map(([d,v])=>
       Object.assign({deployment:d},v)),
       ["deployment","live_replicas","target_replicas",
        "ongoing_requests","autoscaling"]);
  }
  return h;
}
async function jobs(){
  const js=await J("jobs"),logs=await J("logs");
  return "<h2>jobs</h2>"+table(js)+"<h2>logs</h2>"+
    (Array.isArray(logs)&&logs.length?logs.map(f=>
     `<a href="/api/logs/${esc(f)}">${esc(f)}</a>`).join("<br>")
     :"<i class=none>none</i>");
}
function nav(){
  document.getElementById("nav").innerHTML=Object.keys(TABS).map(t=>
   `<button class="${t===cur?"on":""}" onclick="go('${t}')">${t}</button>`
  ).join("");
}
async function go(t){cur=t;nav();await refresh()}
async function refresh(){
  try{
    document.getElementById("out").innerHTML=await TABS[cur]();
    document.getElementById("age").textContent=
      "updated "+new Date().toLocaleTimeString();
  }catch(e){
    document.getElementById("out").innerHTML=
      "<i class=none>"+esc(e)+"</i>";
  }
}
nav();refresh();setInterval(refresh,4000);
</script></body></html>"""


def start_dashboard(port: int = 8265, host: str = "127.0.0.1") -> int:
    """Serve the dashboard from the driver; returns the bound port."""
    global _SERVER
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ray_tpu_torch.util import state as state_api
    from ray_tpu_torch.util.metrics import DEFAULT_REGISTRY

    def api(path: str):
        from urllib.parse import parse_qs, urlsplit
        url = urlsplit(path)
        path, query = url.path, parse_qs(url.query)
        if path.startswith("logs"):
            from ray_tpu_torch.job_submission import default_client
            client = default_client()
            parts = path.split("/", 1)
            if len(parts) == 1 or not parts[1]:
                return client.list_log_files()
            lines = int(query.get("lines", ["200"])[0])
            return {"job_id": parts[1],
                    "lines": client.tail_logs(parts[1], lines)}
        if path == "jobs":
            import dataclasses as _dc

            from ray_tpu_torch.job_submission import default_client
            return [_dc.asdict(j) for j in
                    default_client().list_jobs()]
        if path == "actor_summary":
            return state_api.summarize_actors()
        if path == "nodes":
            return state_api.list_nodes()
        if path == "workers":
            return state_api.list_workers()
        if path == "usage":
            return state_api.usage_stats()
        if path == "actors":
            return state_api.list_actors()
        if path == "tasks":
            return state_api.list_tasks()
        if path == "task_summary":
            return state_api.summarize_tasks()
        if path == "placement_groups":
            return state_api.list_placement_groups()
        if path == "cluster":
            return {"total": state_api.cluster_resources(),
                    "available": state_api.available_resources(),
                    "object_store": state_api.object_store_stats()}
        if path == "serve_applications":
            try:
                import ray_tpu_torch
                from ray_tpu_torch.serve import _CONTROLLER_NAME
                controller = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
            except ValueError:
                return {}          # serve not running
            return ray_tpu_torch.get(
                controller.list_applications.remote(), timeout=10)
        if path == "timeline":
            from ray_tpu_torch.util.metrics import timeline
            return timeline()
        if path == "metrics_summary":
            from ray_tpu_torch._private import context as _context
            return _context.get_ctx().state_op("metrics_summary")
        raise KeyError(path)

    last_cluster_text: list = [None]

    def metrics_text() -> str:
        """Cluster-aggregated exposition when a runtime is attached
        (r11: every process's registry merged with node/worker
        labels); the head-local registry otherwise — a dashboard
        started without init() keeps scraping something. A transient
        collect failure re-serves the LAST cluster exposition rather
        than flipping to the unlabeled head-local schema (a phantom
        label change would fork every series Prometheus-side)."""
        from ray_tpu_torch._private import context as _context
        from ray_tpu_torch._private import metrics_plane as _mp
        ctx = _context.maybe_ctx()
        if ctx is not None and _mp.enabled():
            try:
                merged = ctx.state_op("metrics_dump")
                if merged:
                    text = _mp.prometheus_text(merged)
                    last_cluster_text[0] = text
                    return text
            except Exception:
                pass           # head unreachable: degrade below
            if last_cluster_text[0] is not None:
                return last_cluster_text[0]   # stale beats schema flip
        return DEFAULT_REGISTRY.prometheus_text()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            try:
                if self.path == "/" or self.path == "/index.html":
                    body = _INDEX_HTML.encode()
                    ctype = "text/html"
                elif self.path == "/metrics":
                    body = metrics_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/api/"):
                    body = json.dumps(api(self.path[5:]),
                                      default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
            except BaseException as e:  # noqa: BLE001
                body = json.dumps({"error": repr(e)}).encode()
                ctype = "application/json"
                self.send_response(500)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    _SERVER = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=_SERVER.serve_forever, daemon=True).start()
    return _SERVER.server_address[1]


def stop_dashboard() -> None:
    global _SERVER
    if _SERVER is not None:
        _SERVER.shutdown()
        _SERVER = None
