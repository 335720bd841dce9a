"""Serve on the port: the twin of `tests/test_serve.py`, test for test,
run on `ray_tpu_torch.serve` over the port's own runtime.

Deploy -> call through handle -> kill replica -> controller restores ->
scale -> HTTP and gRPC ingress, composition, multi-app routing. The same
two cases are marked slow as in the JAX file.

The runtime fixtures are this file's own (`tests/conftest.py` starts the
JAX runtime under the same names); the port's runtime is shut down when
the module ends.
"""
import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module", autouse=True)
def _port_runtime_down_at_module_end():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@pytest.fixture()
def ray_cluster():
    yield ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)


@pytest.fixture()
def serve_shutdown(ray_cluster):
    yield
    serve.shutdown()


def _echo_deployment():
    @serve.deployment(num_replicas=2)
    class Echo:
        def __init__(self, prefix):
            self.prefix = prefix
            import os
            self.pid = os.getpid()

        def __call__(self, x):
            return f"{self.prefix}:{x}"

        def whoami(self):
            return self.pid
    return Echo


def test_serve_deploy_and_route(serve_shutdown):
    Echo = _echo_deployment()
    handle = serve.run(Echo.bind("e"), name="echo")
    out = ray_tpu_torch.get([handle.remote(i) for i in range(6)])
    assert out == [f"e:{i}" for i in range(6)]
    # two replicas actually exist and both serve traffic
    pids = set(ray_tpu_torch.get([handle.method("whoami") for _ in range(16)]))
    assert len(pids) == 2
    st = serve.status()
    assert st["echo"]["live_replicas"] == 2


@pytest.mark.slow        # ~32s (replica worker respawn is wall-clock
                         # bound); serve liveness/autoscale/multi-app
                         # stay in tier-1, and the full default suite
                         # runs this (870s tier-1 budget, ROADMAP.md)
def test_serve_replica_recovery(serve_shutdown):
    Echo = _echo_deployment()
    handle = serve.run(Echo.bind("r"), name="rec")
    pids = set(ray_tpu_torch.get([handle.method("whoami") for _ in range(16)]))
    assert len(pids) == 2
    # kill one replica out from under the controller
    replicas = ray_tpu_torch.get(
        handle._controller.get_replicas.remote("rec"))
    ray_tpu_torch.kill(replicas[0])
    # reconcile loop restores the set within a few seconds
    deadline = time.time() + 30
    while time.time() < deadline:
        st = serve.status()
        try:
            if st["rec"]["live_replicas"] == 2 and len(set(
                    ray_tpu_torch.get([handle.method("whoami")
                                       for _ in range(8)]))) == 2:
                break
        except BaseException:
            pass
        time.sleep(0.5)
    else:
        raise AssertionError("replica never restored")


def test_serve_scale_and_function_deployment(serve_shutdown):
    @serve.deployment(num_replicas=1)
    def double(x):
        return x * 2

    handle = serve.run(double.bind(), name="fn")
    assert ray_tpu_torch.get(handle.remote(21)) == 42
    # scale up via redeploy
    serve.run(double.options(num_replicas=3).bind(), name="fn")
    deadline = time.time() + 30
    while time.time() < deadline:
        if serve.status()["fn"]["live_replicas"] == 3:
            break
        time.sleep(0.5)
    assert serve.status()["fn"]["live_replicas"] == 3
    serve.delete("fn")
    assert "fn" not in serve.status()


def test_serve_http_ingress(serve_shutdown):
    @serve.deployment(num_replicas=1)
    def classify(body):
        return {"label": "ok", "echo": body}

    serve.run(classify.bind(), name="clf")
    port = serve.start_http(port=0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/clf",
            data=json.dumps({"x": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        assert out["result"]["label"] == "ok"
        assert out["result"]["echo"] == {"x": 1}
    finally:
        serve.stop_http()


# ----------------------------------------------------- autoscaling
@pytest.mark.slow    # ~7s (r18 tier-1 budget): serve replica scaling
                     # keeps tier-1 cover via
                     # test_serve_scale_and_function_deployment
                     # (manual scale) and the autoscaler-signal units
                     # in test_metrics_plane/test_autoscaler
def test_serve_autoscales_up_and_down(serve_shutdown):
    """VERDICT r3 item 4 gate: load scales 1 -> N; drain scales back to
    min (reference _private/autoscaling_state.py decision loop)."""
    @serve.deployment(
        num_replicas=1, max_ongoing_requests=4,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1.0,
                            "upscale_delay_s": 0.5,
                            "downscale_delay_s": 1.0})
    class Slow:
        def __call__(self, x):
            time.sleep(2.0)
            return x

    h = serve.run(Slow.bind(), name="slow")
    # saturate: 8 concurrent 2s requests against target=1/replica
    refs = [h.remote(i) for i in range(8)]
    deadline = time.time() + 30
    peak = 1
    while time.time() < deadline:
        st = serve.status()["slow"]
        peak = max(peak, st["live_replicas"])
        if peak >= 2:
            break
        # keep pressure on
        done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
        if len(done) == len(refs):
            refs = [h.remote(i) for i in range(8)]
        time.sleep(0.3)
    assert peak >= 2, serve.status()
    ray_tpu_torch.get(refs, timeout=60)

    # drain: no load -> back down to min_replicas
    deadline = time.time() + 30
    while time.time() < deadline:
        if serve.status()["slow"]["live_replicas"] == 1:
            break
        time.sleep(0.3)
    assert serve.status()["slow"]["live_replicas"] == 1, serve.status()


# ------------------------------------------------------- streaming
def test_serve_streaming_handle(serve_shutdown):
    @serve.deployment(num_replicas=1)
    class Tokens:
        def __call__(self, prompt):
            for i, tok in enumerate(prompt.split()):
                yield f"{i}:{tok}"

    h = serve.run(Tokens.bind(), name="tok")
    out = list(h.stream("a b c d e"))
    assert out == ["0:a", "1:b", "2:c", "3:d", "4:e"]
    # non-generator methods stream as a single chunk
    @serve.deployment(num_replicas=1)
    def plain(x):
        return x * 2
    h2 = serve.run(plain.bind(), name="plain")
    assert list(h2.stream(21)) == [42]


def test_serve_streaming_http(serve_shutdown):
    @serve.deployment(num_replicas=1)
    class Gen:
        def __call__(self, body):
            for i in range(int(body["n"])):
                yield {"i": i}

    serve.run(Gen.bind(), name="gen")
    port = serve.start_http(port=0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/gen/stream",
            data=json.dumps({"n": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers.get("Transfer-Encoding") == "chunked"
            lines = [json.loads(l) for l in resp.read().splitlines() if l]
        assert [c["chunk"]["i"] for c in lines] == [0, 1, 2, 3]
    finally:
        serve.stop_http()


def test_serve_grpc_ingress(serve_shutdown):
    """gRPC ingress: unary call + server-streaming over the generic
    JSON-over-bytes methods (reference gRPC proxy mode)."""
    grpc = pytest.importorskip("grpc")

    @serve.deployment(num_replicas=1)
    class Summer:
        def __call__(self, a, b):
            return a + b

        def toks(self, text):
            for w in str(text).split():
                yield w.upper()

    serve.run(Summer.bind(), name="summer")
    port = serve.start_grpc(port=0)
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = ch.unary_unary(
            "/ray_tpu_torch.serve/Call",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: json.loads(b))
        out = call(json.dumps({"deployment": "summer",
                               "args": [19, 23]}).encode(), timeout=60)
        assert out["result"] == 42
        stream = ch.unary_stream(
            "/ray_tpu_torch.serve/Stream",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: json.loads(b))
        chunks = [c["chunk"] for c in stream(
            json.dumps({"deployment": "summer", "method": "toks",
                        "args": ["one two three"]}).encode(),
            timeout=60)]
        assert chunks == ["ONE", "TWO", "THREE"]
        # errors surface as gRPC status
        with pytest.raises(grpc.RpcError):
            call(json.dumps({"deployment": "nope"}).encode(), timeout=30)
        ch.close()
    finally:
        serve.stop_grpc()


def test_serve_composition_fanout(serve_shutdown):
    """Deployment-graph composition: an ingress deployment whose init
    args contain two bound sub-deployments receives live handles at
    replica init and fans requests out through them (reference
    deployment graphs: deployment_state.py:1245 + handle.py)."""

    @serve.deployment(num_replicas=1)
    class Doubler:
        def __call__(self, x):
            return x * 2

    @serve.deployment(num_replicas=1)
    class Adder:
        def __init__(self, inc):
            self.inc = inc

        def __call__(self, x):
            return x + self.inc

    @serve.deployment(num_replicas=1)
    class Ingress:
        def __init__(self, doubler, adders):
            self.doubler = doubler           # injected handle
            self.adders = adders             # list of injected handles

        def __call__(self, x):
            import ray_tpu_torch as rt
            d = rt.get(self.doubler.remote(x), timeout=60)
            return [rt.get(a.remote(d), timeout=60)
                    for a in self.adders]

    app = Ingress.bind(Doubler.bind(),
                       [Adder.bind(10), Adder.options(
                           name="Adder2").bind(100)])
    h = serve.run(app)
    assert ray_tpu_torch.get(h.remote(3), timeout=120) == [16, 106]
    # all three sub-deployments are live, independently addressable
    st = serve.status()
    assert {"Ingress", "Doubler", "Adder", "Adder2"} <= set(st)
    assert ray_tpu_torch.get(
        serve.get_handle("Doubler").remote(5), timeout=60) == 10


def test_serve_longpoll_membership_push(serve_shutdown):
    """Handles learn replica-set changes via the pubsub long-poll push
    (reference long_poll.py), not the slow TTL poll: after a scale-up
    the handle routes to the new replica well before the 30s TTL."""

    @serve.deployment(num_replicas=1)
    class W:
        def pid(self):
            import os
            return os.getpid()

    h = serve.run(W.bind())
    first = ray_tpu_torch.get(h.method("pid"), timeout=60)
    assert first > 0
    # watch thread is now parked on serve:W; scale to 3
    serve.run(W.options(num_replicas=3).bind())
    deadline = time.monotonic() + 25       # << the 30s TTL fallback
    pids = set()
    while time.monotonic() < deadline and len(pids) < 3:
        try:
            pids.add(ray_tpu_torch.get(h.method("pid"), timeout=30))
        except BaseException:
            pass
        time.sleep(0.3)
    assert len(pids) >= 2, (
        "handle never discovered scaled-up replicas via push")


# ----------------------------------------------------- multi-app
def test_serve_multi_app_routing_and_lifecycle(serve_shutdown):
    """Two applications under one controller: independent graphs, HTTP
    routing by route_prefix, per-app delete (reference multi-app
    serve.run(name=..., route_prefix=...))."""
    @serve.deployment(num_replicas=1)
    class Upper:
        def __call__(self, x):
            return str(x).upper()

    @serve.deployment(num_replicas=1)
    class Greeter:
        def __init__(self, style, shouter):
            self.style = style
            self.shouter = shouter

        def __call__(self, x):
            loud = ray_tpu_torch.get(self.shouter.remote(x), timeout=30)
            return f"{self.style} {loud}"

    h1 = serve.run(Greeter.bind("hello", Upper.bind()), name="greet",
                   route_prefix="/api/greet")
    h2 = serve.run(Upper.bind(), name="shout")

    assert ray_tpu_torch.get(h1.remote("bob"), timeout=60) == "hello BOB"
    assert ray_tpu_torch.get(h2.remote("hi"), timeout=60) == "HI"

    apps = serve.status_applications()
    assert apps["greet"]["route_prefix"] == "/api/greet"
    assert apps["greet"]["ingress"] == "greet"
    assert set(apps["greet"]["deployments"]) == {"greet", "Upper"}
    assert apps["shout"]["route_prefix"] == "/shout"

    # app handle resolves to the ingress deployment
    assert ray_tpu_torch.get(serve.get_app_handle("greet").remote("x"),
                             timeout=30) == "hello X"

    # HTTP ingress routes by prefix (nested path -> longest match)
    port = serve.start_http(port=0)
    try:
        for path, want in [("/api/greet", "hello Y"), ("/shout", "Y")]:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps("y").encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert json.loads(resp.read())["result"] == want
    finally:
        serve.stop_http()

    # deleting one app removes its whole graph, leaves the other
    serve.delete("greet")
    st = serve.status()
    assert "greet" not in st and "Upper" not in st
    assert "shout" in st
    assert ray_tpu_torch.get(h2.remote("ok"), timeout=30) == "OK"
    assert "greet" not in serve.status_applications()


def test_serve_multi_app_collisions_and_redeploy(serve_shutdown):
    @serve.deployment(num_replicas=1)
    def f(x):
        return x

    @serve.deployment(num_replicas=1)
    def g(x):
        return -x

    @serve.deployment(num_replicas=1)
    class P:
        def __init__(self, child=None):
            self.child = child

        def __call__(self, x):
            return x

    serve.run(f.bind(), name="a1", route_prefix="/one")
    # prefix collision with another app is refused
    with pytest.raises(Exception, match="route_prefix"):
        serve.run(g.bind(), name="a2", route_prefix="/one")
    # deployment-name collision across apps is refused (a CHILD named
    # like app a1's deployment; run(name=...) renames only the top)
    with pytest.raises(Exception, match="belong to application"):
        serve.run(P.bind(g.options(name="a1").bind()), name="a3",
                  route_prefix="/three")
    # ...and the refused app deployed NOTHING (validate-before-deploy)
    assert "a3" not in serve.status()
    # redeploying an app prunes deployments dropped from its graph
    serve.run(P.bind(g.bind()), name="a1", route_prefix="/one")
    assert "g" in serve.status()
    serve.run(P.bind(), name="a1", route_prefix="/one")
    deadline = time.time() + 30
    while time.time() < deadline and "g" in serve.status():
        time.sleep(0.2)
    st = serve.status()
    assert "g" not in st and "a1" in st
    assert set(serve.status_applications()["a1"]["deployments"]) == {"a1"}


def test_serve_route_push_reaches_ingress(serve_shutdown):
    """Deploying an app AFTER the HTTP ingress started must become
    routable via the controller's `serve:routes` pubsub push — well
    inside the 30s fallback poll window (reference long_poll.py
    route-table push)."""
    port = serve.start_http(port=0)
    try:
        # PRIME the route cache first (a 404-ish request triggers the
        # initial fallback load, stamping it fresh): after this, only
        # the pubsub push — not the 30s fallback — can make the new
        # app routable inside the assertion window below
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/nothing-here",
            data=b"null", headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=30)
        except Exception:
            pass

        @serve.deployment(num_replicas=1)
        def dbl(x):
            return x * 2

        serve.run(dbl.bind(), name="pushed", route_prefix="/pushed")
        deadline = time.time() + 15
        result = None
        while time.time() < deadline:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/pushed",
                    data=json.dumps(21).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as resp:
                    out = json.loads(resp.read())
                    if out.get("result") == 42:
                        result = out["result"]
                        break
            except Exception:
                pass
            time.sleep(0.25)
        assert result == 42, "route push never reached the ingress"
    finally:
        serve.stop_http()


def test_a_replica_dead_before_its_first_report_is_replaced_at_once(
        serve_shutdown):
    """A replica killed while its constructor runs (before it can
    report) leaves the set as soon as the runtime reports its actor DEAD,
    not after the 30 s startup grace (the JAX controller waits out the
    grace: ROADMAP queue 3, item 7)."""
    from ray_tpu_torch._private import context

    @serve.deployment(num_replicas=1)
    class Slow:
        def __init__(self):
            time.sleep(2.0)

        def pid(self):
            import os
            return os.getpid()

    h = serve.run(Slow.bind(), name="early")
    (first,) = ray_tpu_torch.get(h._controller.get_replicas.remote("early"))
    actors = context.get_ctx().controller
    deadline = time.monotonic() + 10
    while actors.get_actor(first._actor_id).worker_id is None:
        assert time.monotonic() < deadline, "replica never placed"
        time.sleep(0.05)
    ray_tpu_torch.kill(first)                 # mid-constructor
    deadline = time.monotonic() + 12          # < the 30 s grace
    pid = None
    while time.monotonic() < deadline and pid is None:
        try:
            pid = ray_tpu_torch.get(h.method("pid"), timeout=5)
        except Exception:
            time.sleep(0.2)
    assert pid is not None, serve.status()
    (now,) = ray_tpu_torch.get(h._controller.get_replicas.remote("early"))
    assert now._actor_id != first._actor_id
