"""Multi-application serving: independent apps under one controller.

Run:  python -m ray_tpu_torch.examples.serve_multi_app

Two applications — a composed greeting pipeline and a standalone
shouter — deploy with their own route prefixes; HTTP traffic routes by
longest prefix; deleting one app leaves the other serving.
"""
import json
import urllib.request

import ray_tpu_torch
from ray_tpu_torch import serve


@serve.deployment(num_replicas=1)
class Upper:
    def __call__(self, x):
        return str(x).upper()


@serve.deployment(num_replicas=2)
class Greeter:
    def __init__(self, style, shouter):
        self.style = style
        self.shouter = shouter          # live handle to Upper

    def __call__(self, name):
        loud = ray_tpu_torch.get(self.shouter.remote(name), timeout=30)
        return f"{self.style}, {loud}!"


def main():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)

    serve.run(Greeter.bind("Hello", Upper.bind()), name="greet",
              route_prefix="/api/greet")
    # run(name=...) names the app AND its ingress deployment
    serve.run(Upper.bind(), name="shout")

    print("applications:", json.dumps(serve.status_applications(),
                                      indent=1, default=str))

    port = serve.start_http(port=0)
    for path, body in [("/api/greet", "ada"), ("/shout", "quiet")]:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            print(path, "->", json.loads(resp.read())["result"])

    serve.delete("greet")               # whole app graph goes away
    print("after delete:", sorted(serve.status()))
    # the OTHER app keeps serving — the docstring's central claim
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/shout",
        data=json.dumps("still here").encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        survivor = json.loads(resp.read())["result"]
    print("/shout after delete ->", survivor)
    assert survivor == "STILL HERE"
    serve.stop_http()
    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
