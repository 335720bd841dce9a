"""Model serving: deployments + handle + HTTP ingress.

Run: python -m ray_tpu_torch.examples.serve_inference
"""
import json
import urllib.request

import ray_tpu_torch
from ray_tpu_torch import serve


@serve.deployment(num_replicas=2)
class Classifier:
    def __call__(self, body):
        text = str(body.get("text", ""))
        return {"label": "long" if len(text) > 10 else "short",
                "length": len(text)}


def main():
    ray_tpu_torch.init(num_cpus=4)
    handle = serve.run(Classifier.bind(), name="clf")
    print("handle:", ray_tpu_torch.get(handle.remote({"text": "hello world!"})))

    port = serve.start_http(port=0)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/clf",
        data=json.dumps({"text": "hi"}).encode())
    print("http:", json.loads(urllib.request.urlopen(req).read()))
    serve.stop_http()
    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
