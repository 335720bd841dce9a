"""Streaming inference + autoscaling with ray_tpu_torch.serve.

A token-streaming deployment (generator __call__) consumed through the
handle and over chunked HTTP, with replica autoscaling under load.
Reference analogue: serve streaming responses (proxy ASGI streaming) +
serve/_private/autoscaling_state.py.

Run: python -m ray_tpu_torch.examples.serve_streaming
"""
import json
import time
import urllib.request

import ray_tpu_torch
from ray_tpu_torch import serve


@serve.deployment(
    num_replicas=1,
    autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                        "target_ongoing_requests": 2.0,
                        "upscale_delay_s": 1.0,
                        "downscale_delay_s": 5.0})
class TokenStreamer:
    """Stands in for an LLM decode loop: yields tokens as produced."""

    def __call__(self, prompt: str):
        for i, word in enumerate(str(prompt).split()):
            time.sleep(0.05)          # per-token decode latency
            yield f"[{i}]{word}"


def main():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    handle = serve.run(TokenStreamer.bind(), name="llm")

    print("streaming via handle:")
    for tok in handle.stream("the quick brown fox jumps"):
        print("  ", tok)

    port = serve.start_http(port=0)
    print(f"streaming via HTTP on :{port}:")
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm/stream",
        data=json.dumps("lazy dog time").encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        for line in resp.read().splitlines():
            if line:
                print("  ", json.loads(line)["chunk"])

    print("status:", serve.status())
    serve.stop_http()
    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
