"""Serve model composition: an ingress fanning out to sub-deployments.

A bound deployment graph — `Ingress.bind(Preprocessor.bind(),
ModelA.bind(), ModelB.bind())` — deploys every node and injects live
DeploymentHandles into the ingress replica at init (reference deployment
graphs: python/ray/serve/_private/deployment_state.py:1245 handle
injection + serve/handle.py handle-passing). Each sub-deployment scales
and recovers independently; handles learn membership changes via the
long-poll push channel (reference serve/_private/long_poll.py).

Run: python -m ray_tpu_torch.examples.serve_composition
"""
import ray_tpu_torch
from ray_tpu_torch import serve


@serve.deployment(num_replicas=1)
class Preprocessor:
    def __call__(self, text: str) -> list:
        return [t.lower() for t in text.split()]


@serve.deployment(num_replicas=2)
class SentimentModel:
    POSITIVE = {"good", "great", "love", "fast"}

    def __call__(self, tokens: list) -> float:
        if not tokens:
            return 0.0
        return sum(t in self.POSITIVE for t in tokens) / len(tokens)


@serve.deployment(num_replicas=2)
class LengthModel:
    def __call__(self, tokens: list) -> int:
        return len(tokens)


@serve.deployment(num_replicas=1)
class Ingress:
    """Receives handles to the three sub-deployments at init."""

    def __init__(self, pre, sentiment, length):
        self.pre = pre
        self.sentiment = sentiment
        self.length = length

    def __call__(self, text: str) -> dict:
        tokens = ray_tpu_torch.get(self.pre.remote(text), timeout=60)
        s_ref = self.sentiment.remote(tokens)    # fan out in parallel
        l_ref = self.length.remote(tokens)
        return {"sentiment": ray_tpu_torch.get(s_ref, timeout=60),
                "tokens": ray_tpu_torch.get(l_ref, timeout=60)}


def main():
    ray_tpu_torch.init(num_cpus=8)
    app = Ingress.bind(Preprocessor.bind(), SentimentModel.bind(),
                       LengthModel.bind())
    handle = serve.run(app)
    for text in ("GPUs are fast and I love them",
                 "this is terrible"):
        out = ray_tpu_torch.get(handle.remote(text), timeout=120)
        print(f"{text!r} -> {out}")
    print("deployments:", sorted(serve.status()))
    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
