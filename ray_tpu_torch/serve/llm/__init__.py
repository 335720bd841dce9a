"""LLM serving on the port: the continuous-batching `EngineCore`, its KV
page bookkeeping, and the `LLMEngine` deployment class with its push
token stream (`stream_client`, `STREAM_STATS`).

The router (`LLMHandle`, `TokenStream` failover) and `serve_llm` call
actors and the Serve controller, and come with the slice that ports the
actor runtime.
"""
from ray_tpu_torch.serve.llm.engine import (EngineCore,  # noqa: F401
                                            LLMEngine)
from ray_tpu_torch.serve.llm.kv_cache import (PageAllocator,  # noqa: F401
                                              pages_from_budget,
                                              pages_needed)
from ray_tpu_torch.serve.llm.stream import (STREAM_STATS,  # noqa: F401
                                            stream_client)
