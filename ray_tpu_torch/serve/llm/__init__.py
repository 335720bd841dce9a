"""Continuous-batching LLM engine core and its KV page bookkeeping.

The Serve deployment wrapper, the router and the token stream of
`ray_tpu.serve.llm` sit on the distributed substrate and come with the
slice that ports it.
"""
