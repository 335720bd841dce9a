"""Serving on the port: so far the LLM engine core (`serve.llm`)."""
