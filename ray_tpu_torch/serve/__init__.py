"""Serving on the port: so far the LLM engine and its token stream
(`serve.llm`)."""
