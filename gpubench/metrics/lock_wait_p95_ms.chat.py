"""lock_wait_p95_ms.chat: p95 of the waits for the engine's lock in
`generate` and in the stream's subscribe that start in the window, from
the program's `llm.lock_wait.*` spans in this process's flight recorder
(ms)."""
from gpubench.program_spans import lock_wait_p95_ms as read  # noqa: F401
