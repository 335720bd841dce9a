"""The plain references, one module an architecture (`arch/<name>.py`
names its own in `reference`), in float32 plain `torch` and importing
nothing of the program. Each gives what the judge and the controls call:
`sizes(config)`, `logits(params, tokens, sizes, quant=None, rows=...)`,
`loss(params, batch, sizes, quant=None)`, `no_tf32()`,
`mm(x, w, quant)` (`quant="fp8"`: the control's precision) and
`AdamW`."""
