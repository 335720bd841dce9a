"""The port's own copies of the runtime pieces its serving path needs:
config, metrics plane, the framed wire, the dial cache and the context
stub. Each keeps the JAX module's names and holds only what the port
uses so far."""
