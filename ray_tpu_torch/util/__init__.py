"""Utilities of the port: so far the metrics registry and the
scheduling strategies."""
