"""Utilities of the port: so far the in-process metrics registry."""
