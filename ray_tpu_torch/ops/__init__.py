"""Ops of the port: each kernel wrapper beside its plain PyTorch version."""
