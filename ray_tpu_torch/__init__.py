"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package `ray_tpu` stays the reference; this package grows beside
it, one slice at a time, and imports nothing of it (nor JAX). The first
slice is the serving path: the Llama-family decoder, its paged
prefill/decode forwards and the continuous-batching `EngineCore`, with
the flash-attention forward and the RMSNorm forward as CUDA kernels
written for `sm_90a` (`ops/csrc/`).

Entry points run on the card unless the caller passes `device="cpu"`;
on the CPU every kernel wrapper runs its plain PyTorch version, which is
what the parity tests compare against the JAX package.
"""
__version__ = "0.1.0"
