"""Rotary position embeddings (RoPE), split-halves (llama) convention.

Port of `ray_tpu/ops/rope.py`: plain PyTorch, f32 math, the result cast
back to the input dtype. Elementwise work beside the QK projections; no
kernel of its own.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for each rotated pair, shape (head_dim//2,)."""
    if head_dim % 2:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (..., seq, 1, head_dim//2) f32; compute once per
    forward and reuse across layers."""
    inv_freq = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].to(torch.float32) * inv_freq
    angles = angles[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope_cached(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., seq, heads, head_dim) by precomputed cos/sin."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate x (..., seq, heads, head_dim) by per-token angles;
    positions broadcast to x.shape[:-2] (usually (batch, seq) or
    (seq,))."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    return apply_rope_cached(x, cos, sin)
