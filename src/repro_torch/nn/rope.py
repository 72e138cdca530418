"""Rotary position embeddings — the port of ``repro.nn.rope`` (standard
RoPE; M-RoPE and the sinusoid table come with the VLM and Whisper
slices)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float = 10000.0):
    """Apply rotary embedding.

    x: (..., T, H, head_dim); positions: broadcastable to (..., T) int32.
    Rotation in fp32, returned in x.dtype.
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
