"""Rotary position embeddings — the port of ``repro.nn.rope``: standard
RoPE, M-RoPE (Qwen2-VL) and Whisper's sinusoid table.

Nothing here copies host data to the device, so every function may run
inside a CUDA graph capture (the decode step's).
"""
from __future__ import annotations

import numpy as np
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


def apply_mrope(x, positions_thw, sections, theta: float = 10000.0):
    """Multimodal RoPE (Qwen2-VL §2.1): head_dim/2 freq slots are split into
    (temporal, height, width) sections, each rotated by its own position id.

    x: (B, T, H, head_dim); positions_thw: (3, B, T) int32;
    sections: 3-tuple summing to head_dim // 2, e.g. (16, 24, 24) for hd=128.
    """
    head_dim = x.shape[-1]
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to head_dim // 2 = {half}")
    freqs = rope_freqs(head_dim, theta, x.device)  # (half,)
    # per-slot positions (B, T, half): slot j takes the position of the
    # section it belongs to (the reference's take over a section id)
    pos = torch.cat([positions_thw[i, ..., None].expand(*positions_thw.shape[1:], s)
                     for i, s in enumerate(sections)], dim=-1).to(torch.float32)
    angles = pos * freqs  # (B, T, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def text_mrope_positions(positions):
    """For pure-text tokens, all three M-RoPE components share the index."""
    return positions[None].expand((3,) + tuple(positions.shape))


def sinusoid_rows(positions, dim: int):
    """Rows ``positions`` (an int tensor) of `sinusoid_table`, computed on
    the positions' device: (*positions.shape, dim) f32. Computed in f64 as
    the reference's numpy table and rounded once to f32."""
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2, dtype=torch.float64,
                                                  device=positions.device))
    scaled = positions.to(torch.float64)[..., None] * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1).to(torch.float32)


def sinusoid_table(length: int, dim: int, device=None):
    """Whisper-style fixed sinusoidal embeddings, shape (length, dim) f32."""
    return sinusoid_rows(torch.arange(length, device=device), dim)
