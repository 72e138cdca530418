"""Error-feedback gradient compression for cross-pod reduction — the port
of ``repro.training.compression``.

Each leaf of a gradient tree is quantized to int8 (or ``bits``) with one
f32 scale a leaf, and the quantization error is kept as an f32 residual
that is added back before the next compression, so the noise is
re-injected instead of lost:

    comp = ErrorFeedbackCompressor(bits=8)
    state = comp.init(grads)
    payload, state = comp.compress(grads, state)   # {...: (q int8, scale)}
    grads_hat = comp.decompress(payload)

The reference's ``cross_pod_mean`` reduces the payload over a mesh's pod
axis; it comes with the port's mesh (ROADMAP.md Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._tree import tree_map


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackCompressor:
    bits: int = 8

    def init(self, grads):
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def _levels(self):
        return float(2 ** (self.bits - 1) - 1)

    def compress(self, grads, residual):
        """Returns (payload {q: int8, scale}, new_residual)."""
        levels = self._levels()

        def comp(g, r):
            x = g.to(torch.float32) + r
            scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-12) / levels
            q = torch.clamp(torch.round(x / scale), -levels, levels).to(torch.int8)
            deq = q.to(torch.float32) * scale
            return (q, scale), x - deq

        out = tree_map(comp, grads, residual)
        payload = tree_map(lambda _, o: o[0], grads, out)
        new_resid = tree_map(lambda _, o: o[1], grads, out)
        return payload, new_resid

    def decompress(self, payload):
        """The f32 tree ``q * scale`` (a ``(q, scale)`` pair is a leaf)."""
        if isinstance(payload, dict):
            return {k: self.decompress(v) for k, v in payload.items()}
        if isinstance(payload, tuple) and isinstance(payload[0], torch.Tensor):
            q, scale = payload
            return q.to(torch.float32) * scale
        return type(payload)(self.decompress(v) for v in payload)
