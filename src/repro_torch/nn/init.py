"""Parameter initialisation helpers — the port of ``repro.nn.init``.

Every initialiser draws from an explicit ``torch.Generator`` and returns
the tensor alone, where the reference's returns ``(array, ShardSpec)``.
The ``ShardSpec`` half (the logical sharding axes, which
``repro_torch.runtime.sharding`` maps onto a mesh) comes from a function
beside each ``*_params`` initialiser (``*_specs``, with the reference's
axes), and every family's ``param_specs(cfg)`` assembles the
tree of a whole model. Tensors are made on the generator's device, so a
CUDA generator initialises a full-width model on the card without a trip
through host memory. Under `shapes_only` the random draws give tensors on
the ``meta`` device instead (shapes and dtypes, no storage: the
counterpart of tracing an init under ``jax.eval_shape``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Logical sharding annotation for one parameter.

    ``axes`` has one entry per array dim: a logical-axis name (str) or None.
    Common logical names: "embed" (d_model-like), "mlp" (ffn hidden),
    "heads" (attn head dim product), "vocab", "expert", "layers" (scan dim),
    "kv" (kv-head product), None (replicated).
    """

    axes: Tuple[Optional[str], ...]

    def __iter__(self):
        return iter(self.axes)


_draws = threading.local()


@contextlib.contextmanager
def shapes_only():
    """Within it, this thread's initialisers draw nothing: each random
    tensor is a ``meta`` tensor of its shape and dtype, and `split_keys`
    hands the generator on as it is."""
    before = getattr(_draws, "meta", False)
    _draws.meta = True
    try:
        yield
    finally:
        _draws.meta = before


def _truncated_normal(generator: torch.Generator, shape, stddev: float, dtype) -> torch.Tensor:
    # 2-sigma truncation like flax's default initializers, drawn in f32
    # and then scaled, as the reference does
    if getattr(_draws, "meta", False):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    unscaled = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(unscaled, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (unscaled * stddev).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """Fan-in scaled truncated-normal kernel of shape (in_dim, out_dim),
    used as ``x @ w``."""
    stddev = scale / math.sqrt(in_dim)
    return _truncated_normal(generator, (in_dim, out_dim), stddev, dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int, *,
               dtype=torch.float32) -> torch.Tensor:
    # 1/sqrt(dim) keeps tied-unembed logits O(1) at init (CE starts ≈ ln V);
    # gemma-style sqrt(d_model) embedding scaling restores O(1) activations.
    return _truncated_normal(generator, (vocab, dim), 1.0 / math.sqrt(dim), dtype)


def scalar_init(value: float, shape: Sequence[int], *, dtype=torch.float32,
                device=None) -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


def split_keys(generator: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` independent generators on ``generator``'s device, seeded from
    it (the counterpart of ``jax.random.split``)."""
    if getattr(_draws, "meta", False):
        return [generator] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s) for s in seeds]
