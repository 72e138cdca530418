"""Grouped-query attention: full / sliding-window, prefill + decode — the
port of ``repro.nn.attention``.

All softmax math in fp32; einsum operands in the compute dtype.

Layout conventions (the reference's):
  hidden x:      (B, T, D)
  q:             (B, T, n_heads, head_dim)
  k, v (cache):  (B, S, n_kv, head_dim)
GQA is computed by reshaping q heads into (n_kv, group).

The KV cache is written in place (`cache_update`): a decode step reuses
the cache tensors it was given instead of copying a whole layer's cache
for every token, as JAX's immutable arrays would.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.nn.init import dense_init, split_keys
from repro_torch.nn.layers import rmsnorm, rmsnorm_params

NEG_INF = -2.3819763e38  # large negative for masked logits (bf16-safe)


def _inv_sqrt(hd: int) -> float:
    # 1/sqrt(hd) rounded as the reference computes it, in f32
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def attention_params(generator, d_model, n_heads, n_kv, head_dim, *, qk_norm=False):
    kq, kk, kv, ko = split_keys(generator, 4)
    p = {
        "wq": dense_init(kq, d_model, n_heads * head_dim),
        "wk": dense_init(kk, d_model, n_kv * head_dim),
        "wv": dense_init(kv, d_model, n_kv * head_dim),
        "wo": dense_init(ko, n_heads * head_dim, d_model),
    }
    if qk_norm:
        p["q_norm"] = rmsnorm_params(head_dim, device=generator.device)
        p["k_norm"] = rmsnorm_params(head_dim, device=generator.device)
    return p


def project_qkv(params, x, *, n_heads, n_kv, head_dim, dtype=torch.bfloat16, qk_norm=False):
    B, T, _ = x.shape
    x = x.to(dtype)
    q = (x @ params["wq"].to(dtype)).reshape(B, T, n_heads, head_dim)
    k = (x @ params["wk"].to(dtype)).reshape(B, T, n_kv, head_dim)
    v = (x @ params["wv"].to(dtype)).reshape(B, T, n_kv, head_dim)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, dtype=dtype)
        k = rmsnorm(params["k_norm"], k, dtype=dtype)
    return q, k, v


def make_mask(q_pos, k_pos, window: Optional[int] = None):
    """Boolean (Tq, Tk) mask. window: int; <=0 (or None) means full causal."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window is None or window <= 0:
        return causal
    near = k_pos[None, :] > q_pos[:, None] - window
    return causal & near


def mha(q, k, v, mask=None, *, dtype=torch.bfloat16, logit_cap: float = 0.0):
    """Batched GQA attention over full sequences.

    q: (B, Tq, H, hd); k,v: (B, Tk, KV, hd); mask: broadcastable (Tq, Tk) bool.
    """
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(dtype), k.to(dtype))
    logits = logits.to(torch.float32) * _inv_sqrt(hd)
    if logit_cap > 0.0:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    if mask is not None:
        logits = torch.where(mask[None, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(dtype))
    return out.reshape(B, Tq, H, hd)


def attn_out(params, ctx, *, dtype=torch.bfloat16):
    B, T, H, hd = ctx.shape
    return ctx.reshape(B, T, H * hd).to(dtype) @ params["wo"].to(dtype)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, KV, hd)
    v: torch.Tensor  # (B, S, KV, hd)

    @staticmethod
    def zeros(batch, seq, n_kv, head_dim, dtype=torch.bfloat16, device=None):
        shape = (batch, seq, n_kv, head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(q1, cache: KVCache, cache_len, *, dtype=torch.bfloat16, window: int = 0,
                     use_kernel: bool = False):
    """One-token decode attention against a KV cache.

    q1: (B, H, hd) query for the new token at position ``cache_len``.
    cache_len: scalar int32 tensor on the cache's device — number of valid
    entries in the cache (never read on the host).
    window: int; >0 restricts attention to the trailing window. In the
    port it is always a Python int, so the kernel path runs under every
    layer pattern.
    Returns (B, H, hd).
    """
    B, H, hd = q1.shape
    KV = cache.k.shape[2]
    S = cache.k.shape[1]
    G = H // KV
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops

        return kernel_ops.decode_attn(q1, cache.k, cache.v, cache_len, window=int(window))
    qg = q1.reshape(B, KV, G, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg.to(dtype), cache.k.to(dtype))
    logits = logits.to(torch.float32) * _inv_sqrt(hd)
    pos = torch.arange(S, dtype=torch.int32, device=q1.device)
    valid = pos < cache_len
    if window > 0:
        valid = valid & (pos >= cache_len - window)
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    ctx = torch.einsum("bkgs,bskh->bkgh", probs, cache.v.to(dtype))
    return ctx.reshape(B, H, hd)


def cache_update(cache: KVCache, k1, v1, index):
    """Insert one token's k/v at ``index``, in place. Returns the same cache.

    k1, v1: (B, KV, hd). index: scalar int32 tensor. As
    ``dynamic_update_slice`` in the reference, an index past the end is
    clamped to the last slot.
    """
    S = cache.k.shape[1]
    idx = torch.as_tensor(index, device=cache.k.device).clamp(0, S - 1).reshape(1).long()
    cache.k.index_copy_(1, idx, k1[:, None].to(cache.k.dtype))
    cache.v.index_copy_(1, idx, v1[:, None].to(cache.v.dtype))
    return cache
