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

On a mesh (DTensor q, k, v) `mha` is head-parallel by hand
(`_mha_on_mesh`): DTensor's einsum rule fails on the grouped heads with
their kv dim split (torch 2.11: "Attempted to flatten multiple
dimensions, with dimension 1 being sharded"), where GSPMD partitions the
same einsum.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.nn.init import ShardSpec, dense_init, split_keys
from repro_torch.nn.layers import rmsnorm, rmsnorm_params, rmsnorm_specs

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


def attention_specs(*, qk_norm=False):
    s = {"wq": ShardSpec(("embed", "heads")), "wk": ShardSpec(("embed", "heads")),
         "wv": ShardSpec(("embed", "heads")), "wo": ShardSpec(("heads", "embed"))}
    if qk_norm:
        s["q_norm"] = rmsnorm_specs(None)
        s["k_norm"] = rmsnorm_specs(None)
    return s


def _split_heads(t, n, head_dim):
    """(B, T, n * head_dim) -> (B, T, n, head_dim). A DTensor whose last
    dim is split over more ranks than ``n`` divides among them (GQA with
    fewer kv heads than ``model`` ranks: the split cuts a head) is first
    gathered on those mesh dims."""
    if isinstance(t, DTensor):
        cut = [m for m, p in enumerate(t.placements) if p.is_shard(2)]
        if n % math.prod(t.device_mesh.size(m) for m in cut):
            t = t.redistribute(t.device_mesh, [Replicate() if m in cut else p
                                               for m, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:2], n, head_dim)


def project_qkv(params, x, *, n_heads, n_kv, head_dim, dtype=torch.bfloat16, qk_norm=False):
    x = x.to(dtype)
    q = _split_heads(x @ params["wq"].to(dtype), n_heads, head_dim)
    k = _split_heads(x @ params["wk"].to(dtype), n_kv, head_dim)
    v = _split_heads(x @ params["wv"].to(dtype), n_kv, head_dim)
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
    if isinstance(q, DTensor):
        return _mha_on_mesh(q, k, v, mask, dtype=dtype, logit_cap=logit_cap)
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


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: a rank's local
    tensor hands its gradient back to a DTensor, whose later views
    (rope's, the head split's) need a contiguous local tensor."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _mha_on_mesh(q, k, v, mask, *, dtype, logit_cap):
    """`mha` of DTensors, each rank attending with its heads: q keeps the
    mesh dims that split its batch (dim 0) and its heads (dim 2), k and v
    the same batch dims and, where the kv heads divide among the ranks,
    the same head dims; otherwise k and v are whole on those dims and each
    rank takes the kv heads of its q heads (their gradient is then a
    partial sum, all-reduced by the backward). The plain `mha` runs on the
    local tensors; the result is q's placements. Sequence dims are
    gathered."""
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    pq = [p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in q.placements]
    heads = [m for m, p in enumerate(pq) if p.is_shard(2)]
    ways = math.prod(mesh.size(m) for m in heads)
    if H % ways:
        heads, ways = [], 1
        pq = [p if p.is_shard(0) else Replicate() for p in pq]
    q_l = q.redistribute(mesh, pq).to_local()
    if KV % ways == 0:
        pkv = pq
        k_l, v_l = (t.redistribute(mesh, pkv).to_local() for t in (k, v))
    else:  # whole kv heads on the head dims: take the ones this rank's q heads use
        pkv = [Replicate() if m in heads else p for m, p in enumerate(pq)]
        grad = [Partial() if m in heads else p for m, p in enumerate(pq)]
        from repro_torch.runtime.sharding import shard_offsets

        h0 = shard_offsets(q.redistribute(mesh, pq), 2)[0]
        G = H // KV
        lo, hi = h0 // G, (h0 + q_l.shape[2] - 1) // G + 1
        k_l, v_l = (t.redistribute(mesh, pkv).to_local(grad_placements=grad)[:, :, lo:hi]
                    for t in (k, v))
    q_l, k_l, v_l = (_ContiguousGrad.apply(t) for t in (q_l, k_l, v_l))
    ctx = mha(q_l, k_l, v_l, mask, dtype=dtype, logit_cap=logit_cap)
    return DTensor.from_local(ctx.contiguous(), mesh, pq, run_check=False)


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
