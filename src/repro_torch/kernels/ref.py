"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in ordinary tensor
ops: the ``kernels.ops`` wrappers call these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.simulator import build_model_input, recency_view


def conv2s_ref(x, w, b):
    """Non-overlapping conv1d kernel=2 stride=2 + bias + ReLU.

    x: (B, N, C); w: (2C, Co); b: (Co,). -> (B, N//2, Co)
    """
    B, N, C = x.shape
    xr = x.reshape(B, N // 2, 2 * C)
    return torch.relu(torch.einsum("bnc,co->bno", xr, w) + b)


def cnn_trunk_ref(layers, x):
    """Chain of conv2s layers. layers: [(w, b), ...]."""
    h = x
    for w, b in layers:
        h = conv2s_ref(h, w, b)
    return h


def fused_step_ref(layers, state, cur_feat, cur_addr, *, seq_padded: int):
    """Ring-state assembly + trunk: `recency_view` → `build_model_input`
    with the planes in f32 → sequence pad to ``seq_padded`` →
    `cnn_trunk_ref`. layers: [(w, b), ...] in f32. -> (L, seq_padded//8, C3)."""
    f32 = state._replace(
        feat=state.feat.to(torch.float32),
        resid=state.resid.to(torch.float32),
        exec_lat=state.exec_lat.to(torch.float32),
        store_lat=state.store_lat.to(torch.float32),
    )
    x = build_model_input(recency_view(f32), cur_feat.to(torch.float32), cur_addr)
    x = torch.nn.functional.pad(x, (0, 0, 0, seq_padded - x.shape[1]))
    return cnn_trunk_ref(layers, x)


def decode_attn_ref(q, k, v, cache_len, *, window: int = 0, offset=None, return_lse=False):
    """Single-token GQA decode attention (fp32 softmax).

    q: (B, H, hd); k, v: (B, S, KV, hd); cache_len: scalar int32 (tensor or
    int). window > 0 masks to the trailing window (linear cache layout).
    Returns (B, H, hd) in f32.

    ``offset`` (an int) makes k, v the shard of a longer cache whose
    position 0 is the cache's position ``offset``: a position p is live
    where ``cache_len - window <= offset + p < cache_len``, with the global
    ``cache_len`` (not clamped to S). A row with no live position is 0
    (with ``return_lse``, its log-sum-exp -inf). ``return_lse`` also
    returns each row's log-sum-exp of the live logits, (B, H) f32.
    """
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).to(torch.float32)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.to(torch.float32))
    logits = logits / float(np.sqrt(np.float32(hd)))
    pos = torch.arange(S, dtype=torch.int32, device=q.device) + (offset or 0)
    valid = pos < cache_len
    if window > 0:
        valid = valid & (pos >= cache_len - window)
    probs = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
    ctx = torch.einsum("bkgs,bskh->bkgh", probs, v.to(torch.float32))
    ctx = torch.where(valid.any(), ctx, 0.0).reshape(B, H, hd)
    if not return_lse:
        return ctx
    lse = torch.logsumexp(torch.where(valid, logits, -torch.inf), dim=-1)
    return ctx, lse.reshape(B, H)


def wkv_step_ref(S, r_t, k_t, v_t, w_t, uh):
    """One step of rwkv6's wkv recurrence, f32. S: (B, H, hd, hd); r/k/v/w_t:
    (B, H, hd); uh: (H, hd). Returns (y_t (B, H, hd), new S)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    y_t = torch.einsum("bhi,bhij->bhj", r_t, S + uh[None, :, :, None] * kv)
    return y_t, w_t[..., None] * S + kv


def wkv_ref(rh, kh, vh, wh, uh, S):
    """The wkv recurrence along T of (B, T, H, hd) f32 r, k, v and w from
    state S (B, H, hd, hd): (y (B, T, H, hd), the last S), a loop of
    `wkv_step_ref` as the reference's ``lax.scan`` over its step. Each
    input is split along T once (the reference's ``moveaxis`` into the
    scan), so the backward stacks each input's gradient once: O(T) bytes,
    where a select a step would scatter a full (B, T, H, hd) gradient a
    step."""
    ys = []
    for r_t, k_t, v_t, w_t in zip(*(t.unbind(1) for t in (rh, kh, vh, wh))):
        y_t, S = wkv_step_ref(S, r_t, k_t, v_t, w_t, uh)
        ys.append(y_t)
    return torch.stack(ys, dim=1), S
