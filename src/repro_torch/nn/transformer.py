"""Decoder blocks (dense family) in sequence mode and single-token decode
mode — the port of ``repro.nn.transformer``.

The reference feeds each layer's window and rope theta to one scanned
body as traced scalars; the port loops over layers in Python, so both are
plain Python numbers (`layer_windows`, `layer_thetas`) and the decode
kernel sees each layer's window as the static int it is.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.nn import attention as attn_lib
from repro_torch.nn import rope as rope_lib
from repro_torch.nn.attention import KVCache
from repro_torch.nn.init import split_keys
from repro_torch.nn.layers import gated_mlp, gated_mlp_params, layernorm, layernorm_params, rmsnorm, rmsnorm_params


def _require_dense(cfg):
    if cfg.family == "moe":
        raise NotImplementedError("the MoE family is not ported to repro_torch yet "
                                  "(ROADMAP.md Queue 1 item 11, MoE: nn/moe.py)")


# ---------------------------------------------------------------------------
# norm dispatch
# ---------------------------------------------------------------------------

def norm_params(cfg, dim, device=None):
    if cfg.norm == "layernorm":
        return layernorm_params(dim, device=device)
    return rmsnorm_params(dim, device=device)


def norm_apply(cfg, params, x, dtype):
    if cfg.norm == "layernorm":
        return layernorm(params, x, eps=cfg.norm_eps, dtype=dtype)
    return rmsnorm(params, x, eps=cfg.norm_eps, dtype=dtype, zero_centered=cfg.zero_centered_norm)


# ---------------------------------------------------------------------------
# block params
# ---------------------------------------------------------------------------

def block_params(generator, cfg):
    """One dense decoder block, on ``generator``'s device."""
    _require_dense(cfg)
    k_attn, k_mlp = split_keys(generator, 2)
    dev = generator.device
    p = {"ln1": norm_params(cfg, cfg.d_model, dev)}
    p["attn"] = attn_lib.attention_params(
        k_attn, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, qk_norm=cfg.qk_norm
    )
    if cfg.post_attn_norm:
        p["ln1_post"] = norm_params(cfg, cfg.d_model, dev)
    p["ln2"] = norm_params(cfg, cfg.d_model, dev)
    p["mlp"] = gated_mlp_params(k_mlp, cfg.d_model, cfg.d_ff)
    return p


# ---------------------------------------------------------------------------
# sequence mode (prefill)
# ---------------------------------------------------------------------------

def _apply_rope_qk(cfg, q, k, positions, theta):
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported to repro_torch yet "
                                  "(ROADMAP.md Queue 1 item 11, VLM)")
    q = rope_lib.apply_rope(q, positions, theta)
    k = rope_lib.apply_rope(k, positions, theta)
    return q, k


def block_seq(params, x, positions, *, cfg, window: int, theta: float, dtype,
              return_kv: bool = False):
    """Full-sequence block. x: (B, T, D); positions: (B, T).

    Returns (x_out, aux) where aux optionally holds (k, v).
    """
    _require_dense(cfg)
    aux = {}
    T = x.shape[1]
    h = norm_apply(cfg, params["ln1"], x, dtype)
    q, k, v = attn_lib.project_qkv(
        params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, dtype=dtype, qk_norm=cfg.qk_norm,
    )
    q, k = _apply_rope_qk(cfg, q, k, positions, theta)
    if return_kv:
        aux["kv"] = (k, v)
    t_ar = torch.arange(T, dtype=torch.int32, device=x.device)
    mask = attn_lib.make_mask(t_ar, t_ar, window)
    ctx = attn_lib.mha(q, k, v, mask, dtype=dtype, logit_cap=cfg.logit_cap)
    a = attn_lib.attn_out(params["attn"], ctx, dtype=dtype)
    if cfg.post_attn_norm:
        a = norm_apply(cfg, params["ln1_post"], a, dtype)
    x = x + a

    h = norm_apply(cfg, params["ln2"], x, dtype)
    x = x + gated_mlp(params["mlp"], h, act=cfg.act, dtype=dtype)
    return x, aux


# ---------------------------------------------------------------------------
# decode mode (single token)
# ---------------------------------------------------------------------------

def block_step(params, x_t, cache: KVCache, pos, *, cfg, window: int, theta: float, dtype,
               use_kernel: bool = False):
    """Single-token decode. x_t: (B, D); pos: scalar int32 tensor, the
    absolute position (stays on the device: the step reads nothing back).

    The cache is updated in place. Returns (x_out, cache).
    """
    _require_dense(cfg)
    B = x_t.shape[0]
    S_cache = cache.k.shape[1]
    h = norm_apply(cfg, params["ln1"], x_t[:, None, :], dtype)
    q, k, v = attn_lib.project_qkv(
        params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, dtype=dtype, qk_norm=cfg.qk_norm,
    )
    q, k = _apply_rope_qk(cfg, q, k, pos.to(torch.int32).expand(B, 1), theta)
    cache = attn_lib.cache_update(cache, k[:, 0], v[:, 0], pos)
    cache_len = torch.clamp(pos + 1, max=S_cache).to(torch.int32)
    ctx = attn_lib.decode_attention(
        q[:, 0], cache, cache_len, dtype=dtype, window=window, use_kernel=use_kernel,
    )
    a = attn_lib.attn_out(params["attn"], ctx[:, None], dtype=dtype)[:, 0]
    if cfg.post_attn_norm:
        a = norm_apply(cfg, params["ln1_post"], a, dtype)
    x_t = x_t + a

    h = norm_apply(cfg, params["ln2"], x_t[:, None, :], dtype)
    m = gated_mlp(params["mlp"], h, act=cfg.act, dtype=dtype)
    x_t = x_t + m[:, 0]
    return x_t, cache


# ---------------------------------------------------------------------------
# per-layer static schedules
# ---------------------------------------------------------------------------

def layer_windows(cfg) -> List[int]:
    return [cfg.layer_window(i) for i in range(cfg.n_layers)]


def layer_thetas(cfg) -> List[float]:
    ths = []
    for i in range(cfg.n_layers):
        if cfg.attn_pattern == "local_global" and cfg.layer_window(i) == 0 and cfg.rope_theta_global:
            ths.append(cfg.rope_theta_global)
        else:
            ths.append(cfg.rope_theta)
    return ths
