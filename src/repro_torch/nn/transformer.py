"""Decoder blocks (dense / MoE) in sequence mode and single-token decode
mode — the port of ``repro.nn.transformer``.

The reference feeds each layer's window and rope theta to one scanned
body as traced scalars; the port loops over layers in Python, so both are
plain Python numbers (`layer_windows`, `layer_thetas`) and the decode
kernel sees each layer's window as the static int it is.

``constrain(x, logical_axes)`` is the reference's sharding hook: a no-op
by default, `repro_torch.runtime.sharding.make_constrain`'s redistribute
on a mesh. It is called where the reference calls it, and once more
where a mixer needs the whole sequence: the attention's input is
constrained to ``("batch", None, None)`` (``seq`` gathered), where GSPMD
inserts that all-gather by itself; so is the MLP's, whose matmuls would
otherwise flatten (batch, seq) with ``seq`` split, which DTensor refuses
(torch 2.11). A mixer's or MLP's output (partial sums over ``model``) is
constrained to ``("batch", "seq", None)`` before it joins the residual
(`residual`): a reduce-scatter forward, an all-gather of its gradient
backward, so no backward matmul meets a ``seq``-split gradient either.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.nn import attention as attn_lib
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import rope as rope_lib
from repro_torch.nn.attention import KVCache
from repro_torch.nn.init import split_keys
from repro_torch.nn.layers import (gated_mlp, gated_mlp_params, gated_mlp_specs, layernorm,
                                   layernorm_params, layernorm_specs, rmsnorm, rmsnorm_params,
                                   rmsnorm_specs)


def _noop_constrain(x, axes):
    return x


def residual(x, y, constrain):
    """``x + y`` with ``y`` first placed as the residual stream is."""
    return x + constrain(y, ("batch", "seq", None))



# ---------------------------------------------------------------------------
# norm dispatch
# ---------------------------------------------------------------------------

def norm_params(cfg, dim, device=None):
    if cfg.norm == "layernorm":
        return layernorm_params(dim, device=device)
    return rmsnorm_params(dim, device=device)


def norm_specs(cfg):
    return layernorm_specs() if cfg.norm == "layernorm" else rmsnorm_specs()


def norm_apply(cfg, params, x, dtype):
    if cfg.norm == "layernorm":
        return layernorm(params, x, eps=cfg.norm_eps, dtype=dtype)
    return rmsnorm(params, x, eps=cfg.norm_eps, dtype=dtype, zero_centered=cfg.zero_centered_norm)


# ---------------------------------------------------------------------------
# block params
# ---------------------------------------------------------------------------

def block_params(generator, cfg):
    """One decoder block (dense or MoE depending on cfg), on
    ``generator``'s device."""
    k_attn, k_mlp = split_keys(generator, 2)
    dev = generator.device
    p = {"ln1": norm_params(cfg, cfg.d_model, dev)}
    p["attn"] = attn_lib.attention_params(
        k_attn, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, qk_norm=cfg.qk_norm
    )
    if cfg.post_attn_norm:
        p["ln1_post"] = norm_params(cfg, cfg.d_model, dev)
    p["ln2"] = norm_params(cfg, cfg.d_model, dev)
    if cfg.family == "moe":
        p["moe"] = moe_lib.moe_params(k_mlp, cfg.d_model, cfg.d_ff, cfg.n_experts)
    else:
        p["mlp"] = gated_mlp_params(k_mlp, cfg.d_model, cfg.d_ff)
    return p


def block_specs(cfg):
    """The ShardSpec tree of one `block_params` layer."""
    s = {"ln1": norm_specs(cfg),
         "attn": attn_lib.attention_specs(qk_norm=cfg.qk_norm)}
    if cfg.post_attn_norm:
        s["ln1_post"] = norm_specs(cfg)
    s["ln2"] = norm_specs(cfg)
    if cfg.family == "moe":
        s["moe"] = moe_lib.moe_specs()
    else:
        s["mlp"] = gated_mlp_specs()
    return s


# ---------------------------------------------------------------------------
# sequence mode (prefill)
# ---------------------------------------------------------------------------

def _apply_rope_qk(cfg, q, k, positions, theta):
    if cfg.mrope:
        q = rope_lib.apply_mrope(q, positions, cfg.mrope_sections, theta)
        k = rope_lib.apply_mrope(k, positions, cfg.mrope_sections, theta)
    else:
        q = rope_lib.apply_rope(q, positions, theta)
        k = rope_lib.apply_rope(k, positions, theta)
    return q, k


def _ffn(cfg, params, h, dtype, group_size, constrain):
    """The MLP or MoE half of a block: (output, router logits or None)."""
    if cfg.family == "moe":
        return moe_lib.moe_apply(
            params["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, group_size=group_size, dtype=dtype,
            constrain=constrain,
        )
    return gated_mlp(params["mlp"], h, act=cfg.act, dtype=dtype), None


def block_seq(params, x, positions, *, cfg, window: int, theta: float, dtype,
              constrain=_noop_constrain, return_kv: bool = False):
    """Full-sequence block. x: (B, T, D); positions: (B, T) or (3, B, T)
    for M-RoPE.

    Returns (x_out, aux) where aux holds the router logits (MoE) and
    optionally (k, v).
    """
    aux = {}
    T = x.shape[1]
    h = constrain(norm_apply(cfg, params["ln1"], x, dtype), ("batch", None, None))
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
    a = constrain(attn_lib.attn_out(params["attn"], ctx, dtype=dtype), ("batch", "seq", None))
    if cfg.post_attn_norm:
        a = norm_apply(cfg, params["ln1_post"], a, dtype)
    x = x + a
    x = constrain(x, ("batch", "seq", None))

    h = constrain(norm_apply(cfg, params["ln2"], x, dtype), ("batch", None, None))
    m, router_logits = _ffn(cfg, params, h, dtype, cfg.moe_group_size, constrain)
    if router_logits is not None:
        aux["router_logits"] = router_logits
    return constrain(residual(x, m, constrain), ("batch", "seq", None)), aux


# ---------------------------------------------------------------------------
# decode mode (single token)
# ---------------------------------------------------------------------------

def block_step(params, x_t, cache: KVCache, pos, *, cfg, window: int, theta: float, dtype,
               constrain=_noop_constrain, ring: bool = False, use_kernel: bool = False):
    """Single-token decode. x_t: (B, D); pos: scalar int32 tensor, the
    absolute position (stays on the device: the step reads nothing back).

    ``ring``: the cache is a ring buffer sized to the window, written at
    ``pos % S`` (no extra masking needed — attention is permutation-
    invariant over KV entries). The cache is updated in place. Returns
    (x_out, cache).
    """
    B = x_t.shape[0]
    S_cache = cache.k.shape[1]
    h = norm_apply(cfg, params["ln1"], x_t[:, None, :], dtype)
    q, k, v = attn_lib.project_qkv(
        params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, dtype=dtype, qk_norm=cfg.qk_norm,
    )
    pos_b = pos.to(torch.int32).expand((3, B, 1) if cfg.mrope else (B, 1))
    q, k = _apply_rope_qk(cfg, q, k, pos_b, theta)
    idx = torch.remainder(pos, S_cache) if ring else pos
    cache = attn_lib.cache_update(cache, k[:, 0], v[:, 0], idx)
    cache_len = torch.clamp(pos + 1, max=S_cache).to(torch.int32)
    ctx = attn_lib.decode_attention(
        q[:, 0], cache, cache_len, dtype=dtype, window=0 if ring else window,
        use_kernel=use_kernel,
    )
    a = attn_lib.attn_out(params["attn"], ctx[:, None], dtype=dtype)[:, 0]
    if cfg.post_attn_norm:
        a = norm_apply(cfg, params["ln1_post"], a, dtype)
    x_t = x_t + a

    h = norm_apply(cfg, params["ln2"], x_t[:, None, :], dtype)
    m, _ = _ffn(cfg, params, h, dtype, min(cfg.moe_group_size, B), constrain)
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
