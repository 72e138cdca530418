"""RecurrentGemma (Griffin) hybrid: (R, R, A) pattern of RG-LRU recurrent
blocks and local sliding-window attention, unrolled layers — the port of
``repro.models.hybrid``.

``params["blocks"]`` is a list with one dict per layer ("attn" or "rec",
then the MLP). The decode state is the reference's: ``pos`` and one dict
a layer, ``{"k", "v"}`` (a ring of ``min(T, window)`` positions) for an
attention layer and ``{"h", "conv"}`` (f32) for a recurrent one. A decode
step writes every layer's state in place and returns a state that shares
the tensors. ``param_specs(cfg)`` and the ``constrain`` hook are
`repro_torch.models.lm`'s; a mixer's input is constrained to ``("batch",
None, None)`` (``seq`` gathered) since the RG-LRU scan, the causal conv
and the attention mask run over the whole sequence.
"""
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.specs import decode_state_axes
from repro_torch.models.lm import (embed_scale, layer_list, layer_spec, place_state, rehome_into,
                                  remat, state_device, to_storage, tree_from_numpy)
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import ssm
from repro_torch.nn.attention import KVCache
from repro_torch.nn.init import embed_init, split_keys
from repro_torch.nn.layers import embed as embed_lookup
from repro_torch.nn.layers import embed_specs, gated_mlp, gated_mlp_params, gated_mlp_specs
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.transformer import _noop_constrain, norm_apply, norm_params, norm_specs, residual


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def init_hybrid(generator: torch.Generator, cfg, device: DeviceLike = None, masters=False) -> dict:
    """Random weights, as `repro_torch.models.lm.init_lm` makes them."""
    dev = resolve_device(device)
    keys = split_keys(generator, cfg.n_layers + 2)
    gdev = generator.device
    p = {"embed": {"w": to_storage(embed_init(keys[0], cfg.vocab, cfg.d_model), cfg, dev, masters)}}
    blocks = []
    for i in range(cfg.n_layers):
        k_mix, k_mlp = split_keys(keys[1 + i], 2)
        lp = {"ln1": norm_params(cfg, cfg.d_model, gdev)}
        if cfg.is_attn_layer(i):
            lp["attn"] = attn_lib.attention_params(
                k_mix, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        else:
            lp["rec"] = ssm.recurrent_block_params(
                k_mix, cfg.d_model, cfg.rnn_width, cfg.rnn_heads, cfg.conv_width)
        lp["ln2"] = norm_params(cfg, cfg.d_model, gdev)
        lp["mlp"] = gated_mlp_params(k_mlp, cfg.d_model, cfg.d_ff)
        blocks.append(to_storage(lp, cfg, dev, masters))
    p["blocks"] = blocks
    p["final_norm"] = norm_params(cfg, cfg.d_model, dev)
    return p


def param_specs(cfg) -> dict:
    """The ShardSpec tree of `init_hybrid`'s params (the reference's
    ``layer_i`` specs as the list ``blocks``)."""
    blocks = []
    for i in range(cfg.n_layers):
        ls = {"ln1": norm_specs(cfg)}
        if cfg.is_attn_layer(i):
            ls["attn"] = attn_lib.attention_specs()
        else:
            ls["rec"] = ssm.recurrent_block_specs()
        ls["ln2"] = norm_specs(cfg)
        ls["mlp"] = gated_mlp_specs()
        blocks.append(ls)
    return {"embed": embed_specs(), "blocks": blocks, "final_norm": norm_specs(cfg)}


def params_from_numpy(tree, cfg, device: DeviceLike = None, masters=False) -> dict:
    """The reference's ``init_hybrid`` params (``{"layer_i": ...}``
    blocks) as the port's, on ``device``, in their storage dtypes (f32
    with ``masters``)."""
    dev = resolve_device(device)
    out = {k: tree_from_numpy(v, dev) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [tree_from_numpy(lp, dev) for lp in layer_list(tree["blocks"], cfg.n_layers)]
    return to_storage(out, cfg, masters=masters)


def _embed(params, cfg, tokens, dtype):
    return embed_lookup(params["embed"], tokens, dtype=dtype) * embed_scale(cfg, dtype)


def _logits(params, cfg, x, dtype, constrain=_noop_constrain):
    x = norm_apply(cfg, params["final_norm"], x, dtype)
    return constrain(x @ params["embed"]["w"].to(dtype).T, ("batch", None, "vocab"))


def _attn_seq(lp, x, positions, *, cfg, dtype):
    T = x.shape[1]
    q, k, v = attn_lib.project_qkv(
        lp["attn"], x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, dtype=dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    t_ar = torch.arange(T, dtype=torch.int32, device=x.device)
    mask = attn_lib.make_mask(t_ar, t_ar, cfg.local_window)
    ctx = attn_lib.mha(q, k, v, mask, dtype=dtype)
    return attn_lib.attn_out(lp["attn"], ctx, dtype=dtype), (k, v)


def _layer(lp, x, positions, *, i, cfg, dtype, constrain):
    """Layer ``i`` over a whole sequence: (x, its decode state: (k, v) or a
    RecurrentState)."""
    h = constrain(norm_apply(cfg, lp["ln1"], x, dtype), ("batch", None, None))
    if cfg.is_attn_layer(i):
        y, kv = _attn_seq(lp, h, positions, cfg=cfg, dtype=dtype)
    else:
        y, kv = ssm.recurrent_block(lp["rec"], h, n_heads=cfg.rnn_heads, dtype=dtype,
                                    with_state=True)
    x = constrain(residual(x, y, constrain), ("batch", "seq", None))
    h = constrain(norm_apply(cfg, lp["ln2"], x, dtype), ("batch", None, None))
    x = residual(x, gated_mlp(lp["mlp"], h, act=cfg.act, dtype=dtype), constrain)
    return constrain(x, ("batch", "seq", None)), kv


def _layers_seq(params, cfg, tokens, layer_state=None, constrain=_noop_constrain,
                layer_specs=None):
    """The layer stack over a whole sequence: the final hidden states;
    ``layer_state(i, kv or RecurrentState)`` receives each layer's decode
    state where given (prefill, ``collect_kv``). Without it each layer is
    a `remat` unit, as the reference checkpoints its layers but not with
    ``collect_kv``."""
    dtype = _dtype(cfg)
    B, T = tokens.shape
    x = constrain(_embed(params, cfg, tokens, dtype), ("batch", "seq", None))
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)[None].expand(B, T)
    for i, lp in enumerate(params["blocks"]):
        if layer_state is None:
            x = remat(cfg, lambda lp, x, i=i: _layer(lp, x, positions, i=i, cfg=cfg, dtype=dtype,
                                                     constrain=constrain)[0],
                      lp, x, constrain=constrain, specs=layer_spec(layer_specs, i))
        else:
            x, kv = _layer(lp, x, positions, i=i, cfg=cfg, dtype=dtype, constrain=constrain)
            layer_state(i, kv)
    return x


def forward(params, cfg, batch, *, constrain=_noop_constrain, collect_kv=False, layer_specs=None):
    """batch: {"tokens": (B, T)}. Returns (logits (B, T, V), aux); aux
    {"kv": {"layer_i": (k, v)}} of the attention layers with collect_kv.
    ``layer_specs``: `repro_torch.models.lm.forward`'s."""
    kvs = {}

    def keep(i, kv):
        if cfg.is_attn_layer(i):
            kvs[f"layer_{i}"] = kv

    x = _layers_seq(params, cfg, batch["tokens"], keep if collect_kv else None, constrain,
                    layer_specs)
    return (_logits(params, cfg, x, _dtype(cfg), constrain),
            ({"kv": kvs} if collect_kv else {}))


def init_decode_state(cfg, batch_size: int, seq_len: int, device: DeviceLike = None):
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    S = min(seq_len, cfg.local_window) if cfg.local_window else seq_len
    state = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for i in range(cfg.n_layers):
        if cfg.is_attn_layer(i):
            shape = (batch_size, S, cfg.n_kv_heads, cfg.head_dim)
            state[f"layer_{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                                   "v": torch.zeros(shape, dtype=dtype, device=dev)}
        else:
            rs = ssm.RecurrentState.zeros(batch_size, cfg.rnn_width, cfg.conv_width, device=dev)
            state[f"layer_{i}"] = {"h": rs.h, "conv": rs.conv}
    return state


def rehome_state(cfg, state, seq_len: int):
    """A prefill state in a fresh decode state for ``seq_len`` positions,
    as ``examples/serve_lm.py`` re-homes it: the nested per-layer dicts are
    taken as they are, so each attention layer keeps the prefill's ring of
    ``min(T, window)`` positions (a quirk of the reference: after a prompt
    shorter than the window, decoding attends over a ring the prompt's
    length, not the window)."""
    first = next(iter(state["layer_0"].values()))
    return rehome_into(init_decode_state(cfg, first.shape[0], seq_len, state_device(first)), state)


def decode_step(params, cfg, state, token, *, constrain=_noop_constrain, use_kernel=False):
    """One decode step. token: (B,) int32. Returns (logits (B, V), new
    state); every layer's state is written in place, and the new state
    shares its per-layer dicts. ``use_kernel`` routes
    the attention layers through the flash-decode kernel (window 0: the
    ring is the window)."""
    dtype = _dtype(cfg)
    B = token.shape[0]
    pos = state["pos"]
    x = constrain(_embed(params, cfg, token[:, None], dtype)[:, 0], ("batch", None))
    pos_b = pos.to(torch.int32).expand(B, 1)
    new_state = {"pos": pos + 1}
    for i, lp in enumerate(params["blocks"]):
        ls = new_state[f"layer_{i}"] = state[f"layer_{i}"]
        h = norm_apply(cfg, lp["ln1"], x[:, None, :], dtype)[:, 0]
        if cfg.is_attn_layer(i):
            cache = KVCache(ls["k"], ls["v"])
            S_cache = cache.k.shape[1]
            q, k, v = attn_lib.project_qkv(
                lp["attn"], h[:, None, :], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, dtype=dtype)
            q = apply_rope(q, pos_b, cfg.rope_theta)
            k = apply_rope(k, pos_b, cfg.rope_theta)
            idx = torch.remainder(pos, S_cache)  # ring buffer (window-sized cache)
            cache = attn_lib.cache_update(cache, k[:, 0], v[:, 0], idx)
            cache_len = torch.clamp(pos + 1, max=S_cache).to(torch.int32)
            ctx = attn_lib.decode_attention(q[:, 0], cache, cache_len, dtype=dtype,
                                            use_kernel=use_kernel)
            ctx = constrain(ctx[:, None], ("batch", None, "heads", None))
            y = attn_lib.attn_out(lp["attn"], ctx, dtype=dtype)[:, 0]
        else:
            y, rec = ssm.recurrent_block_step(lp["rec"], h, ssm.RecurrentState(ls["h"], ls["conv"]),
                                              n_heads=cfg.rnn_heads, dtype=dtype)
            ls["h"].copy_(rec.h)
            ls["conv"].copy_(rec.conv)
        x = x + constrain(y, ("batch", None))
        h = norm_apply(cfg, lp["ln2"], x[:, None, :], dtype)
        x = x + constrain(gated_mlp(lp["mlp"], h, act=cfg.act, dtype=dtype)[:, 0], ("batch", None))
    return _logits(params, cfg, x, dtype), new_state


def prefill(params, cfg, batch, *, constrain=_noop_constrain):
    """Prefill: the layer stack over the prompt and the decode state: each
    attention layer's trailing window of k/v, rolled so that entry t lands
    at t % S (S = min(T, window)), and each recurrent layer's RG-LRU state
    and conv lookback (the pre-conv branch inputs). Returns (last-token
    logits (B, 1, V), state)."""
    dtype = _dtype(cfg)
    tokens = batch["tokens"]
    T = tokens.shape[1]
    S = min(T, cfg.local_window) if cfg.local_window else T
    state = {"pos": torch.tensor(T, dtype=torch.int32, device=tokens.device)}

    def keep(i, kv):
        if cfg.is_attn_layer(i):
            k, v = kv
            shift = T % S  # roll so entry t lands at t % S
            state[f"layer_{i}"] = {"k": torch.roll(k[:, -S:], shift, dims=1),
                                   "v": torch.roll(v[:, -S:], shift, dims=1)}
        else:
            state[f"layer_{i}"] = {"h": kv.h, "conv": kv.conv}

    x = _layers_seq(params, cfg, tokens, keep, constrain)
    return (_logits(params, cfg, x[:, -1:, :], dtype),
            place_state(state, decode_state_axes(cfg), constrain))
