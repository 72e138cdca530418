"""Whisper-large-v3 backbone: encoder-decoder transformer — the port of
``repro.models.whisper``.

The conv/mel frontend is a stub, as in the reference: ``batch["frames"]``
holds precomputed frame embeddings (B, enc_seq, d_model).
``params["encoder"]`` and ``params["decoder"]`` are lists with one dict a
layer. The decode state is the reference's: the self-attention caches
``k``/``v`` (L, B, S, KV, hd), written in place; the cross-attention
keys/values ``ck``/``cv`` (L, B, enc_seq, KV, hd), made once by `prefill`
and held unchanged; and ``pos``. ``param_specs(cfg)`` and the
``constrain`` hook are `repro_torch.models.lm`'s; an attention's inputs
(and the encoder output the cross-attention reads) are constrained to
``("batch", None, None)``: the whole sequence.
"""
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.specs import decode_state_axes
from repro_torch.models.lm import (layer_list, layer_spec, place_state, rehome_into, remat,
                                  state_device, to_storage, tree_from_numpy)
from repro_torch.nn import attention as attn_lib
from repro_torch.nn.attention import KVCache
from repro_torch.nn.init import embed_init, split_keys
from repro_torch.nn.layers import embed as embed_lookup
from repro_torch.nn.layers import (embed_specs, layernorm, layernorm_params, layernorm_specs, mlp,
                                   mlp_params, mlp_specs)
from repro_torch.nn.rope import sinusoid_rows, sinusoid_table
from repro_torch.nn.transformer import _noop_constrain, residual


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _mask_pad_vocab(cfg, logits):
    """Rows [vocab, padded_vocab) of the padded table are dead tokens."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    dead = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
    return logits + torch.where(dead, -1e9, 0.0).to(logits.dtype)


def _attn_params(generator, cfg):
    return attn_lib.attention_params(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim)


def _enc_layer_params(generator, cfg):
    k1, k2 = split_keys(generator, 2)
    dev = generator.device
    return {
        "ln1": layernorm_params(cfg.d_model, device=dev),
        "attn": _attn_params(k1, cfg),
        "ln2": layernorm_params(cfg.d_model, device=dev),
        "mlp": mlp_params(k2, cfg.d_model, cfg.d_ff, cfg.d_model),
    }


def _dec_layer_params(generator, cfg):
    k1, k2, k3 = split_keys(generator, 3)
    dev = generator.device
    return {
        "ln1": layernorm_params(cfg.d_model, device=dev),
        "self_attn": _attn_params(k1, cfg),
        "ln_x": layernorm_params(cfg.d_model, device=dev),
        "cross_attn": _attn_params(k2, cfg),
        "ln2": layernorm_params(cfg.d_model, device=dev),
        "mlp": mlp_params(k3, cfg.d_model, cfg.d_ff, cfg.d_model),
    }


def init_encdec(generator: torch.Generator, cfg, device: DeviceLike = None, masters=False) -> dict:
    """Random weights, as `repro_torch.models.lm.init_lm` makes them."""
    dev = resolve_device(device)
    keys = split_keys(generator, 4)
    return {
        "embed": {"w": to_storage(embed_init(keys[0], cfg.padded_vocab, cfg.d_model), cfg, dev,
                                  masters)},
        "encoder": [to_storage(_enc_layer_params(k, cfg), cfg, dev, masters)
                    for k in split_keys(keys[1], cfg.n_enc_layers)],
        "decoder": [to_storage(_dec_layer_params(k, cfg), cfg, dev, masters)
                    for k in split_keys(keys[2], cfg.n_layers)],
        "enc_ln": layernorm_params(cfg.d_model, device=dev),
        "dec_ln": layernorm_params(cfg.d_model, device=dev),
    }


def param_specs(cfg) -> dict:
    """The ShardSpec tree of `init_encdec`'s params (the reference's
    stacked encoder and decoder specs as lists, without ``"layers"``)."""
    enc = {"ln1": layernorm_specs(), "attn": attn_lib.attention_specs(),
           "ln2": layernorm_specs(), "mlp": mlp_specs()}
    dec = {"ln1": layernorm_specs(), "self_attn": attn_lib.attention_specs(),
           "ln_x": layernorm_specs(), "cross_attn": attn_lib.attention_specs(),
           "ln2": layernorm_specs(), "mlp": mlp_specs()}
    return {"embed": embed_specs(),
            "encoder": [enc for _ in range(cfg.n_enc_layers)],
            "decoder": [dec for _ in range(cfg.n_layers)],
            "enc_ln": layernorm_specs(), "dec_ln": layernorm_specs()}


def params_from_numpy(tree, cfg, device: DeviceLike = None, masters=False) -> dict:
    """The reference's ``init_encdec`` params (stacked encoder and decoder
    layers) as the port's, on ``device``, in their storage dtypes (f32
    with ``masters``)."""
    dev = resolve_device(device)
    out = {k: tree_from_numpy(v, dev) for k, v in tree.items() if k not in ("encoder", "decoder")}
    out["encoder"] = [tree_from_numpy(lp, dev)
                      for lp in layer_list(tree["encoder"], cfg.n_enc_layers, "encoder layers")]
    out["decoder"] = [tree_from_numpy(lp, dev)
                      for lp in layer_list(tree["decoder"], cfg.n_layers, "decoder layers")]
    return to_storage(out, cfg, masters=masters)


def _self_attn(lp, x, mask, *, cfg, dtype):
    q, k, v = attn_lib.project_qkv(
        lp, x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, dtype=dtype)
    ctx = attn_lib.mha(q, k, v, mask, dtype=dtype)
    return attn_lib.attn_out(lp, ctx, dtype=dtype), (k, v)


def _cross_kv(lp, enc_out, *, cfg, dtype):
    e = enc_out.to(dtype)
    return (attn_lib._split_heads(e @ lp["wk"].to(dtype), cfg.n_kv_heads, cfg.head_dim),
            attn_lib._split_heads(e @ lp["wv"].to(dtype), cfg.n_kv_heads, cfg.head_dim))


def _cross_attn(lp, x, ck, cv, *, cfg, dtype):
    q = attn_lib._split_heads(x.to(dtype) @ lp["wq"].to(dtype), cfg.n_heads, cfg.head_dim)
    ctx = attn_lib.mha(q, ck, cv, None, dtype=dtype)
    return attn_lib.attn_out(lp, ctx, dtype=dtype)


def _logits(params, cfg, x, dtype, constrain=_noop_constrain):
    x = constrain(layernorm(params["dec_ln"], x, dtype=dtype), ("batch", None, None))
    logits = _mask_pad_vocab(cfg, x @ params["embed"]["w"].to(dtype).T)
    return constrain(logits, ("batch", None, "vocab"))


def encode(params, cfg, frames, *, constrain=_noop_constrain, layer_specs=None):
    """frames: (B, enc_seq, d_model) stub embeddings -> encoder output.
    Each layer is a `remat` unit, as the reference checkpoints it."""
    dtype = _dtype(cfg)
    S = frames.shape[1]
    x = frames.to(dtype) + sinusoid_table(S, cfg.d_model, frames.device).to(dtype)[None]
    x = constrain(x, ("batch", "seq", None))

    def layer(lp, x):
        h = constrain(layernorm(lp["ln1"], x, dtype=dtype), ("batch", None, None))
        y, _ = _self_attn(lp["attn"], h, None, cfg=cfg, dtype=dtype)
        x = residual(x, y, constrain)
        h = constrain(layernorm(lp["ln2"], x, dtype=dtype), ("batch", None, None))
        x = residual(x, mlp(lp["mlp"], h, act=cfg.act, dtype=dtype), constrain)
        return constrain(x, ("batch", "seq", None))

    for i, lp in enumerate(params["encoder"]):
        x = remat(cfg, layer, lp, x, constrain=constrain, specs=layer_spec(layer_specs, i))
    return layernorm(params["enc_ln"], x, dtype=dtype)


def forward(params, cfg, batch, *, constrain=_noop_constrain, collect_kv=False, logits_mode="all",
            layer_specs=None):
    """Teacher-forced decode over the full target sequence. batch:
    {"tokens": (B, T), "frames": (B, enc_seq, d_model)}. Returns (logits,
    aux); aux {"kv": (L,B,T,KV,hd) x2, "cross": (L,B,enc_seq,KV,hd) x2}
    with collect_kv. Each decoder layer is a `remat` unit but with
    collect_kv, as in the reference. ``layer_specs``: {"encoder",
    "decoder"}, each `repro_torch.models.lm.forward`'s."""
    dtype = _dtype(cfg)
    tokens = batch["tokens"]
    T = tokens.shape[1]
    specs = layer_specs or {}
    enc_out = encode(params, cfg, batch["frames"], constrain=constrain,
                     layer_specs=specs.get("encoder"))
    enc_out = constrain(enc_out, ("batch", None, None))
    x = embed_lookup(params["embed"], tokens, dtype=dtype)
    x = x + sinusoid_table(T, cfg.d_model, tokens.device).to(dtype)[None]
    x = constrain(x, ("batch", "seq", None))
    t_ar = torch.arange(T, dtype=torch.int32, device=tokens.device)
    mask = attn_lib.make_mask(t_ar, t_ar, None)

    def layer(lp, x, enc_out):
        h = constrain(layernorm(lp["ln1"], x, dtype=dtype), ("batch", None, None))
        y, (k, v) = _self_attn(lp["self_attn"], h, mask, cfg=cfg, dtype=dtype)
        x = residual(x, y, constrain)
        h = constrain(layernorm(lp["ln_x"], x, dtype=dtype), ("batch", None, None))
        ck, cv = _cross_kv(lp["cross_attn"], enc_out, cfg=cfg, dtype=dtype)
        x = residual(x, _cross_attn(lp["cross_attn"], h, ck, cv, cfg=cfg, dtype=dtype), constrain)
        h = constrain(layernorm(lp["ln2"], x, dtype=dtype), ("batch", None, None))
        x = residual(x, mlp(lp["mlp"], h, act=cfg.act, dtype=dtype), constrain)
        x = constrain(x, ("batch", "seq", None))
        return x, (k, v, ck, cv)

    ks, vs, cks, cvs = [], [], [], []
    for i, lp in enumerate(params["decoder"]):
        if collect_kv:
            x, kvs = layer(lp, x, enc_out)
            for acc, t in zip((ks, vs, cks, cvs), kvs):
                acc.append(t)
        else:
            x = remat(cfg, lambda lp, x, enc_out: layer(lp, x, enc_out)[0], lp, x, enc_out,
                      constrain=constrain, specs=layer_spec(specs.get("decoder"), i))
    aux = {}
    if collect_kv:
        aux["kv"] = (torch.stack(ks), torch.stack(vs))
        aux["cross"] = (torch.stack(cks), torch.stack(cvs))
    if logits_mode == "last":
        return _logits(params, cfg, x[:, -1:, :], dtype), aux
    return _logits(params, cfg, x, dtype, constrain), aux


def init_decode_state(cfg, batch_size: int, seq_len: int, device: DeviceLike = None):
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    L = cfg.n_layers
    kv = (L, batch_size, seq_len, cfg.n_kv_heads, cfg.head_dim)
    cross = (L, batch_size, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
        "ck": torch.zeros(cross, dtype=dtype, device=dev),
        "cv": torch.zeros(cross, dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def rehome_state(cfg, state, seq_len: int):
    """A prefill state in a fresh decode state whose self-attention caches
    hold ``seq_len`` positions (``examples/serve_lm.py``'s re-homing)."""
    B = state["k"].shape[1]
    return rehome_into(init_decode_state(cfg, B, seq_len, state_device(state["k"])), state)


def decode_step(params, cfg, state, token, *, constrain=_noop_constrain, use_kernel=False):
    """One decode step. token: (B,) int32. Returns (logits (B, V), new
    state). The self-attention caches are written in place; ``ck``/``cv``
    pass through unchanged. ``use_kernel`` routes the self-attention
    through the flash-decode kernel; the cross-attention stays on the
    plain path, as in the reference."""
    dtype = _dtype(cfg)
    B = token.shape[0]
    pos = state["pos"]
    S = state["k"].shape[2]
    x = constrain(embed_lookup(params["embed"], token[:, None], dtype=dtype)[:, 0],
                  ("batch", None))
    # row pos of the reference's sinusoid_table(S) (an index past the end
    # clamps, as dynamic_index_in_dim)
    x = x + sinusoid_rows(torch.clamp(pos, 0, S - 1), cfg.d_model).to(dtype)
    cache_len = (pos + 1).to(torch.int32)
    enc_len = torch.full((), state["ck"].shape[2], dtype=torch.int32, device=token.device)
    for i, lp in enumerate(params["decoder"]):
        h = layernorm(lp["ln1"], x[:, None, :], dtype=dtype)[:, 0]
        q, k, v = attn_lib.project_qkv(
            lp["self_attn"], h[:, None, :], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, dtype=dtype)
        cache = attn_lib.cache_update(KVCache(state["k"][i], state["v"][i]), k[:, 0], v[:, 0], pos)
        ctx = attn_lib.decode_attention(q[:, 0], cache, cache_len, dtype=dtype,
                                        use_kernel=use_kernel)
        ctx = constrain(ctx[:, None], ("batch", None, "heads", None))
        x = x + constrain(attn_lib.attn_out(lp["self_attn"], ctx, dtype=dtype)[:, 0],
                          ("batch", None))
        h = layernorm(lp["ln_x"], x[:, None, :], dtype=dtype)[:, 0]
        qx = attn_lib._split_heads(h.to(dtype) @ lp["cross_attn"]["wq"].to(dtype), cfg.n_heads,
                                   cfg.head_dim)
        ctx2 = attn_lib.decode_attention(qx, KVCache(state["ck"][i], state["cv"][i]), enc_len,
                                         dtype=dtype)
        ctx2 = constrain(ctx2[:, None], ("batch", None, "heads", None))
        x = x + constrain(attn_lib.attn_out(lp["cross_attn"], ctx2, dtype=dtype)[:, 0],
                          ("batch", None))
        h = layernorm(lp["ln2"], x[:, None, :], dtype=dtype)
        x = x + constrain(mlp(lp["mlp"], h, act=cfg.act, dtype=dtype)[:, 0], ("batch", None))
    logits = _logits(params, cfg, x, dtype)
    return logits, {"k": state["k"], "v": state["v"], "ck": state["ck"], "cv": state["cv"],
                    "pos": pos + 1}


def prefill(params, cfg, batch, *, constrain=_noop_constrain):
    """Encoder, then the decoder over the prompt with its caches. Returns
    (last-token logits (B, 1, V), decode state)."""
    logits, aux = forward(params, cfg, batch, constrain=constrain, collect_kv=True,
                          logits_mode="last")
    k, v = aux["kv"]
    ck, cv = aux["cross"]
    T = batch["tokens"].shape[1]
    pos = torch.tensor(T, dtype=torch.int32, device=k.device)
    return logits, place_state({"k": k, "v": v, "ck": ck, "cv": cv, "pos": pos},
                               decode_state_axes(cfg), constrain)
