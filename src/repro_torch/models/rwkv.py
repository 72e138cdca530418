"""RWKV6 (Finch) language model: attention-free, O(1)-state decode — the
port of ``repro.models.rwkv``.

``params["blocks"]`` is a list with one dict a layer. The decode state is
the reference's: ``wkv`` (L, B, H, hd, hd) f32, the token-shift carries
``x_tm``/``x_cm`` (L, B, D) and ``pos``; a decode step writes them in
place. No attention, so no kernel: ``use_kernel`` is taken and ignored,
as in the reference. ``param_specs(cfg)`` and the ``constrain`` hook are
`repro_torch.models.lm`'s; the time mix and the channel mix take their
input constrained to ``("batch", None, None)``: the WKV recurrence and the
token shift run along the whole sequence.
"""
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.specs import decode_state_axes
from repro_torch.models.lm import (layer_list, layer_spec, place_state, rehome_into, remat,
                                  state_device, to_storage, tree_from_numpy)
from repro_torch.nn import ssm
from repro_torch.nn.init import embed_init, split_keys
from repro_torch.nn.layers import embed as embed_lookup
from repro_torch.nn.layers import embed_specs, layernorm, layernorm_params, layernorm_specs
from repro_torch.nn.transformer import _noop_constrain, residual


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def init_rwkv(generator: torch.Generator, cfg, device: DeviceLike = None, masters=False) -> dict:
    """Random weights, as `repro_torch.models.lm.init_lm` makes them."""
    dev = resolve_device(device)
    keys = split_keys(generator, cfg.n_layers + 4)
    gdev = generator.device
    p = {
        "embed": {"w": to_storage(embed_init(keys[0], cfg.vocab, cfg.d_model), cfg, dev, masters)},
        "unembed": {"w": to_storage(embed_init(keys[1], cfg.vocab, cfg.d_model), cfg, dev, masters)},
        "ln0": layernorm_params(cfg.d_model, device=dev),
    }
    blocks = []
    for i in range(cfg.n_layers):
        k_tm, k_cm = split_keys(keys[2 + i], 2)
        blocks.append(to_storage({
            "ln1": layernorm_params(cfg.d_model, device=gdev),
            "tm": ssm.rwkv_timemix_params(k_tm, cfg.d_model, cfg.rnn_heads),
            "ln2": layernorm_params(cfg.d_model, device=gdev),
            "cm": ssm.rwkv_channelmix_params(k_cm, cfg.d_model, cfg.d_ff),
        }, cfg, dev, masters))
    p["blocks"] = blocks
    p["final_norm"] = layernorm_params(cfg.d_model, device=dev)
    return p


def param_specs(cfg) -> dict:
    """The ShardSpec tree of `init_rwkv`'s params (the reference's stacked
    block specs as the list ``blocks``, without ``"layers"``)."""
    block = {"ln1": layernorm_specs(), "tm": ssm.rwkv_timemix_specs(),
             "ln2": layernorm_specs(), "cm": ssm.rwkv_channelmix_specs()}
    return {"embed": embed_specs(), "unembed": embed_specs(), "ln0": layernorm_specs(),
            "blocks": [block for _ in range(cfg.n_layers)], "final_norm": layernorm_specs()}


def params_from_numpy(tree, cfg, device: DeviceLike = None, masters=False) -> dict:
    """The reference's ``init_rwkv`` params (stacked blocks) as the port's,
    on ``device``, in their storage dtypes (f32 with ``masters``)."""
    dev = resolve_device(device)
    out = {k: tree_from_numpy(v, dev) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [tree_from_numpy(lp, dev) for lp in layer_list(tree["blocks"], cfg.n_layers)]
    return to_storage(out, cfg, masters=masters)


def _layers_seq(params, cfg, tokens, constrain=_noop_constrain, layer_specs=None):
    """The layer stack over a whole sequence from a zero state: (hidden
    states, per-layer final states {"wkv", "x_tm", "x_cm"} stacked). Each
    layer is a `remat` unit (the reference checkpoints its forward's and
    its prefill's layers)."""
    dtype = _dtype(cfg)
    B = tokens.shape[0]
    H, D = cfg.rnn_heads, cfg.d_model
    hd = D // H
    x = embed_lookup(params["embed"], tokens, dtype=dtype)
    x = constrain(layernorm(params["ln0"], x, dtype=dtype), ("batch", "seq", None))
    zeros_x = torch.zeros((B, D), dtype=dtype, device=tokens.device)
    state0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=tokens.device)

    def layer(lp, x):
        h = constrain(layernorm(lp["ln1"], x, dtype=dtype), ("batch", None, None))
        y, x_tm, wkv = ssm.rwkv_timemix(lp["tm"], h, zeros_x, state0, n_heads=H, dtype=dtype)
        x = constrain(residual(x, y, constrain), ("batch", "seq", None))
        h = constrain(layernorm(lp["ln2"], x, dtype=dtype), ("batch", None, None))
        y, x_cm = ssm.rwkv_channelmix(lp["cm"], h, zeros_x, dtype=dtype)
        return constrain(residual(x, y, constrain), ("batch", "seq", None)), wkv, x_tm, x_cm

    states = {"wkv": [], "x_tm": [], "x_cm": []}
    for i, lp in enumerate(params["blocks"]):
        x, wkv, x_tm, x_cm = remat(cfg, layer, lp, x, constrain=constrain,
                                   specs=layer_spec(layer_specs, i))
        for name, t in (("wkv", wkv), ("x_tm", x_tm), ("x_cm", x_cm)):
            states[name].append(t)
    return x, {name: torch.stack(ts) for name, ts in states.items()}


def _logits(params, cfg, x, dtype, constrain=_noop_constrain):
    x = layernorm(params["final_norm"], x, dtype=dtype)
    return constrain(x @ params["unembed"]["w"].to(dtype).T, ("batch", None, "vocab"))


def forward(params, cfg, batch, *, constrain=_noop_constrain, collect_kv=False, layer_specs=None):
    """batch: {"tokens": (B, T)}. Returns (logits (B, T, V), {}).
    ``layer_specs``: `repro_torch.models.lm.forward`'s."""
    x, _ = _layers_seq(params, cfg, batch["tokens"], constrain, layer_specs)
    return _logits(params, cfg, x, _dtype(cfg), constrain), {}


def init_decode_state(cfg, batch_size: int, seq_len: int, device: DeviceLike = None):
    """O(1) state: wkv matrix + token-shift carries per layer. seq_len unused."""
    dev = resolve_device(device)
    H, D = cfg.rnn_heads, cfg.d_model
    hd = D // H
    L = cfg.n_layers
    dtype = _dtype(cfg)
    return {
        "wkv": torch.zeros((L, batch_size, H, hd, hd), dtype=torch.float32, device=dev),
        "x_tm": torch.zeros((L, batch_size, D), dtype=dtype, device=dev),
        "x_cm": torch.zeros((L, batch_size, D), dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def rehome_state(cfg, state, seq_len: int):
    """The prefill state in a fresh decode state (every entry has its final
    shape already: ``examples/serve_lm.py`` copies it as it is)."""
    B = state["wkv"].shape[1]
    return rehome_into(init_decode_state(cfg, B, seq_len, state_device(state["wkv"])), state)


def decode_step(params, cfg, state, token, *, constrain=_noop_constrain, use_kernel=False):
    """One decode step. token: (B,) int32. Returns (logits (B, V), new
    state); ``wkv``, ``x_tm`` and ``x_cm`` are written in place."""
    dtype = _dtype(cfg)
    x = embed_lookup(params["embed"], token[:, None], dtype=dtype)[:, 0]
    x = layernorm(params["ln0"], x, dtype=dtype)
    H = cfg.rnn_heads
    for i, lp in enumerate(params["blocks"]):
        h = layernorm(lp["ln1"], x, dtype=dtype)
        y, x_tm, wkv = ssm.rwkv_timemix_step(lp["tm"], h, state["x_tm"][i], state["wkv"][i],
                                             n_heads=H, dtype=dtype)
        x = x + y
        h2 = layernorm(lp["ln2"], x, dtype=dtype)
        y, x_cm = ssm.rwkv_channelmix_step(lp["cm"], h2, state["x_cm"][i], dtype=dtype)
        x = x + y
        state["wkv"][i].copy_(wkv)
        state["x_tm"][i].copy_(x_tm)
        state["x_cm"][i].copy_(x_cm)
    logits = _logits(params, cfg, x, dtype)
    return logits, {"wkv": state["wkv"], "x_tm": state["x_tm"], "x_cm": state["x_cm"],
                    "pos": state["pos"] + 1}


def prefill(params, cfg, batch, *, constrain=_noop_constrain):
    """Prefill = the layer stack over the prompt + each layer's final
    recurrent state. Returns (last-token logits (B, 1, V), state)."""
    x, states = _layers_seq(params, cfg, batch["tokens"], constrain)
    logits = _logits(params, cfg, x[:, -1:, :], _dtype(cfg))
    T = batch["tokens"].shape[1]
    states["pos"] = torch.tensor(T, dtype=torch.int32, device=x.device)
    return logits, place_state(states, decode_state_axes(cfg), constrain)
