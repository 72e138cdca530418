"""Decoder-only LM, dense family — the port of ``repro.models.lm``.

Parameters are nested dicts of tensors with the reference's names and
layouts; ``params["blocks"]`` is a list with one dict per layer, and every
layer loop is a Python loop over it. MoE and VLM (M-RoPE, vision stub)
raise ``NotImplementedError`` until they are ported (ROADMAP.md Queue 1
item 11).

**Storage dtypes.** The reference keeps f32 masters and casts each weight
to ``cfg.dtype`` at every use; at full width that would move the f32
weights through memory on every decode step. The port casts each tensor
once, when it is made or loaded (`to_storage`), to the dtype its use site
casts it to: matrices and the embedding table to ``cfg.dtype``, norm
scales kept in f32 (``rmsnorm`` computes with ``g`` in f32, and an
f32 → bf16 → f32 trip would change it). The cast is deterministic, so the
weights each use sees are bit-identical to the reference's.

**KV cache.** `decode_step` writes the new token's k/v into the cache
tensors of ``state`` in place and returns a state that shares them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.nn import transformer as tfm
from repro_torch.nn.attention import KVCache
from repro_torch.nn.init import embed_init, split_keys
from repro_torch.nn.layers import embed as embed_lookup


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _require_text_lm(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch.models.lm yet "
            "(ROADMAP.md Queue 1 item 11); the dense family is")
    if cfg.mrope or cfg.frontend != "none":
        raise NotImplementedError("M-RoPE and stub frontends are not ported to repro_torch "
                                  "yet (ROADMAP.md Queue 1 item 11, VLM)")
    if cfg.attn_pattern == "swa":
        raise NotImplementedError("sliding-window ring-buffer caches are not ported to "
                                  "repro_torch yet (ROADMAP.md Queue 1 item 11, MoE: mixtral)")


def to_storage(params, cfg, device=None):
    """Each leaf in the dtype its use site computes with (see the module
    docstring), on ``device`` (default: where it is): in the dense family
    every 2-D leaf is a matrix or an embedding table, used in
    ``cfg.dtype``, and every 1-D leaf a norm scale, used in f32."""
    if isinstance(params, dict):
        return {k: to_storage(v, cfg, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_storage(v, cfg, device) for v in params]
    return params.to(device=device, dtype=_dtype(cfg) if params.ndim >= 2 else torch.float32)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(generator: torch.Generator, cfg, device: DeviceLike = None) -> dict:
    """Random weights from ``generator`` on ``device``. Each tensor is
    drawn in f32 on the generator's device, as the reference's masters
    are, then cast to its storage dtype and moved (a CUDA generator
    initialises a full-width model on the card without a host trip)."""
    _require_text_lm(cfg)
    dev = resolve_device(device)
    keys = split_keys(generator, cfg.n_layers + 3)
    p = {"embed": {"w": to_storage(embed_init(keys[0], cfg.vocab, cfg.d_model), cfg, dev)}}
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": to_storage(embed_init(keys[1], cfg.vocab, cfg.d_model), cfg, dev)}
    p["blocks"] = [to_storage(tfm.block_params(keys[3 + i], cfg), cfg, dev)
                   for i in range(cfg.n_layers)]
    p["final_norm"] = tfm.norm_params(cfg, cfg.d_model, dev)
    return p


def params_from_numpy(tree, cfg, device: DeviceLike = None) -> dict:
    """The reference's ``init_lm`` params (a nested dict of numpy or JAX
    arrays) as the port's params on ``device``, in their storage dtypes.
    Takes the stacked ``blocks`` of ``scan_layers=True`` (every leaf with a
    leading layer axis) as well as ``{"layer_i": ...}`` blocks."""
    _require_text_lm(cfg)
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        a = np.asarray(t, dtype=np.float32)
        return torch.from_numpy(a.copy()).to(dev)

    blocks = tree["blocks"]
    if "layer_0" in blocks:
        layers = [blocks[f"layer_{i}"] for i in range(cfg.n_layers)]
    else:
        def take(t, i):
            return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)[i]

        first = blocks["ln1"]["g"]
        if np.shape(first)[0] != cfg.n_layers:
            raise ValueError(f"stacked blocks hold {np.shape(first)[0]} layers, "
                             f"config has {cfg.n_layers}")
        layers = [take(blocks, i) for i in range(cfg.n_layers)]
    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [conv(lp) for lp in layers]
    return to_storage(out, cfg)


# ---------------------------------------------------------------------------
# embedding / head helpers
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens):
    dtype = _dtype(cfg)
    x = embed_lookup(params["embed"], tokens, dtype=dtype)
    if cfg.zero_centered_norm:  # gemma convention
        # the scale is rounded to the compute dtype first, as the
        # reference's jnp.asarray(sqrt(d_model), dtype): 50.5 in bf16 (a
        # host scalar; nothing is read back from the device)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dtype))
    return x


def lm_logits(params, cfg, x):
    dtype = _dtype(cfg)
    x = tfm.norm_apply(cfg, params["final_norm"], x, dtype)
    table = params["embed"]["w"] if cfg.tie_embeddings else params["unembed"]["w"]
    return x.to(dtype) @ table.to(dtype).T


def _positions(cfg, B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


# ---------------------------------------------------------------------------
# forward (sequence mode)
# ---------------------------------------------------------------------------

def forward(params, cfg, batch, *, collect_kv=False, logits_mode="all"):
    """batch: {"tokens": (B,S) int32}.

    Returns (logits, aux). aux: {"kv": (L,B,S,KV,hd) x2} with collect_kv.
    ``logits_mode="last"`` computes the unembed on the final position only
    (prefill path — avoids materialising (B, S, V)).
    """
    _require_text_lm(cfg)
    dtype = _dtype(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = _positions(cfg, B, S, tokens.device)
    windows = tfm.layer_windows(cfg)
    thetas = tfm.layer_thetas(cfg)
    ks, vs = [], []
    for lp, window, theta in zip(params["blocks"], windows, thetas):
        x, aux = tfm.block_seq(lp, x, positions, cfg=cfg, window=window, theta=theta,
                               dtype=dtype, return_kv=collect_kv)
        if collect_kv:
            ks.append(aux["kv"][0])
            vs.append(aux["kv"][1])
    aux = {}
    if collect_kv:
        aux["kv"] = (torch.stack(ks, 0), torch.stack(vs, 0))
    if logits_mode == "last":
        x = x[:, -1:, :]
    return lm_logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode (state = stacked KV caches)
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch_size: int, seq_len: int, device: DeviceLike = None):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def rehome_state(cfg, state, seq_len: int):
    """``state`` (as `prefill` returns it, its caches sized to the prompt)
    copied into a fresh decode state with caches of ``seq_len`` positions,
    on the same device: room for ``seq_len - pos`` decode steps. The
    reference does this in ``examples/serve_lm.py``."""
    B, T = state["k"].shape[1:3]
    full = init_decode_state(cfg, B, seq_len, state["k"].device)
    full["k"][:, :, :T] = state["k"]
    full["v"][:, :, :T] = state["v"]
    full["pos"] = state["pos"].clone()
    return full


def decode_step(params, cfg, state, token, *, use_kernel=False):
    """One decode step. token: (B,) int32. Returns (logits (B,V), new state).

    The caches of ``state`` are written in place and shared with the new
    state; ``pos`` stays a device scalar. ``use_kernel`` routes every
    layer's decode attention through the flash-decode kernel
    (`repro_torch.kernels.ops.decode_attn`) with the layer's window.
    """
    _require_text_lm(cfg)
    dtype = _dtype(cfg)
    pos = state["pos"]
    x = embed_tokens(params, cfg, token[:, None])[:, 0]
    windows = tfm.layer_windows(cfg)
    thetas = tfm.layer_thetas(cfg)
    for i, (lp, window, theta) in enumerate(zip(params["blocks"], windows, thetas)):
        x, _ = tfm.block_step(lp, x, KVCache(state["k"][i], state["v"][i]), pos, cfg=cfg,
                              window=window, theta=theta, dtype=dtype, use_kernel=use_kernel)
    logits = lm_logits(params, cfg, x[:, None, :])[:, 0]
    return logits, {"k": state["k"], "v": state["v"], "pos": pos + 1}


def prefill(params, cfg, batch):
    """Full-sequence prefill that also materialises the KV caches.

    Returns (last-token logits (B, 1, V), decode state).
    """
    logits, aux = forward(params, cfg, batch, collect_kv=True, logits_mode="last")
    k, v = aux["kv"]
    S = batch["tokens"].shape[1]
    state = {"k": k, "v": v, "pos": torch.tensor(S, dtype=torch.int32, device=k.device)}
    return logits, state
