"""Decoder-only LM: dense, MoE and VLM (stub frontend) families — the port
of ``repro.models.lm``.

Parameters are nested dicts of tensors with the reference's names and
layouts; ``params["blocks"]`` is a list with one dict per layer, and every
layer loop is a Python loop over it.

**Storage dtypes.** The reference keeps f32 masters and casts each weight
to ``cfg.dtype`` at every use; at full width that would move the f32
weights through memory on every decode step. For serving, the port casts
each tensor once, when it is made or loaded (`to_storage`), to the dtype
its use site casts it to. The cast is deterministic, so the weights each
use sees are bit-identical to the reference's. Training keeps the
reference's f32 masters instead (``masters=True`` of every family's
``init`` and ``params_from_numpy``): each use casts them, as in the
reference, and their gradients come back in f32; `to_storage` turns
trained masters into serving storage. The reference's
``cfg.pre_cast_params`` (cast the blocks once before the layer scan)
changes only when that cast happens, not its result, so the port takes it
and casts at each use either way. The rule is shared by every family
(`repro_torch.models.{hybrid,whisper,rwkv}` call it too).

**Remat.** Where the reference wraps a layer in ``jax.checkpoint``
(``cfg.remat == "full"``), the port runs it through `remat`.

**Sharding.** ``param_specs(cfg)`` is the ShardSpec tree of ``init_lm``'s
params in the port's layout (``blocks`` a list of per-layer trees, each
the reference's stacked spec without its leading ``"layers"`` axis).
``forward``, ``prefill`` and ``decode_step`` take the reference's
``constrain`` hook (a no-op by default) and call it at the reference's
points; with params placed on a mesh (DTensors, `runtime.sharding`)
every op runs on the ranks' shards.

**KV cache.** `decode_step` writes the new token's k/v into the cache
tensors of ``state`` in place and returns a state that shares them. SWA
archs (mixtral) decode into a ring buffer of ``min(seq_len, window)``
positions, written at ``pos % S``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.nn import transformer as tfm
from repro_torch.nn.attention import KVCache
from repro_torch.nn.init import ShardSpec, dense_init, embed_init, split_keys
from repro_torch.nn.layers import embed as embed_lookup
from repro_torch.nn.layers import embed_specs
from repro_torch.nn.moe import dropped_share, load_balancing_loss
from repro_torch.nn.transformer import _noop_constrain


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


# Leaves of 2 or more dimensions whose use sites compute in f32; every
# other matrix, expert stack and embedding table is used in cfg.dtype:
# - "router": the MoE router (nn/moe.py, routing in f32);
# - "w_input_gate", "w_rec_gate": the RG-LRU gate blocks (nn/ssm.py);
# - "decay_lora": RWKV6's decay LoRA, both factors (nn/ssm.py `_lora`).
F32_SUBTREES = frozenset({"router", "w_input_gate", "w_rec_gate", "decay_lora"})


def to_storage(params, cfg, device=None, masters=False, _f32=False):
    """Each leaf in the dtype its use site computes with (see the module
    docstring), on ``device`` (default: where it is): a leaf of 2 or more
    dimensions in ``cfg.dtype`` unless it lies under a key of
    `F32_SUBTREES`; every 1-D leaf (norm scales, biases, decays, lerp
    factors: used in f32, or cast from f32 at their use) in f32. With
    ``masters`` every leaf stays f32 (training). The result is detached:
    trained masters come out as serving params that need no grad."""
    if isinstance(params, dict):
        return {k: to_storage(v, cfg, device, masters, _f32 or k in F32_SUBTREES)
                for k, v in params.items()}
    if isinstance(params, list):
        return [to_storage(v, cfg, device, masters, _f32) for v in params]
    wide = params.ndim >= 2 and not (_f32 or masters)
    return params.detach().to(device=device, dtype=_dtype(cfg) if wide else torch.float32)


def remat(cfg, fn, lp, *args, constrain=_noop_constrain, specs=None):
    """``fn(lp, *args)`` for one layer whose params are ``lp``, its
    activations recomputed in the backward pass (``torch.utils.checkpoint``)
    where the reference wraps the layer in ``jax.checkpoint``: with
    ``cfg.remat == "full"``, while autograd records and ``lp`` requires
    grad. Serving (no grad, or storage params that need none) runs the
    layer as it is. No layer draws random numbers, so no RNG state is
    kept for the recompute. With ``specs`` (the layer's ShardSpec tree)
    and a ``constrain`` that has ``.tree``, the layer's params are
    constrained inside the recomputed body, as the reference's
    ``layer_specs`` does, so their gradients leave the layer in the
    params' placements."""
    if specs is not None and hasattr(constrain, "tree"):
        body = fn

        def fn(lp, *a):
            return body(constrain.tree(lp, specs), *a)

    if (cfg.remat == "full" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tree_leaves(lp))):
        return checkpoint(fn, lp, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(lp, *args)


def layer_spec(layer_specs, i):
    """Layer ``i``'s ShardSpec tree from ``layer_specs`` (a list with one
    tree a layer, `Model.layer_specs`'s), or None."""
    return None if layer_specs is None else layer_specs[i]


def tree_from_numpy(tree, device):
    """A nested dict of numpy or JAX arrays as f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def layer_list(blocks, n_layers: int, what: str = "blocks"):
    """The reference's per-layer params as a list of ``n_layers`` trees:
    from ``{"layer_i": ...}`` blocks, or from stacked blocks
    (``scan_layers=True``: every leaf with a leading layer axis); the
    port's own list (or the tuple a checkpoint restores) as it is."""
    if isinstance(blocks, (list, tuple)):
        if len(blocks) != n_layers:
            raise ValueError(f"{len(blocks)} {what}, config has {n_layers}")
        return list(blocks)
    if "layer_0" in blocks:
        return [blocks[f"layer_{i}"] for i in range(n_layers)]

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)[i]

    first = blocks
    while isinstance(first, dict):
        first = next(iter(first.values()))
    if np.shape(first)[0] != n_layers:
        raise ValueError(f"stacked {what} hold {np.shape(first)[0]} layers, "
                         f"config has {n_layers}")
    return [take(blocks, i) for i in range(n_layers)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(generator: torch.Generator, cfg, device: DeviceLike = None, masters=False) -> dict:
    """Random weights from ``generator`` on ``device``. Each tensor is
    drawn in f32 on the generator's device, as the reference's masters
    are, then cast to its storage dtype (kept f32 with ``masters``) and
    moved (a CUDA generator initialises a full-width model on the card
    without a host trip)."""
    dev = resolve_device(device)
    keys = split_keys(generator, cfg.n_layers + 3)

    def store(t):
        return to_storage(t, cfg, dev, masters)

    p = {"embed": {"w": store(embed_init(keys[0], cfg.vocab, cfg.d_model))}}
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": store(embed_init(keys[1], cfg.vocab, cfg.d_model))}
    if cfg.frontend == "vision_stub":
        p["frontend"] = {"w": store(dense_init(keys[2], cfg.frontend_dim, cfg.d_model))}
    p["blocks"] = [store(tfm.block_params(keys[3 + i], cfg)) for i in range(cfg.n_layers)]
    p["final_norm"] = tfm.norm_params(cfg, cfg.d_model, dev)
    return p


def params_from_numpy(tree, cfg, device: DeviceLike = None, masters=False) -> dict:
    """The reference's ``init_lm`` params (a nested dict of numpy or JAX
    arrays) as the port's params on ``device``, in their storage dtypes
    (f32 with ``masters``). Takes the stacked ``blocks`` of
    ``scan_layers=True`` (every leaf with a leading layer axis) as well as
    ``{"layer_i": ...}`` blocks, and a param-shaped tree of Adam's (``m``,
    ``v``) with ``masters``."""
    dev = resolve_device(device)
    out = {k: tree_from_numpy(v, dev) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [tree_from_numpy(lp, dev) for lp in layer_list(tree["blocks"], cfg.n_layers)]
    return to_storage(out, cfg, masters=masters)


def param_specs(cfg) -> dict:
    """The ShardSpec tree of `init_lm`'s params, with the reference's
    logical axes, in the port's layout."""
    s = {"embed": embed_specs()}
    if not cfg.tie_embeddings:
        s["unembed"] = embed_specs()
    if cfg.frontend == "vision_stub":
        s["frontend"] = {"w": ShardSpec((None, "embed"))}
    s["blocks"] = [tfm.block_specs(cfg) for _ in range(cfg.n_layers)]
    s["final_norm"] = tfm.norm_specs(cfg)
    return s


# ---------------------------------------------------------------------------
# embedding / head helpers
# ---------------------------------------------------------------------------

def embed_scale(cfg, dtype) -> float:
    """sqrt(d_model) rounded to the compute dtype first, as the
    reference's ``jnp.asarray(sqrt(d_model), dtype)``: 50.5 in bf16 at
    d_model 2560 (a host scalar; nothing is read back from the device)."""
    return float(torch.tensor(math.sqrt(cfg.d_model), dtype=dtype))


def embed_tokens(params, cfg, tokens, patches=None, constrain=_noop_constrain):
    """The token embeddings (a vocab-sharded table: a masked local lookup
    and an all-reduce over ``"model"``, `nn.layers.embed`), gemma's scale,
    the patches in the leading positions."""
    dtype = _dtype(cfg)
    x = embed_lookup(params["embed"], tokens, dtype=dtype)
    if cfg.zero_centered_norm:  # gemma convention
        x = x * embed_scale(cfg, dtype)
    if patches is not None:
        pe = patches.to(dtype) @ params["frontend"]["w"].to(dtype)
        # image patches occupy the leading positions of the sequence
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return constrain(x, ("batch", "seq", None))


def lm_logits(params, cfg, x, constrain=_noop_constrain):
    """The (tied) unembed, on the hidden states with ``seq`` gathered.
    Against a vocab-sharded table the logits come out vocab-sharded;
    `training.losses.next_token_ce` takes them so."""
    dtype = _dtype(cfg)
    x = tfm.norm_apply(cfg, params["final_norm"], x, dtype)
    table = params["embed"]["w"] if cfg.tie_embeddings else params["unembed"]["w"]
    if x.ndim == 3:
        x = constrain(x, ("batch", None, None))
    logits = x.to(dtype) @ table.to(dtype).T
    if x.ndim == 3:
        logits = constrain(logits, ("batch", None, "vocab"))
    return logits


def _positions(cfg, batch, B, S, device):
    if cfg.mrope:
        if "mrope_positions" in batch:
            return batch["mrope_positions"]
        pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
        return pos[None].expand(3, B, S)
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


# ---------------------------------------------------------------------------
# forward (sequence mode)
# ---------------------------------------------------------------------------

def forward(params, cfg, batch, *, constrain=_noop_constrain, collect_kv=False,
            logits_mode="all", layer_specs=None):
    """batch: {"tokens": (B,S) int32, optional "patches" (B,N,frontend_dim),
    "mrope_positions" (3,B,S)}.

    Returns (logits, aux). aux: {"moe_loss": scalar (MoE), "kv":
    (L,B,S,KV,hd) x2 with collect_kv}; for MoE also "moe_dropped", the
    share of routed (token, choice) pairs dropped at capacity, over all
    layers (a report; the reference has no such key).
    ``logits_mode="last"`` computes the unembed on the final position only
    (prefill path — avoids materialising (B, S, V)).
    ``layer_specs``: the per-layer ShardSpec trees (`layer_spec`); with a
    ``constrain`` that has ``.tree``, each layer's params are constrained
    inside its remat'd body (`remat`).
    """
    dtype = _dtype(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens, batch.get("patches"), constrain)
    positions = _positions(cfg, batch, B, S, tokens.device)
    windows = tfm.layer_windows(cfg)
    thetas = tfm.layer_thetas(cfg)
    ks, vs, losses, dropped = [], [], [], []
    for i, (lp, window, theta) in enumerate(zip(params["blocks"], windows, thetas)):
        x, aux = remat(cfg, lambda lp, x, window=window, theta=theta: tfm.block_seq(
            lp, x, positions, cfg=cfg, window=window, theta=theta, dtype=dtype,
            constrain=constrain, return_kv=collect_kv), lp, x,
            constrain=constrain, specs=layer_spec(layer_specs, i))
        if collect_kv:
            ks.append(aux["kv"][0])
            vs.append(aux["kv"][1])
        if cfg.family == "moe":
            losses.append(load_balancing_loss(aux["router_logits"], n_experts=cfg.n_experts))
            dropped.append(dropped_share(aux["router_logits"], n_experts=cfg.n_experts,
                                         top_k=cfg.top_k, capacity_factor=cfg.capacity_factor))
    aux = {}
    if cfg.family == "moe":
        aux["moe_loss"] = torch.mean(torch.stack(losses))
        aux["moe_dropped"] = torch.mean(torch.stack(dropped))
    if collect_kv:
        aux["kv"] = (torch.stack(ks, 0), torch.stack(vs, 0))
    if logits_mode == "last":
        return lm_logits(params, cfg, x[:, -1:, :]), aux
    return lm_logits(params, cfg, x, constrain), aux


# ---------------------------------------------------------------------------
# decode (state = stacked KV caches)
# ---------------------------------------------------------------------------

def cache_size(cfg, seq_len: int) -> int:
    """Per-layer KV allocation. Uniform-window archs get ring buffers."""
    if cfg.attn_pattern == "swa" and cfg.local_window > 0:
        return min(seq_len, cfg.local_window)
    return seq_len


def state_logical_axes(cfg):
    """Logical sharding for the decode state (see runtime.sharding)."""
    kv_axes = ("layers", "batch", "kvseq", None, None)
    return {"k": ShardSpec(kv_axes), "v": ShardSpec(kv_axes), "pos": ShardSpec(())}


def init_decode_state(cfg, batch_size: int, seq_len: int, device: DeviceLike = None):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cache_size(cfg, seq_len), cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def rehome_into(full, state):
    """``state`` (as a family's ``prefill`` returns it) copied into ``full``,
    a fresh ``init_decode_state`` on the same device, the way the
    reference's ``examples/serve_lm.py`` re-homes it: a top-level tensor
    whose shape differs from ``full``'s (a KV cache sized to the prompt)
    is written into the leading positions of ``full``'s; any other entry
    (same shape, ``pos``, or a nested per-layer dict, which serve_lm.py
    does not re-home) is taken from ``state``, copied. A prompt longer
    than ``full``'s cache (an SWA ring shorter than the prompt) cannot be
    re-homed, in the reference as here: ValueError. Returns ``full``."""
    def copy(t):
        return {k: copy(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()

    for k, v in state.items():
        dst = full.get(k)
        if isinstance(dst, torch.Tensor) and k != "pos" and dst.shape != v.shape:
            if v.ndim != dst.ndim or any(a > b for a, b in zip(v.shape, dst.shape)):
                raise ValueError(f"cannot re-home {k!r} of shape {tuple(v.shape)} into a decode "
                                 f"state of shape {tuple(dst.shape)} (a prompt longer than the "
                                 "cache, e.g. an SWA window)")
            dst[tuple(slice(0, n) for n in v.shape)] = v
        else:
            full[k] = copy(v)
    return full


def rehome_state(cfg, state, seq_len: int):
    """``state`` (as `prefill` returns it, its caches sized to the prompt)
    copied into a fresh decode state for ``seq_len`` positions, on the
    same device: room for ``seq_len - pos`` decode steps (`rehome_into`).
    SWA archs get a ring of ``min(seq_len, window)`` positions."""
    B = state["k"].shape[1]
    return rehome_into(init_decode_state(cfg, B, seq_len, state["k"].device), state)


def decode_step(params, cfg, state, token, *, constrain=_noop_constrain, use_kernel=False):
    """One decode step. token: (B,) int32. Returns (logits (B,V), new state).

    The caches of ``state`` are written in place and shared with the new
    state; ``pos`` stays a device scalar. ``use_kernel`` routes every
    layer's decode attention through the flash-decode kernel
    (`repro_torch.kernels.ops.decode_attn`) with the layer's window (0 on
    a ring cache). ``constrain`` reaches the blocks, as in the reference.
    """
    dtype = _dtype(cfg)
    pos = state["pos"]
    x = embed_tokens(params, cfg, token[:, None])[:, 0]
    windows = tfm.layer_windows(cfg)
    thetas = tfm.layer_thetas(cfg)
    # SWA archs use ring-buffer caches sized to the window; attention is
    # permutation-invariant over KV entries so ring order needs no masking.
    ring = cfg.attn_pattern == "swa" and cfg.local_window > 0
    for i, (lp, window, theta) in enumerate(zip(params["blocks"], windows, thetas)):
        x, _ = tfm.block_step(lp, x, KVCache(state["k"][i], state["v"][i]), pos, cfg=cfg,
                              window=window, theta=theta, dtype=dtype, constrain=constrain,
                              ring=ring, use_kernel=use_kernel)
    logits = lm_logits(params, cfg, x[:, None, :])[:, 0]
    return logits, {"k": state["k"], "v": state["v"], "pos": pos + 1}


def prefill(params, cfg, batch, *, constrain=_noop_constrain):
    """Full-sequence prefill that also materialises the KV caches.

    Returns (last-token logits (B, 1, V), decode state).
    """
    logits, aux = forward(params, cfg, batch, constrain=constrain, collect_kv=True,
                          logits_mode="last")
    k, v = aux["kv"]
    S = batch["tokens"].shape[1]
    state = {"k": k, "v": v, "pos": torch.tensor(S, dtype=torch.int32, device=k.device)}
    return logits, state
