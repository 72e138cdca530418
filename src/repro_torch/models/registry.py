"""Uniform model interface over the architecture families — the port of
``repro.models.registry``.

``forward``, ``prefill`` and ``decode_step`` pass ``constrain`` through as
the reference's do (None: a no-op). With params placed on a mesh
(DTensors), each call runs under `repro_torch.runtime.sharding.spmd`,
which lets the families' plain tensors (positions, masks, zero states)
meet the sharded ones as replicated values.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, lm, rwkv, whisper
from repro_torch.nn.transformer import _noop_constrain
from repro_torch.runtime.sharding import spmd


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable  # (generator, device=None, masters=False) -> params
    forward: Callable  # (params, batch, **kw) -> (logits, aux)
    prefill: Callable  # (params, batch) -> (logits, state)
    decode_step: Callable  # (params, state, token, **kw) -> (logits, state)
    init_decode_state: Callable  # (batch, seq_len, device=None) -> state dict
    # the port's own: the reference's params (numpy or JAX arrays) on a
    # device, a prefill state re-homed as examples/serve_lm.py does, and
    # f32 masters (``masters=True``, training) as serving storage
    params_from_numpy: Callable  # (tree, device=None, masters=False) -> params
    rehome_state: Callable  # (state, seq_len) -> state
    to_storage: Callable  # (params, device=None) -> params
    # the params' ShardSpec tree in the port's layout, and the per-layer
    # part of it that ``forward(layer_specs=)`` takes
    param_specs: Callable  # () -> ShardSpec tree
    layer_specs: Callable  # () -> per-layer ShardSpec trees


_FAMILY_MODULES = {
    "dense": lm,
    "moe": lm,
    "vlm": lm,
    "rwkv": rwkv,
    "hybrid": hybrid,
    "encdec": whisper,
}

_INITS = {
    "dense": lm.init_lm,
    "moe": lm.init_lm,
    "vlm": lm.init_lm,
    "rwkv": rwkv.init_rwkv,
    "hybrid": hybrid.init_hybrid,
    "encdec": whisper.init_encdec,
}


def _layer_specs(cfg, specs):
    if cfg.family == "encdec":
        return {"encoder": specs["encoder"], "decoder": specs["decoder"]}
    return specs["blocks"]


def build_model(cfg: ModelConfig) -> Model:
    mod = _FAMILY_MODULES[cfg.family]
    init_fn = _INITS[cfg.family]

    def forward(params, batch, constrain=None, **kw):
        with spmd(params):
            return mod.forward(params, cfg, batch, constrain=constrain or _noop_constrain, **kw)

    def prefill(params, batch, constrain=None):
        with spmd(params):
            return mod.prefill(params, cfg, batch, constrain=constrain or _noop_constrain)

    def decode_step(params, state, token, constrain=None, **kw):
        with spmd(params):
            return mod.decode_step(params, cfg, state, token,
                                   constrain=constrain or _noop_constrain, **kw)

    return Model(
        cfg=cfg,
        init=lambda generator, device=None, masters=False: init_fn(generator, cfg, device, masters),
        forward=forward,
        prefill=prefill,
        decode_step=decode_step,
        init_decode_state=lambda batch_size, seq_len, device=None: mod.init_decode_state(
            cfg, batch_size, seq_len, device),
        params_from_numpy=lambda tree, device=None, masters=False: mod.params_from_numpy(
            tree, cfg, device, masters),
        rehome_state=lambda state, seq_len: mod.rehome_state(cfg, state, seq_len),
        to_storage=lambda params, device=None: lm.to_storage(params, cfg, device),
        param_specs=lambda: mod.param_specs(cfg),
        layer_specs=lambda: _layer_specs(cfg, mod.param_specs(cfg)),
    )
