"""Uniform model interface over the architecture families — the port of
``repro.models.registry``."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, lm, rwkv, whisper


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


def build_model(cfg: ModelConfig) -> Model:
    mod = _FAMILY_MODULES[cfg.family]
    init_fn = _INITS[cfg.family]
    return Model(
        cfg=cfg,
        init=lambda generator, device=None, masters=False: init_fn(generator, cfg, device, masters),
        forward=lambda params, batch, **kw: mod.forward(params, cfg, batch, **kw),
        prefill=lambda params, batch: mod.prefill(params, cfg, batch),
        decode_step=lambda params, state, token, **kw: mod.decode_step(params, cfg, state, token, **kw),
        init_decode_state=lambda batch_size, seq_len, device=None: mod.init_decode_state(
            cfg, batch_size, seq_len, device),
        params_from_numpy=lambda tree, device=None, masters=False: mod.params_from_numpy(
            tree, cfg, device, masters),
        rehome_state=lambda state, seq_len: mod.rehome_state(cfg, state, seq_len),
        to_storage=lambda params, device=None: lm.to_storage(params, cfg, device),
    )
