"""Uniform model interface over the architecture families — the port of
``repro.models.registry``. The dense family is ported; every other family
raises ``NotImplementedError`` naming its ROADMAP item."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

# family -> what is missing for it (ROADMAP.md Queue 1 item 11)
_NOT_PORTED = {
    "moe": "the MoE family (nn/moe.py), ROADMAP.md Queue 1 item 11",
    "vlm": "the VLM family (M-RoPE, vision stub), ROADMAP.md Queue 1 item 11",
    "rwkv": "the RWKV family (models/rwkv.py), ROADMAP.md Queue 1 item 11",
    "hybrid": "the hybrid family (models/hybrid.py, nn/ssm.py), ROADMAP.md Queue 1 item 11",
    "encdec": "the encoder-decoder family (models/whisper.py), ROADMAP.md Queue 1 item 11",
}


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable  # (generator, device=None) -> params
    forward: Callable  # (params, batch, **kw) -> (logits, aux)
    prefill: Callable  # (params, batch) -> (logits, state)
    decode_step: Callable  # (params, state, token, **kw) -> (logits, state)
    init_decode_state: Callable  # (batch, seq_len, device=None) -> state dict


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch yet: "
            f"{_NOT_PORTED.get(cfg.family, 'unknown family')}")
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: lm.init_lm(generator, cfg, device),
        forward=lambda params, batch, **kw: lm.forward(params, cfg, batch, **kw),
        prefill=lambda params, batch: lm.prefill(params, cfg, batch),
        decode_step=lambda params, state, token, **kw: lm.decode_step(params, cfg, state, token, **kw),
        init_decode_state=lambda batch_size, seq_len, device=None: lm.init_decode_state(
            cfg, batch_size, seq_len, device),
    )
