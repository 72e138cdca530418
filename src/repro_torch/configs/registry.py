"""Architecture registry: ``--arch <id>`` → ModelConfig."""
from __future__ import annotations

from repro_torch.configs import (
    gemma3_4b,
    mixtral_8x7b,
    phi35_moe_42b,
    qwen2_vl_72b,
    qwen3_32b,
    qwen3_4b,
    recurrentgemma_2b,
    rwkv6_1_6b,
    tinyllama_1_1b,
    whisper_large_v3,
)
from repro_torch.configs.base import ModelConfig, reduced

ARCHS = {
    cfg.CONFIG.name: cfg.CONFIG
    for cfg in (
        gemma3_4b,
        qwen3_4b,
        tinyllama_1_1b,
        qwen3_32b,
        rwkv6_1_6b,
        mixtral_8x7b,
        phi35_moe_42b,
        qwen2_vl_72b,
        whisper_large_v3,
        recurrentgemma_2b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_reduced_config(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)


def list_archs():
    return sorted(ARCHS)
