"""qwen3-4b [dense]: 36L d2560 32H (kv=8) d_ff 9728 vocab 151936.

qk_norm (per-head RMS), head_dim 128 decoupled from d_model.
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    rope_theta=1000000.0,
    qk_norm=True,
    act="silu",
    tie_embeddings=True,
    scan_layers=True,
    accum_steps=4,
)
