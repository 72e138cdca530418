"""qwen2-vl-72b [vlm]: 80L d8192 64H (kv=8) d_ff 29568 vocab 152064.

M-RoPE (temporal/height/width rotary sections), dynamic-resolution vision
frontend provided as a STUB — input_specs() supplies precomputed patch
embeddings; the transformer backbone is what we build.
[arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    rope_theta=1000000.0,
    mrope=True,
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
    frontend_dim=8192,
    act="silu",
    tie_embeddings=False,
    scan_layers=True,
    accum_steps=16,
)
