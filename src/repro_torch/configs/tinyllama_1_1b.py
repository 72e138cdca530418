"""tinyllama-1.1b [dense]: 22L d2048 32H (kv=4) d_ff 5632 vocab 32000.

llama2-architecture small model. [arXiv:2401.02385; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    rope_theta=10000.0,
    act="silu",
    tie_embeddings=False,
    scan_layers=True,
    accum_steps=2,
)
