"""rwkv6-1.6b [ssm]: 24L d2048 (attention-free) d_ff 7168 vocab 65536.

Finch: token-shift ddlerp, data-dependent decay (LoRA), per-head matrix
state wkv. 32 heads × head 64. [arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    rnn_heads=32,
    norm="layernorm",
    tie_embeddings=False,
    scan_layers=True,
    accum_steps=2,
)
