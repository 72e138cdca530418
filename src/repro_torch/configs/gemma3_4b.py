"""gemma3-4b [dense]: 34L d2560 8H (kv=4) d_ff 10240 vocab 262144.

5:1 local(1024-window, θ=10k) : global(θ=1M) attention pattern, head_dim 256
(gemma family decouples head_dim from d_model), zero-centered RMSNorm,
gelu_tanh MLP. [hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    attn_pattern="local_global",
    local_window=1024,
    local_global_ratio=5,
    rope_theta=10000.0,
    rope_theta_global=1000000.0,
    qk_norm=True,
    zero_centered_norm=True,
    post_attn_norm=True,
    act="gelu_tanh",
    tie_embeddings=True,
    scan_layers=True,
    accum_steps=4,
)
