"""mixtral-8x7b [moe]: 32L d4096 32H (kv=8) d_ff 14336, 8 experts top-2, SWA.

Sliding-window attention (4096). TP-mode expert sharding (8 experts do not
divide the 16-way model axis). [arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    attn_pattern="swa",
    local_window=4096,
    rope_theta=1000000.0,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    moe_ep=False,  # 8 experts vs 16-way model axis → TP mode
    act="silu",
    tie_embeddings=False,
    scan_layers=True,
    accum_steps=8,
)
