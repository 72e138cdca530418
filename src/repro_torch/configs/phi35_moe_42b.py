"""phi3.5-moe-42b-a6.6b [moe]: 32L d4096 32H (kv=8) d_ff 6400, 16e top-2.

16 experts divide the 16-way model axis exactly → expert-parallel (EP)
sharding mode. [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    rope_theta=10000.0,
    n_experts=16,
    top_k=2,
    capacity_factor=1.25,
    moe_ep=True,  # 16 experts over 16-way model axis
    act="silu",
    tie_embeddings=False,
    scan_layers=True,
    accum_steps=8,
)
