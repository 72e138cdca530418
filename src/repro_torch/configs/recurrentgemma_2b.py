"""recurrentgemma-2b [hybrid]: 26L d2560 10H (kv=1, MQA) d_ff 7680 vocab 256000.

Griffin: repeating (Recurrent, Recurrent, Attention) — 1 local-attention
layer per 2 RG-LRU layers; local window 2048; head_dim 256.
[arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    attn_pattern="rec_attn",
    local_window=2048,
    rec_pattern=2,  # layers i with i % 3 == 2 are attention
    rnn_width=2560,
    rnn_heads=10,
    conv_width=4,
    zero_centered_norm=True,
    act="gelu_tanh",
    tie_embeddings=True,
    scan_layers=False,  # hybrid layer mix → unrolled (26 small layers)
    accum_steps=2,
)
