"""whisper-large-v3 [audio]: 32L d1280 20H (kv=20, MHA) d_ff 5120 vocab 51866.

Encoder-decoder; the conv/mel frontend is a STUB — input_specs() supplies
precomputed frame embeddings (B, 1500, 1280). 32 encoder + 32 decoder layers.
Decode shapes treat seq_len as decoder-side KV length (structural exercise
beyond the real 448-position decoder — noted in DESIGN.md).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    is_encdec=True,
    n_enc_layers=32,
    enc_seq=1500,
    frontend="audio_stub",
    frontend_dim=1280,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    scan_layers=True,
    accum_steps=2,
)
