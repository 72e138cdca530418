"""Config dataclasses: model geometry, shapes, mesh, run knobs."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- attention structure ---
    attn_pattern: str = "global"  # global | local_global | swa | rec_attn
    local_window: int = 0  # sliding-window size for local/swa layers
    local_global_ratio: int = 0  # N local layers per 1 global (gemma3: 5)
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0  # separate theta for global layers (gemma3)
    qk_norm: bool = False
    logit_cap: float = 0.0
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    moe_ep: bool = False  # expert-parallel sharding (needs E % model_axis == 0)

    # --- recurrent (rwkv / rglru) ---
    rnn_width: int = 0  # d_rnn for RG-LRU branch
    rnn_heads: int = 0  # rwkv heads / rglru block count
    conv_width: int = 4
    rec_pattern: int = 0  # recurrentgemma: layers i with i % (p+1) == p are attn

    # --- encoder-decoder / frontends ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500  # stub frontend length (whisper mel frames / patches)
    frontend: str = "none"  # none | audio_stub | vision_stub
    frontend_dim: int = 0  # stub embedding dim (== d_model after proj)

    # --- numerics & lowering structure ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    zero_centered_norm: bool = False  # gemma-style (1 + g)
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    tie_embeddings: bool = True
    scan_layers: bool = True
    remat: str = "full"  # none | full
    post_attn_norm: bool = False  # gemma3 sandwich norms

    # --- training knobs (perf hillclimb levers) ---
    accum_steps: int = 1  # gradient-accumulation microbatches
    seq_shard_activations: bool = True  # SP on residual stream
    pre_cast_params: bool = False  # cast block params to bf16 BEFORE the
    # layer scan so FSDP all-gathers move half the bytes (§Perf)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, padded to 128 for TP sharding / MXU lanes
        (whisper's 51866 is not 16-divisible; pad logits are masked)."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_window(self, i: int) -> int:
        """Static per-layer sliding window (0 = full attention)."""
        if self.attn_pattern == "swa":
            return self.local_window
        if self.attn_pattern == "local_global":
            cycle = self.local_global_ratio + 1
            return 0 if (i % cycle == self.local_global_ratio) else self.local_window
        return 0

    def is_attn_layer(self, i: int) -> bool:
        """For hybrid archs: which layers are attention vs recurrent."""
        if self.family != "hybrid":
            return self.family != "rwkv"
        p = self.rec_pattern
        return i % (p + 1) == p

    def n_params(self) -> float:
        """Approximate parameter count (for 6ND model-flops accounting)."""
        d, f, L, v = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.attn_dim * 2 + d * self.kv_dim * 2
        if self.family == "rwkv":
            per_layer = 5 * d * d + d * f * 2 + d * d
        elif self.family == "hybrid":
            n_attn = sum(1 for i in range(L) if self.is_attn_layer(i))
            n_rec = L - n_attn
            rec = 3 * d * self.rnn_width + self.rnn_width * d
            per_layer = 3 * d * f  # mlp everywhere
            return v * d + n_attn * (attn + per_layer) + n_rec * (rec + per_layer)
        elif self.family == "moe":
            per_layer = attn + self.n_experts * 3 * d * f
        else:
            per_layer = attn + 3 * d * f
        return v * d + L * per_layer

    def n_active_params(self) -> float:
        """Active params per token (MoE uses top_k experts)."""
        if self.family != "moe":
            return self.n_params()
        d, f, L, v = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.attn_dim * 2 + d * self.kv_dim * 2
        return v * d + L * (attn + self.top_k * 3 * d * f)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    base = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family in ("hybrid",) else 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_group_size=64,
        rnn_width=128 if cfg.rnn_width else 0,
        rnn_heads=4 if cfg.rnn_heads else 0,
        local_window=min(cfg.local_window, 32) if cfg.local_window else 0,
        enc_seq=16 if cfg.is_encdec or cfg.frontend != "none" else cfg.enc_seq,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        frontend_dim=128 if cfg.frontend_dim else 0,
        scan_layers=cfg.scan_layers,
        accum_steps=1,
    )
    if cfg.family == "hybrid":
        base["n_layers"] = 6  # two full (R,R,A) cycles
    if cfg.mrope:
        half = base["head_dim"] // 2
        t = half // 4
        hw = (half - t) // 2
        base["mrope_sections"] = (t, hw, half - t - hw)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
