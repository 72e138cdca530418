"""Input stand-ins and logical sharding for every step kind — the port of
``repro.launch.specs``.

Where the reference has ``jax.ShapeDtypeStruct``s, the port has tensors on
the ``meta`` device: a shape and a dtype, no storage. The dry run lowers
against these.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.nn.init import ShardSpec, shapes_only

N_PATCHES = 256  # vision stub: image patches occupying the sequence head


def sds(shape, dtype) -> torch.Tensor:
    """A shape and dtype stand-in: an empty ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Dict, Dict]:
    """(stand-ins, logical axes) for the forward/prefill batch."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": sds((B, S), torch.int32)}
    axes = {"tokens": ShardSpec(("batch", None))}
    if shape.kind == "train":
        specs["loss_mask"] = sds((B, S), torch.float32)
        axes["loss_mask"] = ShardSpec(("batch", None))
    if cfg.family == "encdec":
        specs["frames"] = sds((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
        axes["frames"] = ShardSpec(("batch", None, None))
    if cfg.frontend == "vision_stub":
        specs["patches"] = sds((B, N_PATCHES, cfg.frontend_dim), torch.bfloat16)
        axes["patches"] = ShardSpec(("batch", None, None))
        specs["mrope_positions"] = sds((3, B, S), torch.int32)
        axes["mrope_positions"] = ShardSpec((None, "batch", None))
    return specs, axes


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The family's decode state for ``shape`` on the meta device (no
    allocation)."""
    from repro_torch.models.registry import build_model

    return build_model(cfg).init_decode_state(shape.global_batch, shape.seq_len, device="meta")


def decode_state_axes(cfg: ModelConfig, state_shapes=None):
    """Logical axes tree matching the decode state structure. The dense,
    MoE and VLM families' is `repro_torch.models.lm.state_logical_axes`."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.lm import state_logical_axes

        return state_logical_axes(cfg)
    if cfg.family == "rwkv":
        return {
            "wkv": ShardSpec(("layers", "batch", "heads", None, None)),
            "x_tm": ShardSpec(("layers", "batch", None)),
            "x_cm": ShardSpec(("layers", "batch", None)),
            "pos": ShardSpec(()),
        }
    if cfg.family == "encdec":
        return {
            "k": ShardSpec(("layers", "batch", "kvseq", None, None)),
            "v": ShardSpec(("layers", "batch", "kvseq", None, None)),
            "ck": ShardSpec(("layers", "batch", None, None, None)),
            "cv": ShardSpec(("layers", "batch", None, None, None)),
            "pos": ShardSpec(()),
        }
    if cfg.family == "hybrid":
        axes = {"pos": ShardSpec(())}
        for i in range(cfg.n_layers):
            if cfg.is_attn_layer(i):
                axes[f"layer_{i}"] = {
                    "k": ShardSpec(("batch", "kvseq", None, None)),
                    "v": ShardSpec(("batch", "kvseq", None, None)),
                }
            else:
                axes[f"layer_{i}"] = {
                    "h": ShardSpec(("batch", None)),
                    "conv": ShardSpec(("batch", None, None)),
                }
        return axes
    raise ValueError(cfg.family)


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig):
    return sds((shape.global_batch,), torch.int32), ShardSpec(("batch",))


def param_shapes_and_specs(model, generator=None, masters: bool = False):
    """The params as meta tensors (``model.init`` under `shapes_only`: no
    draw, no storage for the weights) and their ShardSpec tree.
    ``masters``: the f32 leaves a train step takes (``init(masters=True)``)
    instead of the stored dtypes a server holds."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    with shapes_only():
        shapes = model.init(generator, device="meta", masters=masters)
    return shapes, model.param_specs()
