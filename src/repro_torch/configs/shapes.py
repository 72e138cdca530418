"""Assigned input-shape sets (one set shared by all 10 LM-family archs)."""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", "train", seq_len=4096, global_batch=256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", seq_len=32768, global_batch=32)
DECODE_32K = ShapeConfig("decode_32k", "decode", seq_len=32768, global_batch=128)
LONG_500K = ShapeConfig("long_500k", "decode", seq_len=524288, global_batch=1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Archs with a sub-quadratic long-context mechanism run long_500k; pure
# full-attention archs skip it (recorded as SKIP in the roofline table).
# See DESIGN.md §Arch-applicability for rationale.
LONG_CONTEXT_OK = {
    "rwkv6-1.6b",  # O(1) recurrent state
    "recurrentgemma-2b",  # RG-LRU + 2048-window local attention
    "mixtral-8x7b",  # SWA: KV bounded by window
    "gemma3-4b",  # 5:1 local(1024):global — designed-for-long-context
}


def shape_applicable(arch_name: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_name in LONG_CONTEXT_OK
    return True
