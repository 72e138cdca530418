"""Shape bucketing of the engine's packs (the pure functions of the
reference's ``repro.serving.compile_cache``). The port has no program
cache yet: PyTorch runs eagerly, so there is no compiled chunk to reuse."""
from __future__ import annotations


def lane_bucket(n_lanes: int) -> int:
    """Round a lane count up to the next power of two (min 1)."""
    if n_lanes < 1:
        raise ValueError(f"need at least one lane, got {n_lanes}")
    return 1 << (n_lanes - 1).bit_length()


def chunk_bucket(n_steps: int, max_chunk: int) -> int:
    """Streaming chunk for a pack of ``n_steps``: the next power of two,
    capped at ``max_chunk``. Short packs pay a little padding (inactive
    masked steps) in exchange for shape reuse across trace lengths."""
    if n_steps < 1 or max_chunk < 1:
        raise ValueError(f"need positive steps/chunk, got {n_steps}/{max_chunk}")
    return min(1 << (n_steps - 1).bit_length(), max_chunk)
