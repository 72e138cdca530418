"""Three-term roofline on an NVIDIA H100 SXM (80 GB HBM3) — the port of
``repro.runtime.roofline``.

  compute    = FLOPs_per_device / peak FLOP rate of the step's dtype
  memory     = bytes_per_device / HBM bandwidth
  collective = collective_wire_bytes_per_device / NVLink bandwidth

The counts come from `repro_torch.runtime.opcount` (what one rank's ops
do, with the ring factors of the reference's collective model). The
rates are the H100 SXM5 data sheet's (NVIDIA H100 Tensor Core GPU data
sheet), dense (no structured sparsity):
  - 989.4 TFLOP/s bf16 on the tensor cores (`PEAK_FLOPS`);
  - 67 TFLOP/s f32 outside the tensor cores (`PEAK_FLOPS_F32`): the rate
    of a GEMM with TF32 off, the port's parity rule, so every f32 cell
    (SimNet's; an LM computing in f32) divides by it (``peak_flops=``);
  - 3.35 TB/s HBM3 (`HBM_BW`);
  - NVLink 4: the sheet's 900 GB/s is both directions of a card's 18
    links together. The ring model counts the bytes a device sends,
    which its links carry in one direction, so `NVLINK_BW` is half of
    it, 450 GB/s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989.4e12  # bf16 dense, tensor cores, per card
PEAK_FLOPS_F32 = 67e12  # f32 without tensor cores (TF32 off), per card
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 450e9  # bytes/s per card and direction (900 GB/s both ways)


def peak_for(dtype_name: str) -> float:
    """The peak FLOP rate of a step computing in ``dtype_name``."""
    return PEAK_FLOPS_F32 if dtype_name in ("float32", "f32") else PEAK_FLOPS


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Step-time lower bound if terms overlap perfectly."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Step-time upper bound if nothing overlaps."""
        return self.compute_s + self.memory_s + self.collective_s

    def roofline_fraction(self) -> float:
        """Fraction of the dominant-resource bound actually achievable:
        bound / serial ∈ (1/3, 1]. 1.0 = the other two terms are free."""
        if self.serial_s == 0:
            return 0.0
        return self.bound_s / self.serial_s

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "serial_s": self.serial_s,
            "roofline_fraction": self.roofline_fraction(),
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
        }


def roofline(flops_per_device: float, bytes_per_device: float, collective_bytes: float,
             peak_flops: float = PEAK_FLOPS) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / peak_flops,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=collective_bytes / NVLINK_BW,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes,
    )


def sim_step_traffic(
    ctx_len: int,
    n_lanes: int,
    state_dtype_bytes: int = 4,
    n_feat: int = 41,
    n_addr: int = 5,
) -> Dict[str, float]:
    """Analytic HBM bytes per packed sim step for the simulator queue
    state, per layout — the term the ring buffer attacks.

    roll: every plane is read and rewritten each step (the shift-push
      moves all Q slots): 2 · L · Q · bytes(entry).
    ring: the feat/addr static planes are written at ONE slot and never
      read by the state update; the exec/store latency planes are still
      READ in full (retirement readiness compares) but written at one
      slot; the small bookkeeping planes (resid + valid/in_mw/is_store
      flags) still move in full:
      L · Q · (2 · bytes(bookkeeping) + bytes(latency)) + L · bytes(slot).

    Model-input assembly (predictor mode) reads O(L·Q·F) either way —
    unless the fused sim-step kernel assembles it on chip, which removes
    that read's round-trip too (see kernels/csrc/fused_step.cu).
    """
    static = n_feat * state_dtype_bytes + n_addr * 4  # write-only in ring
    lat = 2 * 4  # exec/store f32: full read, slot write
    book = 4 + 3 * 1  # resid f32 + valid/in_mw/is_store bools: full r/w
    roll = 2.0 * n_lanes * ctx_len * (static + lat + book)
    ring = n_lanes * ctx_len * (2.0 * book + lat) + n_lanes * (static + lat)
    return {
        "roll_bytes_per_step": roll,
        "ring_bytes_per_step": ring,
        "ratio": roll / ring,
        "roll_memory_s": roll / HBM_BW,
        "ring_memory_s": ring / HBM_BW,
    }


def model_flops(cfg, shape, n_devices: int) -> Dict[str, float]:
    """Useful-work model FLOPs: 6·N·D train, 2·N·D per decode step (N =
    active params). Returned per device, for the MODEL/counted ratio."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        total = 6.0 * n_active * shape.tokens
    elif shape.kind == "prefill":
        total = 2.0 * n_active * shape.tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return {"model_flops_total": total, "model_flops_per_device": total / n_devices}
