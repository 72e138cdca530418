"""The whole simulation's share of the card's float32 peak: the FLOPs of
one prediction (`simbench.work.flops_per_instruction`) times the
instructions simulated in the traced window, over the window's seconds on
the profiler's clock and 67 TFLOP/s."""
from simbench import work


def read(rec):
    if not rec.get("window_s"):
        return None
    flops = work.flops_per_instruction(rec["cfg"]["predictor"]) * rec["instructions"]
    return 100.0 * flops / rec["window_s"] / work.PEAK_F32_FLOPS
