"""The fused sim-step kernel's (K1, ``fused_step.cu``) share of its
roofline: the least time its counted work could take on the card (the
larger of FLOPs over the float32 peak and bytes over the HBM peak,
`simbench.work.k1_work` at the call's lanes) over its mean device time a
launch in the traced window. Nothing to read where K1 does not run."""
import sys

from simbench import work


def read(rec):
    times = [s for n, s in rec.get("kernels") or () if "fused_step" in n]
    if not times:
        return None
    w = work.k1_work(rec["cfg"]["predictor"], rec["lanes"])
    bound, by = work.roofline_seconds(w["flops"], w["bytes"])
    mean = sum(times) / len(times)
    print(f"k1: {len(times)} launches, mean {mean * 1e6:.3f} us; counted {w['flops']:.6g} FLOPs, "
          f"{w['bytes']:.6g} bytes a launch; bound {bound * 1e6:.3f} us by {by}", file=sys.stderr)
    return 100.0 * bound / mean
