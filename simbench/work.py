"""The benchmark's yardstick of work: the peaks of the card, the FLOPs of one
prediction, and the FLOPs and bytes of one launch of the fused sim-step
kernel (K1, ``repro_torch/kernels/csrc/fused_step.cu``), counted from the
shapes alone. Frozen here, so a change to the program cannot move them.

FLOPs count a multiply and an add for every use of a weight. Bytes count
each input byte read once and each output byte written once.
"""
from __future__ import annotations

from simbench import reference as R

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense, no sparsity, at its
# 700 W power limit): float32 outside the tensor cores and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def flops_per_instruction(cfg: dict) -> float:
    """FLOPs of one prediction of a c1/c3 or rb* predictor: two times the
    paper's Table 4 count of multiply-accumulates (the port's
    ``core/predictor.py::inference_mflops``, copied)."""
    N, Fdim, total, kind = R.seq_padded(cfg), R.N_IN, 0.0, cfg["kind"]
    hidden, out = cfg["hidden"], R.out_dim(cfg)
    if kind in ("c1", "c3"):
        chans = [Fdim] + list(cfg["channels"][: int(kind[1])])
        n = N
        for i in range(len(chans) - 1):
            n //= 2
            total += n * 2 * chans[i] * chans[i + 1]
        total += n * chans[-1] * hidden + hidden * out
    else:
        c, n = cfg["channels"][-1], N // 2
        total += (N // 2) * 2 * Fdim * c
        for i in range(cfg["rb_blocks"]):
            total += n * c * 2 * c  # expand
            if i < R.n_stride2(cfg) - 1:
                total += (n // 2) * (4 * c) * (2 * c)
                n //= 2
            else:
                total += n * (4 * c) * (2 * c)
            total += n * 2 * c * c  # project
        total += n * c * hidden + hidden * out
    return 2.0 * total


def k1_work(cfg: dict, lanes: int) -> dict:
    """One K1 launch over ``lanes`` lanes of a c3 predictor: the model input
    assembled from the ring state and the three k2s2 conv layers. FLOPs:
    the three layers' products (the input assembly's few compares and
    multiplies left out). Bytes: the state planes it reads (static
    features f32, address keys i32, residence, execution and store
    latencies f32, valid bits), the current row (features, keys), the
    conv weights and biases, and the trunk's f32 output."""
    Q, C = cfg["ctx_len"], list(cfg["channels"][:3])
    n, c_in, flops, weights = R.seq_padded(cfg), R.N_IN, 0.0, 0
    for co in C:
        n //= 2
        flops += 2.0 * lanes * n * (2 * c_in) * co
        weights += (2 * c_in * co + co) * 4
        c_in = co
    planes = Q * (R.STATIC * 4 + R.N_ADDR * 4 + 3 * 4 + 1)
    current = R.STATIC * 4 + R.N_ADDR * 4
    output = n * C[-1] * 4
    return {"flops": flops, "bytes": float(lanes * (planes + current + output) + weights)}


def roofline_seconds(flops: float, nbytes: float) -> tuple:
    """(the least time the card could take, "flops" or "bytes": which
    peak bounds it)."""
    compute, memory = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (compute, "flops") if compute >= memory else (memory, "bytes")
