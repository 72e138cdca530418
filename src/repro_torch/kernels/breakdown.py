"""Where the trunk kernels' time goes, on the card.

Builds cut-down copies of K1 (``fused_step``) and K2 (``cnn_trunk``) from
the sources in ``csrc/`` and times each, with CUDA events over 20 launches,
at the main path's shape (1024 lanes, Q = 64, seq_padded 72) and at one
workload's 128 lanes:

  full          the kernels as they are
  stream_only   no FMAs: the tile's input, the weight slabs and their waits
  compute_only  (K2) the FMAs over the first slabs only: no weight traffic
                after the prologue

then samples the SM clock and the power draw while K2 runs back to back.
Run it on a machine with the card, from the root of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.breakdown

The copies are built under ``build/kernels/breakdown/``; the port never
loads them.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels import _build

FMA = "    slab_fma<TM, N>(arow, k0, w, min(ROWS, K - k0), acc);\n"
WAIT = "    const float* w = ring.wait() + cg * 4;\n"
RELEASE = "    ring.release();\n"
PRODUCE = "    for (int s = 0; s < total; ++s) {\n"
VARIANTS = {
    "full": [],
    "stream_only": [(FMA, "    if (w[0] == 1234.5f) acc[0][0] += 1.f;\n")],
    "compute_only": [
        (WAIT, "    if (ring.j < kSlots) ring.wait();\n"
               "    const float* w = ring.slots + (ring.j % kSlots) * kSlabFloats + cg * 4;\n"),
        (RELEASE, "    ++ring.j;\n"),
        (PRODUCE, "    for (int s = 0; s < total && s < kSlots; ++s) {\n"),
    ],
}
ARGS = {"fused_step": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        "cnn_trunk": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}


def build():
    """{(kernel, variant): C entry point}, one nvcc per library, all at once."""
    common = (_build.CSRC / "trunk_common.cuh").read_text()
    procs = {}
    for variant, edits in VARIANTS.items():
        text = common
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{variant}: trunk_common.cuh no longer has {old.strip()!r}")
            text = text.replace(old, new)
        d = _build.BUILD_DIR / "breakdown" / variant
        d.mkdir(parents=True, exist_ok=True)
        for src in _build.CSRC.glob("*.cu*"):
            shutil.copy(src, d / src.name)
        (d / "trunk_common.cuh").write_text(text)
        for kernel in ("fused_step", "cnn_trunk"):
            if kernel == "fused_step" and variant == "compute_only":
                continue
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / f"{kernel}.so"),
                   str(d / f"{kernel}.cu")]
            procs[kernel, variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True), d)
    entries = {}
    for (kernel, variant), (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} ({variant}):\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        stack = re.findall(r"(\d+) bytes stack frame", log)
        print(f"{kernel} {variant}: registers {regs}, stack {stack}", flush=True)
        fn = getattr(ctypes.CDLL(str(d / f"{kernel}.so")), f"{kernel}_launch")
        fn.argtypes, fn.restype = ARGS[kernel], ctypes.c_int
        entries[kernel, variant] = fn
    return entries


def time_us(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # keeps the card busy while the launches queue
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / iters


def ring_state(lanes, q=64, steps=100, seed=0):
    """A ring state of random instructions after ``steps`` steps, and the
    current instruction: (planes in the kernel's argument order)."""
    from repro_torch.core import simulator as sim

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cfg = sim.SimConfig(ctx_len=q)
    state = sim.init_state(lanes, cfg, dev)
    for _ in range(steps):
        feat = (rng.random((lanes, 41)) * (rng.random((lanes, 41)) < 0.3)).astype(np.float32)
        cur = {"feat": torch.from_numpy(feat).to(dev),
               "addr": torch.from_numpy(rng.integers(0, 20, (lanes, 5)).astype(np.int32)).to(dev),
               "is_store": torch.from_numpy(rng.random(lanes) < 0.3).to(dev)}
        lats = np.stack([rng.integers(0, 3, lanes), rng.integers(1, 48, lanes),
                         rng.integers(1, 64, lanes)], 1).astype(np.float32)
        state = sim.sim_step(state, cur, torch.from_numpy(lats).to(dev), cfg)
    return [t.contiguous() for t in (state.feat, state.addr, state.resid, state.exec_lat,
                                     state.store_lat, state.valid, state.head, cur["feat"],
                                     cur["addr"])]


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    entries = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    weights = [(torch.randn(2 * a, b, device="cuda", generator=g) * 0.1,
                torch.randn(b, device="cuda", generator=g) * 0.05)
               for a, b in ((50, 64), (64, 128), (128, 128))]
    w = [t.data_ptr() for wb in weights for t in wb]
    stream = torch.cuda.current_stream().cuda_stream
    for lanes in (1024, 128):
        x = torch.randn(lanes, 72, 50, device="cuda", generator=g)
        state = ring_state(lanes)  # held while the kernels read it
        planes = [p.data_ptr() for p in state]
        out = torch.empty(lanes, 9, 128, device="cuda")
        for (kernel, variant), fn in entries.items():
            if kernel == "cnn_trunk":
                args = (x.data_ptr(), *w, out.data_ptr(), lanes, 72, 50, 64, 128, 128, stream)
            else:
                args = (*planes, *w, out.data_ptr(), lanes, 64, 72, 64, 128, 128, stream)

            def run(fn=fn, args=args):
                if fn(*args):
                    raise RuntimeError("launch failed")

            print(f"L={lanes} {kernel} {variant}: {time_us(run):.1f} us", flush=True)

    full = entries["cnn_trunk", "full"]
    x = torch.randn(1024, 72, 50, device="cuda", generator=g)
    out = torch.empty(1024, 9, 128, device="cuda")
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader",
                            "-lms", "250"], stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < 3.0:
        for _ in range(200):
            full(x.data_ptr(), *w, out.data_ptr(), 1024, 72, 50, 64, 128, 128, stream)
        torch.cuda.synchronize()
    smi.terminate()
    samples = smi.communicate()[0].split("\n")
    print("cnn_trunk back to back for 3 s, SM clock and power every 250 ms:",
          " | ".join(s.strip() for s in samples if s.strip()))


if __name__ == "__main__":
    main()
