"""Where the time of the hand-written kernels goes, on the card.

Builds cut-down copies of K1 (``fused_step``), K2 (``cnn_trunk``), K3
(``conv2s``) and K4 (``decode_attn``) from the sources in ``csrc/`` and
times each, with CUDA events over 20 launches. K1/K2 at the main path's
shape (1024 lanes, Q = 64, seq_padded 72) and at one workload's 128 lanes;
K3 at the three C3 layers at 1024 lanes ((1024, 72, 50) -> 64,
(1024, 36, 64) -> 128, (1024, 18, 128) -> 128); K4 at gemma3-4b's decode
shape (both windows) and at each other family's, in bf16; the wkv pair
(``wkv_fwd``, ``wkv_bwd``) at rwkv6-1.6b's training shape:

  full          the kernels as they are
  stream_only   no FMAs: (K1/K2) the tile's input, the weight slabs and
                their waits; (K3) the input tiles, the weights and the
                stores; (K4) no MMAs and no softmax: the copy ring, its
                waits and releases, and the merges and stores
  ring_only     (K4) stream_only without the merge of the splits
  bulk_rows_ring_only  (K4) ring_only with one bulk copy (cp.async.bulk)
                a K or V row filling the ring instead of 16 bytes a lane
  compute_only  (K2) the FMAs over the first slabs only: no weight traffic
                after the prologue; (K3) the FMAs and the stores, with no
                input tile copied or waited for
  fwd_*, bwd_*  (wkv) without: the y reduction's shuffles, the chunk loads
                after the prologue, the steps, y's stores (forward); the
                history's recomputation, the steps, the row and column
                sums' shuffles, the loads, the other blocks' gv partials
                (the block's own read in their place), gv's sums over the
                cluster (backward); and the forward saving no states

then samples the SM clock and the power draw while K2, then K3 at the
first layer, run back to back. Run it on a machine with the card, from the
root of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.breakdown [decode_attn | wkv]

(``decode_attn``: K4's parts alone; ``wkv``: the wkv pair's.)

The copies are built under ``build/kernels/breakdown/``; the port never
loads them.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.kernels import _build

FMA = "    slab_fma<TM, N>(arow, k0, w, min(ROWS, K - k0), acc);\n"
WAIT = "    const float* w = ring.wait() + cg * 4;\n"
RELEASE = "    ring.release();\n"
PRODUCE = "    for (int s = 0; s < total; ++s) {\n"
K3_FMA = "    slab_fma<TM, NP>(arow, k0, w + cg * 4, min(S::kSlabRows, K - k0), acc);\n"
K3_COPY = ("    bulk_load(sm.slots + slot * p.slot_floats, p.x + a * p.K, (unsigned)(n_rows * p.K * 4),\n"
           "              &sm.full[slot]);\n")
K3_WAIT = "      mbar_wait(&sm.full[slot], use & 1);\n"
K4_NO_MATH = ("      if (n_live > 0) {\n", "      if (n_live > (1 << 30)) {  // no MMAs, no softmax\n")
K4_NO_MERGE = ("  if (a.n_splits == 1) return;\n", "  return;  // no merge of the splits\n")
# K4's stages by one bulk copy (cp.async.bulk) a K or V row instead of 16
# bytes a lane (the redesign's first ring): the slot's full barrier takes
# one arrival and the rows' bytes; V rows past the live range zeroed
K4_BULK_ROWS = [
    ("        sm90::mbar_init(&full[s], 32);\n", "        sm90::mbar_init(&full[s], 1);\n"),
    ("""#pragma unroll 4
  for (int i = lane; i < TP * Sh::kChunks; i += 32) {
    const int r = i / Sh::kChunks, c = i % Sh::kChunks;
    const bool in = r < rows;
    const size_t off = ((((size_t)b * a.S + p0 + (in ? r : 0)) * a.KV + kv) * HD) * sizeof(T) + c * 16;
    cp_async16(k_d + r * ROW + c * 16, reinterpret_cast<const char*>(a.k) + off, in);
    cp_async16(v_d + r * ROW + c * 16, reinterpret_cast<const char*>(a.v) + off, in);
  }
  cp_async_arrive(&full[slot]);
""", """  for (int i = rows * Sh::kChunks + lane; i < TP * Sh::kChunks; i += 32) {
    *reinterpret_cast<uint4*>(v_d + (i / Sh::kChunks) * ROW + (i % Sh::kChunks) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  sm90::fence_async_shared();
  __syncwarp();
  if (lane == 0) sm90::mbar_expect_tx(&full[slot], 2u * rows * HD * sizeof(T));
  __syncwarp();
  for (int r = lane; r < rows; r += 32) {
    const size_t off = (((size_t)b * a.S + p0 + r) * a.KV + kv) * HD;
    sm90::bulk_copy(k_d + r * ROW, a.k + off, HD * sizeof(T), &full[slot]);
    sm90::bulk_copy(v_d + r * ROW, a.v + off, HD * sizeof(T), &full[slot]);
  }
"""),
]
# the wkv pair's parts (csrc/wkv.cu)
WKV_FWD_SUM = ("  reduce_lanes<kCJ, P::RT / 2, ilog2(P::RT)>(acc, lane);\n  return acc[0];\n",
               "  float z = 0.f;  // no shuffles: the tile's y partials summed in the lane\n"
               "  for (int p = 0; p < kCJ; ++p) z += acc[p];\n  return z;\n")
WKV_FWD_NO_LOADS = [("    sm90::mbar_wait(&full[s], (c / P::STAGES) & 1);\n",
                     "    if (c < P::STAGES) sm90::mbar_wait(&full[s], 0);\n"),
                    ("    if (c + P::STAGES < chunks) {\n",
                     "    if (c + P::STAGES < 0) {  // no loads after the prologue\n")]
WKV_FWD_NO_STEPS = ("      for (int tt = 0; tt < kC; ++tt) yt[tt] = fwd_step<HD>(S, uu, x, tt, i0, j0, lane);\n",
                    "      for (int tt = 0; tt < kC; ++tt) yt[tt] = x[tt * HD + i0] + S[0][0];\n")
WKV_FWD_NO_Y = ("        for (int tt = 0; tt < kC; ++tt) yc[tt * stride] = yt[tt];\n",
                "        for (int tt = 0; tt < kC; ++tt) if (yt[tt] == 1234.5f) yc[tt * stride] = yt[tt];\n")
WKV_BWD_NO_RECOMPUTE = ("      bwd_recompute<HD>(S, x, hist + tid, lo, hi, i0, j0);\n", "")
WKV_BWD_NO_STEPS = (
    "          bwd_step<HD>(G, uu, x, hist + tid, lo, hi - 1 - e, i0, j0, sum0, lane, outs[e], gu_acc, gvr[e]);\n",
    "          for (int s = 0; s < P::HELD; ++s) outs[e][s] = G[0][0] + x[e];\n"
    "          for (int s = 0; s < P::GV_HELD; ++s) gvr[e][s] = G[0][1];\n")
WKV_BWD_SUMS = [
    ("  reduce_lanes<P::SUMS, CT / 2, ilog2(CT)>(sums, lane);\n",
     "  for (int s = P::HELD; s < P::SUMS; ++s) sums[s % P::HELD] += sums[s];  // no shuffles\n"),
    ("  d = __shfl_sync(kFull, sums[0], 3 * kRI * CT / P::SUMS, CT);\n", "  d = sums[0];\n"),
    ("  reduce_lanes<kCJ, 16, ilog2(P::RTW)>(e, lane);\n",
     "  for (int p = P::GV_HELD; p < kCJ; ++p) e[p % P::GV_HELD] += e[p];\n")]
WKV_BWD_NO_LOADS = [
    ("    sm90::mbar_wait(&full[s], (n >> 1) & 1);\n", "    if (n < 2) sm90::mbar_wait(&full[s], 0);\n"),
    ("    bool refill = n >= 1 && n + 1 < chunks;", "    bool refill = false;"),
    ("      if (half == 0 && n + 1 < chunks) load_tile(", "      if (half == 0 && n + 1 < 0) load_tile(")]
WKV_BWD_NO_GV_SUMS = ("  for (int e = tid; e < steps * COLS; e += P::THREADS) {\n",
                      "  for (int e = tid; e < 0; e += P::THREADS) {\n")
WKV_BWD_NO_DSMEM = ("      const float* src = cluster.map_shared_rank(parts, q);\n",
                    "      const float* src = parts;\n")
# source edited -> {variant: [(old line, new line)]}, and the kernels built from it
VARIANTS = {
    "trunk_common.cuh": ({
        "full": [],
        "stream_only": [(FMA, "    if (w[0] == 1234.5f) acc[0][0] += 1.f;\n")],
        "compute_only": [
            (WAIT, "    if (ring.j < kSlots) ring.wait();\n"
                   "    const float* w = ring.slots + (ring.j % kSlots) * kSlabFloats + cg * 4;\n"),
            (RELEASE, "    ++ring.j;\n"),
            (PRODUCE, "    for (int s = 0; s < total && s < kSlots; ++s) {\n"),
        ],
    }, ("fused_step", "cnn_trunk")),
    "conv2s.cu": ({
        "full": [],
        "stream_only": [(K3_FMA, "    if (load_a4(arow[0], k0).x == 1234.5f) acc[0][0] += 1.f;\n")],
        "compute_only": [(K3_COPY, ""), (K3_WAIT, "")],
    }, ("conv2s",)),
    "decode_attn.cu": ({
        "full": [],
        "stream_only": [K4_NO_MATH],
        "ring_only": [K4_NO_MATH, K4_NO_MERGE],
        "bulk_rows_ring_only": [K4_NO_MATH, K4_NO_MERGE] + K4_BULK_ROWS,
    }, ("decode_attn",)),
    "wkv.cu": ({
        "full": [],
        "fwd_no_shuffles": [WKV_FWD_SUM],
        "fwd_no_loads": WKV_FWD_NO_LOADS,
        "fwd_no_steps": [WKV_FWD_NO_STEPS],
        "fwd_no_y_stores": [WKV_FWD_NO_Y],
        "bwd_no_recompute": [WKV_BWD_NO_RECOMPUTE],
        "bwd_no_steps": [WKV_BWD_NO_STEPS],
        "bwd_no_shuffles": WKV_BWD_SUMS,
        "bwd_no_loads": WKV_BWD_NO_LOADS,
        "bwd_no_dsmem": [WKV_BWD_NO_DSMEM],
        "bwd_no_gv_sums": [WKV_BWD_NO_GV_SUMS],
    }, ("wkv_fwd", "wkv_bwd")),
}
ARGS = {name: argtypes for name, (_, _, argtypes) in _build.KERNELS.items()}
K3_LAYERS = ((72, 50, 64), (36, 64, 128), (18, 128, 128))  # (N, C, Co) at 1024 lanes
# K4: (what, B, S, H, KV, hd, cache_len, window), each family's decode shape
# in chip_smoke.py (8 requests; 2048-token prompts + 64 steps, whisper 64 + 64)
K4_SHAPES = (("gemma3-4b global", 8, 2112, 8, 4, 256, 2112, 0),
             ("gemma3-4b local", 8, 2112, 8, 4, 256, 2112, 1024),
             ("mixtral-8x7b", 8, 2112, 32, 8, 128, 2049, 0),
             ("qwen2-vl-72b", 8, 2112, 64, 8, 128, 2049, 0),
             ("recurrentgemma-2b", 8, 2048, 10, 1, 256, 2048, 0),
             ("whisper-large-v3", 8, 128, 20, 20, 64, 65, 0))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def build(sources=tuple(VARIANTS)):
    """{(kernel, variant): C entry point} for the variants of ``sources``, one
    nvcc per library, all at once."""
    procs = {}
    for source in sources:
        variants, kernels = VARIANTS[source]
        original = (_build.CSRC / source).read_text()
        for variant, edits in variants.items():
            text = original
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{variant}: {source} no longer has {old.strip()!r}")
                text = text.replace(old, new)
            d = _build.BUILD_DIR / "breakdown" / source.split(".")[0] / variant
            d.mkdir(parents=True, exist_ok=True)
            for src in _build.CSRC.glob("*.cu*"):
                shutil.copy(src, d / src.name)
            (d / source).write_text(text)
            # a .cu source holds its kernels; a header's are in their own sources
            units = ({source.split(".")[0]: kernels} if source.endswith(".cu") else
                     {kernel: (kernel,) for kernel in kernels})
            for unit, held in units.items():
                if unit == "fused_step" and variant == "compute_only":
                    continue
                cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / f"{unit}.so"),
                       str(d / f"{unit}.cu")]
                procs[unit, variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True), d, held)
    entries = {}
    for (unit, variant), (proc, d, held) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {unit} ({variant}):\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        stack = re.findall(r"(\d+) bytes stack frame", log)
        print(f"{unit} {variant}: registers {regs}, stack {stack}", flush=True)
        lib = ctypes.CDLL(str(d / f"{unit}.so"))
        for kernel in held:
            fn = getattr(lib, _build.KERNELS[kernel][1])
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


def checked(fn, args):
    def run():
        if fn(*args):
            raise RuntimeError("launch failed")
    return run


def clock_and_power(what, run, seconds=3.0):
    """Runs ``run`` (200 launches a call) back to back for ``seconds`` while
    nvidia-smi samples the SM clock and the power draw every 250 ms."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader",
                            "-lms", "250"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.time()
        while time.time() - t0 < seconds:
            run()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
    samples = smi.communicate()[0].split("\n")
    print(f"{what} back to back for {seconds:.0f} s, SM clock and power every 250 ms:",
          " | ".join(s.strip() for s in samples if s.strip()), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    if argv == ["decode_attn"]:
        decode_parts(build(("decode_attn.cu",)), g, torch.cuda.current_device(), stream)
        return
    if argv == ["wkv"]:
        wkv_parts(build(("wkv.cu",)), g, torch.cuda.current_device(), stream)
        return
    entries = build()
    weights = [(torch.randn(2 * a, b, device="cuda", generator=g) * 0.1,
                torch.randn(b, device="cuda", generator=g) * 0.05)
               for a, b in ((50, 64), (64, 128), (128, 128))]
    w = [t.data_ptr() for wb in weights for t in wb]
    for lanes in (1024, 128):
        x = torch.randn(lanes, 72, 50, device="cuda", generator=g)
        state = ring_state(lanes)  # held while the kernels read it
        planes = [p.data_ptr() for p in state]
        out = torch.empty(lanes, 9, 128, device="cuda")
        for (kernel, variant), fn in entries.items():
            if kernel == "cnn_trunk":
                args = (x.data_ptr(), *w, out.data_ptr(), lanes, 72, 50, 64, 128, 128, stream)
            elif kernel == "fused_step":
                args = (*planes, *w, out.data_ptr(), lanes, 64, 72, 64, 128, 128, stream)
            else:
                continue
            print(f"L={lanes} {kernel} {variant}: {time_us(checked(fn, args)):.1f} us", flush=True)

    dev = torch.cuda.current_device()
    k3_args = []
    for (n, c, co), (wl, bl) in zip(K3_LAYERS, weights):
        x = torch.randn(1024, n, c, device="cuda", generator=g)
        out = torch.empty(1024, n // 2, co, device="cuda")
        k3_args.append(((x, out), (x.data_ptr(), wl.data_ptr(), bl.data_ptr(), out.data_ptr(),
                                   1024, n, c, co, dev, stream)))
        for variant in VARIANTS["conv2s.cu"][0]:
            fn = entries["conv2s", variant]
            print(f"conv2s (1024, {n}, {c}) -> {co} {variant}: "
                  f"{time_us(checked(fn, k3_args[-1][1])):.1f} us", flush=True)

    full = entries["cnn_trunk", "full"]
    x = torch.randn(1024, 72, 50, device="cuda", generator=g)
    out = torch.empty(1024, 9, 128, device="cuda")
    trunk_run = checked(full, (x.data_ptr(), *w, out.data_ptr(), 1024, 72, 50, 64, 128, 128, stream))
    clock_and_power("cnn_trunk", lambda: [trunk_run() for _ in range(200)])
    k3_run = checked(entries["conv2s", "full"], k3_args[0][1])
    clock_and_power("conv2s (1024, 72, 50) -> 64", lambda: [k3_run() for _ in range(200)])
    decode_parts(entries, g, dev, stream)
    wkv_parts(entries, g, dev, stream)


def wkv_parts(entries, g, dev, stream):
    """The wkv pair's variants at rwkv6-1.6b's training shape (B 4, T 1024,
    H 32, hd 64): the forward saving the states, and the backward."""
    from repro_torch.kernels import ops

    B, T, H, hd = 4, 1024, 32, 64
    r, k, v, gy = (torch.randn(B, T, H, hd, device="cuda", generator=g) for _ in range(4))
    w = torch.exp(-torch.exp(torch.randn(B, T, H, hd, device="cuda", generator=g) - 2.5))
    u = torch.randn(H, hd, device="cuda", generator=g) * 0.5
    s0, gs = (torch.randn(B, H, hd, hd, device="cuda", generator=g) for _ in range(2))
    ckpt = torch.empty(ops.wkv_checkpoints_shape(B, T, H, hd), device="cuda")
    y, s_out, gs0 = torch.empty_like(r), torch.empty_like(s0), torch.empty_like(s0)
    grads = [torch.empty_like(r) for _ in range(4)]
    gu_part = torch.empty(B, H, hd, device="cuda")
    ins = [t.data_ptr() for t in (r, k, v, w, u, s0)]
    line = [f"wkv at B {B}, T {T}, H {H}, hd {hd}"]
    for variant in VARIANTS["wkv.cu"][0]:
        fwd = (*ins, y.data_ptr(), s_out.data_ptr(), ckpt.data_ptr(), B, T, H, hd, dev, stream)
        bwd = (*ins[:5], ckpt.data_ptr(), gy.data_ptr(), gs.data_ptr(), *(t.data_ptr() for t in grads),
               gu_part.data_ptr(), gs0.data_ptr(), B, T, H, hd, dev, stream)
        times = []
        if not variant.startswith("bwd"):
            times.append(f"wkv_fwd {time_us(checked(entries['wkv_fwd', variant], fwd)):.1f} us")
        if variant == "full":  # the forward that saves no states, as a prefill calls it
            no_saves = (*fwd[:8], None, *fwd[9:])
            times.append(f"wkv_fwd saving no states "
                         f"{time_us(checked(entries['wkv_fwd', variant], no_saves)):.1f} us")
        if not variant.startswith("fwd"):
            times.append(f"wkv_bwd {time_us(checked(entries['wkv_bwd', variant], bwd)):.1f} us")
        line.append(f"{variant}: " + ", ".join(times))
    print("; ".join(line), flush=True)


def decode_parts(entries, g, dev, stream):
    """K4 full vs its ring alone at each family's shape, in bf16: time, the
    fraction of the byte bound (each K/V byte of the live range, q and the
    output once) and of 3.35 TB/s that the live K/V alone reach."""
    from repro_torch.kernels import ops

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, B, S, H, KV, hd, cache_len, window in K4_SHAPES:
        q = torch.randn(B, H, hd, device="cuda", generator=g).to(torch.bfloat16)
        k, v = (torch.randn(B, S, KV, hd, device="cuda", generator=g).to(torch.bfloat16)
                for _ in range(2))
        cl = torch.tensor(cache_len, dtype=torch.int32, device="cuda")
        plan = ops.decode_plan(B, S, H, KV, hd, 2, sms)
        live = min(cache_len, S) if window == 0 else min(window, cache_len, S)
        kv_bytes = 2 * B * live * KV * hd * 2
        n_bytes = kv_bytes + 2 * q.nbytes + 4
        line = [f"decode_attn {what}: q {tuple(q.shape)}, k/v {tuple(k.shape)}, {live} live, plan "
                f"{plan.splits} splits x {B * KV * plan.row_groups} = {plan.blocks} blocks, "
                f"{plan.stages} stages of {plan.tile}, {plan.smem_bytes} B smem; bound "
                f"{1e6 * n_bytes / PEAK_BYTES_PER_S:.1f} us"]
        out = torch.empty_like(q)
        tickets = torch.zeros(B * KV * plan.row_groups, dtype=torch.int32, device="cuda")
        part_ml = torch.empty(B, H, plan.splits, 2, device="cuda")
        part_acc = torch.empty(B, H, plan.splits, hd, device="cuda")
        for variant in VARIANTS["decode_attn.cu"][0]:
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(), part_ml.data_ptr(),
                    part_acc.data_ptr(), tickets.data_ptr(), out.data_ptr(), None, B, S, H, KV, hd,
                    1, window, 0, S, plan.splits, plan.stages, plan.rt, plan.row_groups,
                    plan.smem_bytes, dev, stream)
            us = time_us(checked(entries["decode_attn", variant], args))
            rate = kv_bytes / (us * 1e-6)  # bytes a second
            line.append(f"{variant} {us:.2f} us ({100 * 1e6 * n_bytes / PEAK_BYTES_PER_S / us:.1f}% of "
                        f"the bound, live K/V at {rate / 1e9:.0f} GB/s = "
                        f"{100 * rate / PEAK_BYTES_PER_S:.1f}% of 3.35 TB/s)")
        print("; ".join(line), flush=True)


if __name__ == "__main__":
    main()
