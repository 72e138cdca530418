#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card
at the main path's shapes, checks teacher-forced exactness, and drives the
main path — a pack of C3-predicted workloads through
``SimNetEngine.simulate_many`` — counting the kernel launches it makes.
Any failed check raises, so the exit code is non-zero. Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.

The last two lines of standard output are one JSON object per kernel
measured (``{"kernels": [...]}``) and the verdict
(``{"ok": true, "device": {...}}``).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
L, Q = 1024, 64  # main path's lanes and context length (the c3 default)
RTOL = ATOL = 1e-4  # kernel vs plain on the card: sums run in another order
PRED_RTOL = 1e-3  # kernel vs plain engine totals: an argmax near-tie may flip
# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TF_BENCHES = (("mlb_mixed", 12000), ("sim_loop", 8000), ("mlb_stream", 8000))
PRED_BENCHES = ("mlb_stream", "mlb_compute", "mlb_branchy", "mlb_mixed",
                "sim_chase", "sim_loop", "sim_branchy_hard", "sim_phased")
PRED_LANES, PRED_STEPS = 128, 256  # per workload: 8 x 128 = 1024 live lanes


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    log(f"  ok: {what}")


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. A spin
    kernel queued first keeps the card busy while the host enqueues the
    calls, so the host's launch cost does not show up as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_ops):
    """Least time (ms) the card could take: bytes over the memory rate vs
    f32 operations over the f32 peak, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def trunk_ops(n_lanes, seq, chans):
    """Multiply-adds x 2 of the three k2s2 layers (unpadded channels)."""
    ops, rows = 0, seq
    for c_in, c_out in zip(chans[:-1], chans[1:]):
        rows //= 2
        ops += 2 * n_lanes * rows * 2 * c_in * c_out
    return ops


def populated_state(torch, sim, dev, steps=300):
    """A ring state after ``steps`` teacher-forced steps of random
    instructions (long latencies, so the queues fill and overflow)."""
    import numpy as np

    from repro_torch.core import features as F

    rng = np.random.default_rng(SEED)
    cfg = sim.SimConfig(ctx_len=Q)
    state = sim.init_state(L, cfg, dev)
    for _ in range(steps):
        is_store = rng.random(L) < 0.3
        feat = (rng.random((L, F.STATIC_END)) * (rng.random((L, F.STATIC_END)) < 0.3)).astype(np.float32)
        feat[:, 7] = is_store
        cur = {
            "feat": torch.from_numpy(feat).to(dev),
            "addr": torch.from_numpy(rng.integers(0, 20, (L, F.N_ADDR_KEYS)).astype(np.int32)).to(dev),
            "is_store": torch.from_numpy(is_store).to(dev),
        }
        lats = np.stack([rng.integers(0, 3, L), rng.integers(1, 48, L), rng.integers(1, 64, L)], 1)
        state = sim.sim_step(state, cur, torch.from_numpy(lats.astype(np.float32)).to(dev), cfg)
    return state, cur


def compare(torch, name, out, want):
    err = (out - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    nonzero = float((want != 0).float().mean())
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(rtol={RTOL}, atol={ATOL}); plain output mean |y|={float(want.abs().mean()):.4f}, "
        f"nonzero share={nonzero:.3f}")
    check(bool(torch.isfinite(out).all()) and out.shape == want.shape, f"{name} finite, shape {tuple(out.shape)}")
    check(nonzero > 0.1, f"{name} output is not degenerate (ReLU leaves {nonzero:.3f} nonzero)")
    check(torch.allclose(out, want, rtol=RTOL, atol=ATOL), f"{name} matches its plain version")
    return max_abs


def kernel_phase(torch, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import simulator as sim
    from repro_torch.core.predictor import PredictorConfig, init_predictor
    from repro_torch.kernels import ops, ref

    log(f"[3] kernels vs plain versions (L={L}, Q={Q}, c3 default widths)")
    pcfg = PredictorConfig()
    params = init_predictor(torch.Generator().manual_seed(SEED), pcfg, dev)
    conv = [params[f"conv{i}"] for i in range(3)]
    layers = [(p["w"], p["b"]) for p in conv]
    state, cur = populated_state(torch, sim, dev)
    S = pcfg.seq_padded
    log(f"  populated ring state: head={int(state.head)}, "
        f"valid share={float(state.valid.float().mean()):.3f}, overflow={int(state.overflow.sum())}")
    x = torch.nn.functional.pad(sim.model_input(state, cur["feat"], cur["addr"], sim.SimConfig()),
                                (0, 0, 0, S - (Q + 1)))

    def chain():  # one PyTorch call chain computing the same trunk (yardstick only)
        h = x
        for w, b in layers:
            n, c = h.shape[1] // 2, 2 * h.shape[2]
            h = torch.relu(torch.matmul(h.reshape(-1, n, c), w) + b)
        return h

    chans = [x.shape[2]] + [w.shape[1] for w, _ in layers]
    wbytes = sum(w.nbytes + b.nbytes for w, b in layers)
    rows = []

    # K1: fused ring-state assembly + trunk
    def k1():
        return ops.fused_step(conv, state, cur["feat"], cur["addr"], seq_padded=S)

    def p1():
        return ref.fused_step_ref(layers, state, cur["feat"], cur["addr"], seq_padded=S)

    out = k1()
    torch.cuda.synchronize()
    err1 = compare(torch, "fused_step", out, p1())
    in_bytes = sum(t.nbytes for t in (state.feat, state.addr, state.resid, state.exec_lat,
                                       state.store_lat, state.valid, state.head,
                                       cur["feat"], cur["addr"]))
    b_ms, b_by = bound(in_bytes + wbytes + out.nbytes, trunk_ops(L, S, chans))
    rows.append(dict(name="fused_step", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_step.cu",
                     replaces="src/repro/kernels/fused_step.py:139",
                     max_abs_err=err1, ms=time_ms(torch, k1), plain_ms=time_ms(torch, p1),
                     bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, chain)))

    # K2: trunk on the assembled input
    def k2():
        return ops.cnn_trunk(conv, x)

    def p2():
        return ref.cnn_trunk_ref(layers, x)

    out = k2()
    torch.cuda.synchronize()
    err2 = compare(torch, "cnn_trunk", out, p2())
    b_ms, b_by = bound(x.nbytes + wbytes + out.nbytes, trunk_ops(L, S, chans))
    rows.append(dict(name="cnn_trunk", route="cuda",
                     source="src/repro_torch/kernels/csrc/cnn_trunk.cu",
                     replaces="src/repro/kernels/cnn_trunk.py:55",
                     max_abs_err=err2, ms=time_ms(torch, k2), plain_ms=time_ms(torch, p2),
                     bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, chain)))
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"matmul chain {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return pcfg, params, rows


def make_traces(names_and_sizes):
    from repro_torch.core.features import trace_arrays
    from repro_torch.des.o3 import O3Config, O3Simulator
    from repro_torch.des.workloads import get_benchmark

    sim = O3Simulator(O3Config())
    traces = [sim.run(get_benchmark(n, size)) for n, size in names_and_sizes]
    return traces, [trace_arrays(t) for t in traces]


def teacher_forced_phase(torch, dev):
    """Teacher-forced totals on the card are exact."""
    import numpy as np

    from repro_torch.core.simulator import SimConfig
    from repro_torch.serving.simnet_engine import SimNetEngine

    log("[4] teacher-forced exactness on the card")
    t0 = time.perf_counter()
    traces, arrays = make_traces(TF_BENCHES)
    log(f"  DES traces {[t.n for t in traces]} made in {time.perf_counter() - t0:.1f} s")
    # lane totals are integer-valued f32 summed with atomics: exact while a
    # workload stays below 2**24 cycles, which these traces do
    check(all(t.total_cycles < 2**24 for t in traces), "every trace below 2**24 cycles")
    eng = SimNetEngine(device=dev)
    one = eng.simulate_many(arrays, n_lanes=1)
    check(list(one["workload_cycles"]) == [float(t.total_cycles) for t in traces],
          f"n_lanes=1 totals equal trace.total_cycles {[t.total_cycles for t in traces]}")
    packed = eng.simulate_many(arrays, n_lanes=8, chunk=512)
    alone = [eng.simulate_many([a], n_lanes=8, chunk=512)["workload_cycles"][0] for a in arrays]
    check(np.array_equal(packed["workload_cycles"], np.asarray(alone)),
          f"packed run equals per-workload runs {packed['workload_cycles'].tolist()}")
    roll = SimNetEngine(sim_cfg=SimConfig(layout="roll"), device=dev).simulate_many(
        arrays, n_lanes=8, chunk=512)
    check(np.array_equal(packed["workload_cycles"], roll["workload_cycles"])
          and np.array_equal(packed["workload_overflow"], roll["workload_overflow"]),
          "ring equals roll")
    cpu = SimNetEngine(device="cpu").simulate_many(arrays, n_lanes=8, chunk=512)
    check(np.array_equal(packed["workload_cycles"], cpu["workload_cycles"])
          and np.array_equal(packed["workload_overflow"], cpu["workload_overflow"]),
          "CUDA totals equal the CPU totals bit for bit")


def predicted_phase(torch, dev, pcfg, params):
    """The main path: a C3-predicted pack through the engine."""
    import numpy as np

    from repro_torch.core.simulator import SimConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.simnet_engine import SimNetEngine

    log(f"[5] predicted main path: {len(PRED_BENCHES)} workloads x {PRED_LANES} lanes "
        f"x {PRED_STEPS} steps, c3 at full width")
    t0 = time.perf_counter()
    traces, arrays = make_traces([(n, PRED_LANES * PRED_STEPS) for n in PRED_BENCHES])
    log(f"  DES traces made in {time.perf_counter() - t0:.1f} s")
    launches = {}

    def run(sim_cfg, use_kernel, timeit):
        eng = SimNetEngine(params, pcfg, sim_cfg, use_kernel=use_kernel, device=dev)
        ops.reset_launches()
        res = eng.simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS, timeit=timeit)
        counts = dict(ops.launches)
        log(f"  layout={sim_cfg.layout} use_kernel={use_kernel}: "
            f"throughput_ips={res['throughput_ips']:.1f} seconds={res['seconds']:.3f} "
            f"first_call_seconds={res['first_call_seconds']:.3f} n_steps={res['n_steps']} "
            f"n_lanes={res['n_lanes']} launches={counts}")
        check(np.isfinite(res["workload_cycles"]).all()
              and res["workload_cycles"].shape == (len(PRED_BENCHES),), "totals finite, one per workload")
        return res, counts

    ring, counts = run(SimConfig(), True, True)
    passes = 2  # timeit streams the pack twice
    check(counts["fused_step"] == passes * ring["n_steps"] and counts["cnn_trunk"] == 0,
          f"fused_step launched once per step ({counts['fused_step']} = {passes} x {ring['n_steps']})")
    launches["fused_step"] = counts["fused_step"]
    roll, counts = run(SimConfig(layout="roll"), True, False)
    check(counts["cnn_trunk"] == roll["n_steps"] > 0 and counts["fused_step"] == 0,
          f"cnn_trunk launched once per step on the roll path ({counts['cnn_trunk']})")
    launches["cnn_trunk"] = counts["cnn_trunk"]
    plain, counts = run(SimConfig(), False, False)
    check(sum(counts.values()) == 0, "use_kernel=False launches no kernel")
    tf = SimNetEngine(device=dev).simulate_many(arrays, n_lanes=PRED_LANES, chunk=PRED_STEPS,
                                                timeit=True)
    log(f"  teacher-forced, same pack: throughput_ips={tf['throughput_ips']:.1f} "
        f"seconds={tf['seconds']:.3f}")
    for name, res in (("ring+fused_step", ring), ("roll+cnn_trunk", roll)):
        rel = np.abs(res["workload_cycles"] - plain["workload_cycles"]) / plain["workload_cycles"]
        log(f"  {name}: cycles {res['workload_cycles'].tolist()}")
        log(f"  plain torch:     cycles {plain['workload_cycles'].tolist()}")
        check(rel.max() < PRED_RTOL, f"{name} within {PRED_RTOL} of plain (max rel diff {rel.max():.3e})")
    return ring, launches, arrays


def profile_phase(torch, dev, pcfg, params, arrays, steps=32):
    """Where the main path's time goes, over a short profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simulator import SimConfig
    from repro_torch.serving.simnet_engine import SimNetEngine

    eng = SimNetEngine(params, pcfg, SimConfig(), use_kernel=True, device=dev)
    small = [{k: v[: PRED_LANES * steps] for k, v in a.items()} for a in arrays]
    eng.simulate_many(small, n_lanes=PRED_LANES, chunk=steps)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.simulate_many(small, n_lanes=PRED_LANES, chunk=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats its kernels' and would count them twice
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log("[6] profile: the profiler reported no device time (not measured)")
        return
    dev_ms = sum(r[0] for r in rows)  # one stream: device events do not overlap
    log(f"[6] profile of {steps} predicted steps x {len(arrays) * PRED_LANES} lanes "
        f"(profiler on): wall {wall_ms:.2f} ms ({wall_ms / steps:.3f} ms/step), device busy "
        f"{dev_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}% of wall), "
        f"{sum(r[1] for r in rows) / steps:.1f} device operations per step")
    for t, count, key in sorted(rows, reverse=True)[:6]:
        log(f"  {key[:100]}: {t:.3f} ms in {count} calls ({100 * t / dev_ms:.1f}% of device time)")


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit("chip_smoke.py must run from the root of a checkout (src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    log(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}), device: {kind}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    log(smi)

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    pcfg, params, rows = kernel_phase(torch, dev)
    teacher_forced_phase(torch, dev)
    ring, launches, arrays = predicted_phase(torch, dev, pcfg, params)
    profile_phase(torch, dev, pcfg, params, arrays)

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
