"""Serve a simulation request end to end on the PyTorch port: the
counterpart of ``examples/simulate_workload.py`` with ``--device``.

Pipeline: synthetic program → lightweight history-context simulation (fast
path — no DES pipeline model!) → massively-parallel ML simulation via the
SimNet session (engine pack path) → accuracy + throughput vs the DES.

  PYTHONPATH=src python examples/simulate_workload_torch.py [--lanes 32] [--n 60000] [--device cpu]
"""
import argparse
import time
from pathlib import Path

from repro_torch._device import DEVICE_KINDS
from repro_torch.checkpoint import PredictorArtifact
from repro_torch.core import api
from repro_torch.core.api import SimNet
from repro_torch.core.predictor import PredictorConfig
from repro_torch.core.simulator import SimConfig
from repro_torch.des.history import trace_with_history
from repro_torch.des.o3 import O3Config, O3Simulator
from repro_torch.des.workloads import get_benchmark

ARTIFACT = Path("artifacts/simnet/models/c3_hybrid")
FALLBACK = Path("artifacts/models/quick_c3")


def get_session(device=None) -> SimNet:
    """Reuse the pipeline's trained artifact if present (either package's:
    the format is shared), else train a quick one on ``device`` and save
    it so the next run reloads instead of retraining."""
    for path in (ARTIFACT, FALLBACK):
        if PredictorArtifact.exists(path):
            return SimNet.from_artifact(path, device=device)
    print("(no pretrained artifact found — training a quick one)")
    traces = api.generate_traces(["mlb_mixed", "mlb_stream"], 20000,
                                 cache_dir="artifacts/traces")
    sn = SimNet.train(traces, PredictorConfig(kind="c3", ctx_len=64),
                      SimConfig(ctx_len=64), epochs=6, batch_size=512, device=device)
    sn.save(FALLBACK)
    return sn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default="sim_phased")
    ap.add_argument("--n", type=int, default=60000)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--device", choices=DEVICE_KINDS, default="cuda")
    args = ap.parse_args(argv)

    sn = get_session(args.device)
    prog = get_benchmark(args.bench, args.n)

    print("== history-context simulation (fast path, no pipeline model) ==")
    t0 = time.time()
    trace = trace_with_history(prog)  # caches/TLB/branch predictor only
    t_hist = time.time() - t0
    print(f"  {args.n} instructions in {t_hist:.1f}s ({args.n/t_hist:.0f} IPS)")

    print(f"== parallel ML simulation: {args.lanes} lanes ==")
    res = sn.simulate(trace, n_lanes=args.lanes, chunk=512, timeit=True)
    w = res[0]
    print(f"  SimNet: {w.total_cycles:.0f} cycles, CPI {w.cpi:.3f}, "
          f"{res.throughput_ips:.0f} instr/s")

    print("== reference DES comparison ==")
    t0 = time.time()
    ref = O3Simulator(O3Config()).run(prog)
    t_des = time.time() - t0
    err = abs(w.cpi - ref.cpi) / ref.cpi
    print(f"  DES: {ref.total_cycles} cycles, CPI {ref.cpi:.3f}, "
          f"{args.n/t_des:.0f} instr/s")
    print(f"  CPI error {100*err:.2f}%  |  SimNet speedup over DES "
          f"{(res.throughput_ips*t_des/args.n):.1f}x (SimNet on {sn.device}, the DES on one "
          "CPU core)")


if __name__ == "__main__":
    main()
