"""Design-space exploration (paper §5) on the PyTorch port: the
counterpart of ``examples/design_space.py`` with ``--device``. Compare L2
cache sizes WITHOUT retraining — only the lightweight history-context
simulation changes; the trained predictor is reused as-is via
`SimNet.sweep`.

  PYTHONPATH=src:. python examples/design_space_torch.py [--device cpu]   # repo root on path
                                                                        # (examples/ is a package)

CLI equivalent (predictor mode needs a saved artifact):

  python -m repro_torch sweep --artifact artifacts/simnet/models/c3_hybrid \\
      --param l2 --bench sim_chase_mid -n 60000
"""
import argparse

from examples.simulate_workload_torch import get_session
from repro_torch._device import DEVICE_KINDS
from repro_torch.des.history import trace_with_history
from repro_torch.des.o3 import O3Config, O3Simulator
from repro_torch.des.workloads import get_benchmark

N = 60000
L2_SIZES = [256 * 1024, 1024 * 1024, 4 * 1024 * 1024]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=DEVICE_KINDS, default="cuda")
    args = ap.parse_args(argv)

    sn = get_session(args.device)
    # working set (2MB) straddles the swept sizes, so they differentiate
    prog = get_benchmark("sim_chase_mid", N)

    # all design points ride ONE packed call (SimNet.sweep): each L2 size
    # contributes its own lanes, so the whole exploration is a single
    # build+dispatch cycle instead of len(L2_SIZES) of them
    des_runs = {l2: O3Simulator(O3Config(caches=dict(l2_size=l2))).run(prog)
                for l2 in L2_SIZES}
    jobs = [(f"{l2//1024}kB", trace_with_history(prog, caches=dict(l2_size=l2)))
            for l2 in L2_SIZES]
    swept = sn.sweep(jobs, n_lanes=8, chunk=512)

    print(f"{'L2 size':>9s} {'DES CPI':>9s} {'SimNet CPI':>11s} {'DES speedup':>12s} {'SimNet speedup':>15s}")
    base_des = des_runs[L2_SIZES[0]].cpi
    base_sim = swept.point(swept.points[0])[0].cpi
    for l2, label in zip(L2_SIZES, swept.points):
        w = swept.point(label)[0]
        des = des_runs[l2]
        print(f"{l2//1024:7d}kB {des.cpi:9.3f} {w.cpi:11.3f} "
              f"{100*(base_des/des.cpi-1):+11.2f}% {100*(base_sim/w.cpi-1):+14.2f}%")
    res = swept.result
    print(f"\n{res.n_workloads} design points simulated in one packed call "
          f"({res.throughput_ips:.0f} instr/s). Relative speedups from the ML "
          "simulator track the DES without any retraining — the paper's "
          "'pre-trained models directly applicable' claim.")


if __name__ == "__main__":
    main()
