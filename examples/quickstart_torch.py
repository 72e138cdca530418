"""Quickstart on the PyTorch port: the SimNet session API end to end, the
counterpart of ``examples/quickstart.py`` with ``--device``.

  1. run the reference DES over two small benchmarks (ground truth),
  2. `SimNet.train` a C3 predictor and save it as a PredictorArtifact,
  3. reload the artifact (as a later process would) and ML-simulate a
     held-out benchmark through the engine pack path, CPI vs the DES.

  PYTHONPATH=src python examples/quickstart_torch.py                # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # minutes

The same flow without writing Python:

  python -m repro_torch train --bench mlb_mixed mlb_branchy -n 20000 \\
      --epochs 6 --artifact artifacts/models/quickstart
  python -m repro_torch simulate --artifact artifacts/models/quickstart \\
      --bench sim_loop -n 10000
"""
import argparse
import time

from repro_torch._device import DEVICE_KINDS
from repro_torch.core import api
from repro_torch.core.api import SimNet
from repro_torch.core.predictor import PredictorConfig

T_TRAIN = 20000
T_EVAL = 10000
ARTIFACT = "artifacts/models/quickstart"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=DEVICE_KINDS, default="cuda")
    args = ap.parse_args(argv)

    t0 = time.time()
    print("== 1. reference DES (the 'gem5' of this repo) ==")
    traces = api.generate_traces(["mlb_mixed", "mlb_branchy"], T_TRAIN)
    for tr in traces:
        print(f"  {tr.name}: {tr.n} instructions, CPI {tr.cpi:.3f}")

    print("== 2. train once (SimNet.train), save the artifact ==")
    sn = SimNet.train(traces, PredictorConfig(kind="c3", ctx_len=64),
                      epochs=6, batch_size=512, log_every=1, device=args.device)
    print(f"  per-latency prediction errors: {sn.train_result.pred_errors}")
    sn.save(ARTIFACT)
    print(f"  saved PredictorArtifact → {ARTIFACT}")

    print("== 3. reload + ML-simulate a held-out benchmark ==")
    sn = SimNet.from_artifact(ARTIFACT, device=args.device)  # what a later process would do
    tr = api.generate_traces(["sim_loop"], T_EVAL)[0]
    res = sn.simulate(tr, n_lanes=8, timeit=True)  # SimResult (1-workload pack)
    w = res[0]
    print(f"  DES CPI {w.des_cpi:.3f} vs SimNet CPI {w.cpi:.3f} "
          f"(error {100*w.cpi_error:.1f}%)")
    print(f"  throughput: {res.throughput_ips:.0f} instr/s on "
          f"{w.n_lanes} parallel lanes ({sn.device})")
    print(f"done in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
