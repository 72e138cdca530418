"""Readings for the limits of ``correct`` (not run by the benchmark's runs).

    python3 -m simbench.control --workload <cell> --seeds <n>[,<n>...]

For each seed, in one process: the cell's weights, then ``check_calls``
calls of one client through the program's timed entry at the cell's sizes
(the same calls a run samples from), and the reference over the same jobs
twice: in float32, and as the control, with every matrix product's
operands rounded to TF32 (the precision below the configuration's float32).
Prints one JSON line a seed: the program's ``answer_gap_mean`` against the
float32 reference (a lower reading) and the control's (an upper reading),
and the verdict of `simbench.run.judge` on each with the cell's limits
(``correct``: true for the program, false for the control).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from simbench.manifest import ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from simbench import run

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("the control's readings are taken on the card")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = run.Cell(args.workload, seed, "cuda:0")
        calls = [cell.call(0, i) for i in range(cell.mix["check_calls"])]
        bad = [c.error for c in calls if c.error]
        if bad:
            raise RuntimeError(bad[0])
        jobs = run.sample(cell, calls)
        ref = run.reference_totals(cell, jobs)
        t1 = time.perf_counter()
        control = run.reference_totals(cell, jobs, precision="tf32")
        t2 = time.perf_counter()
        program = run.answers(jobs)

        def differing(got):
            return sum(g["cycles"] != r["cycles"] for g, r in zip(got, ref))

        # the control is the reference in the program's place: it fails no
        # call and simulates every instruction, so only its totals differ
        numbers = {"program": run.check_numbers(calls, jobs, program, ref),
                   "control": run.check_numbers([], jobs, control, ref)}
        print(json.dumps({
            "workload": args.workload, "seed": seed, "jobs": len(jobs),
            "program": numbers["program"]["answer_gap_mean"],
            "control": numbers["control"]["answer_gap_mean"],
            "limit": cell.limits["answer_gap_mean"]["limit"],
            "correct": {k: run.judge(v, cell.limits)[0] for k, v in numbers.items()},
            "jobs_differing": {"program": differing(program), "control": differing(control)},
            "overflow": sum(r["overflow"] for r in ref),
            "cpi": sum(r["cycles"] for r in ref) / sum(j.instructions for _, _, j in jobs),
            "seconds": {"program_and_reference": t1 - t0, "control": t2 - t1}}), flush=True)
        cell.engine = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
