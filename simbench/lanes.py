"""Throughput against the lanes of a call, to size a mix (not run by the
benchmark's runs).

    python3 -m simbench.lanes --workload <cell> --seed <n> --seconds <s> \
        --lanes 1024,2048,4096 [--clients 2,3]

For each lane count and number of clients, in one process: an untraced run
of the cell (`simbench.run.run`) whose calls keep the mix's jobs and its
sub-trace length (``chunk`` steps a lane) but split each job into that
many lanes over all, so a job covers ``lanes / jobs × chunk`` instructions
of its trace (the pool is made longer where it must be). Prints one JSON
line each: lanes, instructions a call, calls, ``throughput_ips``, the
card's peak memory and ``correct``.
"""
from __future__ import annotations

import argparse
import json
import sys

from simbench import manifest, traffic
from simbench.manifest import ROOT


def override(cell: str, lanes: int, clients: int) -> dict:
    """The mix of ``cell`` with its calls split into ``lanes`` lanes."""
    mix = traffic.load_mix(manifest.mix_path(manifest.cell(manifest.load(), cell)["traffic"]))
    jobs = mix["workloads_per_call"] * len(mix["retire_widths"])
    if lanes % jobs:
        raise ValueError(f"{lanes} lanes do not split into {jobs} jobs")
    per_job = lanes // jobs * mix["chunk"]
    return {"lanes_per_job": lanes // jobs, "job_instructions": per_job,
            "pool_instructions": max(mix["pool_instructions"], per_job), "clients": clients,
            "check_calls": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--lanes", required=True)
    ap.add_argument("--clients", default="2")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from simbench import run

    for lanes in (int(x) for x in args.lanes.split(",")):
        for clients in (int(x) for x in args.clients.split(",")):
            mix = override(args.workload, lanes, clients)
            r = run.run(args.workload, args.seed, args.seconds, False, mix_override=mix)
            print(json.dumps({
                "workload": args.workload, "lanes": lanes, "clients": clients,
                "instructions_a_call": lanes * mix["job_instructions"] // mix["lanes_per_job"],
                "calls": r["attempted"], "throughput_ips": r["metrics"]["throughput_ips"]["value"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                "correct": r["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
