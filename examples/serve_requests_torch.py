"""SimServe on the PyTorch port: many concurrent simulation requests,
resident predictors, one program a shape — the counterpart of
``examples/serve_requests.py`` with ``--device``.

A stream of requests — different benchmarks, different lane counts,
different clients, some against the trained predictor and some
teacher-forced — lands on ONE resident service running its background
drain loop. Each client is a real thread: it submits, then blocks on its
own handles (`result(timeout=...)`) while the scheduler packs compatible
pending jobs into shared lane batches per resident model (round-robin
across models, lane counts bucketed to powers of two, dead lanes
masked), and the program cache keys its programs (CUDA graphs on the
card) by architecture, never weights, so the whole mix runs on a couple
of them.

  PYTHONPATH=src:. python examples/serve_requests_torch.py [--device cpu]   # repo root on path
                                                                          # (examples/ is a package)

CLI equivalent (batch mode, JSON in/out):

  python -m repro_torch serve --jobs jobs.json --async --max-queue-depth 256
"""
import argparse
import threading
import time

from examples.simulate_workload_torch import get_session
from repro_torch._device import DEVICE_KINDS
from repro_torch.core import api
from repro_torch.core.api import SimServe

REQUESTS = [  # (client, benchmark, n_instructions, lanes, use_predictor)
    ("alice", "sim_loop", 8000, 4, True),
    ("bob", "mlb_stream", 6000, 2, True),
    ("carol", "sim_branchy_easy", 7000, 8, True),
    ("dave", "mlb_compute", 6000, 4, False),  # label replay, no predictor
    ("erin", "mlb_mixed", 9000, 4, True),
    ("frank", "sim_stream2", 5000, 2, False),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=DEVICE_KINDS, default="cuda")
    args = ap.parse_args(argv)

    sn = get_session(args.device)  # trained artifact (train-once / serve-everyone)
    serve = SimServe(max_queue_depth=256, max_wait_ms=10.0, device=args.device)
    serve.register("c3", sn.artifact)

    traces = {name: api.generate_traces([name], n, cache_dir="artifacts/traces")[0]
              for _, name, n, _, _ in REQUESTS}

    print(f"== {len(REQUESTS)} client threads against the background drain loop ==")
    done = []
    dlock = threading.Lock()

    def client(who, bench, n, lanes, pred):
        h = serve.submit(traces[bench], "c3" if pred else None,
                         n_lanes=lanes, name=f"{who}/{bench}")
        w = h.result(timeout=600)  # blocks on THIS job only — never drains
        with dlock:
            done.append((w, h.model_id))

    t0 = time.time()
    with serve:  # starts the drain loop; stop (and final drain) on exit
        threads = [threading.Thread(target=client, args=req) for req in REQUESTS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    wall = time.time() - t0

    print(f"== all clients served in {wall:.2f}s ==")
    for w, mid in sorted(done, key=lambda x: x[0].name):
        err = f", CPI err vs DES {100*w.cpi_error:.1f}%" if w.cpi_error is not None else ""
        print(f"  {w.name:24s} model={mid:14s} "
              f"{w.total_cycles:9.0f} cycles, CPI {w.cpi:.3f}{err}")

    st = serve.stats()
    print("== service stats ==")
    print(f"  {st['jobs_completed']} jobs in {st['batches']} shared batches "
          f"({st['jobs_per_batch']:.1f} jobs/batch), "
          f"{st['lanes_live']}/{st['lanes_dispatched']} lanes live (rest = bucketing)")
    c = st["cache"]
    print(f"  program cache: {c['misses']} builds ({c['compile_seconds']:.2f}s), "
          f"{c['hits']} hits — resident programs: {list(c['executables'])}")


if __name__ == "__main__":
    main()
