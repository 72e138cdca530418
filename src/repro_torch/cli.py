"""`python -m repro_torch` — the PyTorch/CUDA port of SimNet as a command
line tool, with the reference CLI's (`python -m repro`) subcommands, flags
and JSON shapes.

Subcommands mirror the session API (`repro_torch.core.session.SimNet`);
every command prints a JSON document (the typed results' `.to_dict()`), so
runs compose with jq / CI checks. One global option, ``--device
{cuda,cpu}`` (default ``cuda``; accepted before or after the subcommand),
places every engine, dataset, trainer and replica: the port never falls
back to the CPU on its own, and without a GPU ``--device cuda`` raises.

  trace     run the reference DES over benchmarks, cache npz traces;
            --multicore N / --mix NAME co-runs a mix on the multicore DES
            (shared L2 + bus + MSHRs) and emits the solo-vs-co-run
            contention report; --list enumerates benchmarks and mixes
  train     DES traces → teacher-forced dataset → predictor → artifact dir
  simulate  load a PredictorArtifact, simulate benchmarks (one packed call)
  sweep     design-space sweep (L2 sizes or branch predictors) in one pack;
            without --artifact it replays DES labels teacher-forced through
            the same engine path (fast structural dry-run, used by CI)
  serve     batch-mode SimServe: read a JSON job file (many jobs × many
            resident models), continuously pack the jobs into shared lane
            batches per model, emit per-job results + service/cache stats;
            --async runs the background drain loop (--max-wait-ms batch
            window, --max-queue-depth admission control); --http PORT with
            no --jobs runs a STANDING replica server (prints one
            {"event": "listening", "port": N} line, serves until
            SIGTERM/SIGINT — what `repro_torch fleet` spawns N of)
  fleet     spawn N replica subprocesses + the router tier over them,
            round-trip a job file through the router as a real client
  bench     packed-vs-sequential engine microbenchmark
  lint      the domain static analysis (the port's copy of the reference's
            stdlib-only `analysis` package)

Train once, simulate anywhere:

  python -m repro_torch train --bench mlb_mixed mlb_branchy -n 20000 \
      --artifact artifacts/models/cli_c3 --eval-bench sim_loop
  python -m repro_torch simulate --artifact artifacts/models/cli_c3 \
      --bench sim_loop -n 10000 --lanes 8

The second process reloads the artifact and reproduces the first one's
CPI exactly (params round-trip bit-identically).

Serve a job file (jobs without "model" replay teacher-forced; all jobs
against one resident model share lane batches and compiled executables):

  python -m repro_torch serve --jobs jobs.json
  python -m repro_torch serve --jobs jobs.json --async --max-queue-depth 256 \
      --max-wait-ms 5          # background drain loop + admission control
  # jobs.json:
  # {"models": {"c3": "artifacts/models/cli_c3"},
  #  "jobs": [{"id": "a", "model": "c3", "bench": "sim_loop", "n": 4000},
  #           {"id": "b", "model": "c3", "bench": "mlb_mixed", "lanes": 4},
  #           {"id": "tf", "bench": "sim_loop", "n": 2000}]}
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch._device import DEVICE_KINDS
from repro_torch.core import api
from repro_torch.core.predictor import PredictorConfig
from repro_torch.core.session import SimNet
from repro_torch.core.simulator import SimConfig
from repro_torch.des.o3 import A64FX_CONFIG, O3Config
from repro_torch.serving.service import QueueFull, SimServe

O3_CONFIGS = {"default": None, "a64fx": A64FX_CONFIG}


def _emit(obj):
    json.dump(obj, sys.stdout, indent=2, default=float)
    sys.stdout.write("\n")


def _gen_traces(benchmarks, n, o3_name, cache_dir):
    return api.generate_traces(
        benchmarks, n, o3=O3_CONFIGS[o3_name], cache_dir=cache_dir
    )


# ---------------------------------------------------------------- commands

def cmd_trace(args) -> int:
    if args.list:
        from repro_torch.des.workloads import (
            ML_BENCHMARKS, MULTICORE_MIXES, SIM_BENCHMARKS,
        )
        _emit({
            "benchmarks": {
                "ml": sorted(ML_BENCHMARKS),
                "sim": sorted(SIM_BENCHMARKS),
            },
            "mixes": list(MULTICORE_MIXES),
        })
        return 0
    if args.multicore or args.mix:
        return _trace_multicore(args)
    traces = _gen_traces(args.bench, args.n, args.o3, args.cache_dir)
    _emit({
        "traces": [
            {"name": t.name, "n_instructions": int(t.n),
             "des_cycles": t.total_cycles, "des_cpi": t.cpi}
            for t in traces
        ],
        "cache_dir": args.cache_dir,
    })
    return 0


def _trace_multicore(args) -> int:
    """Co-run a mix on the multicore DES and emit the contention report —
    the train-free golden check: with sharing on, every core's co-run CPI
    must sit at or above its solo CPI ("golden_contended")."""
    from repro_torch.des.multicore import contention_report
    from repro_torch.des.workloads import get_mix

    mix = args.mix or "mix_stream_chase"
    n = min(args.n, 2000) if args.quick else args.n
    progs = get_mix(mix, n, n_cores=args.multicore)
    traces, report = contention_report(
        progs, o3=O3_CONFIGS[args.o3] or O3Config(), mix=mix
    )
    _emit({
        "mix": mix,
        "n_cores": report.n_cores,
        "n_instructions_base": n,
        "traces": [
            {"name": t.name, "n_instructions": int(t.n),
             "des_cycles": t.total_cycles, "des_cpi": t.cpi}
            for t in traces
        ],
        "contention": report.to_dict(),
        "golden_contended": all(s >= 1.0 for s in report.slowdowns),
    })
    return 0


def cmd_train(args) -> int:
    n = max(args.n // 5, 2000) if args.quick else args.n
    epochs = max(args.epochs // 3, 1) if args.quick else args.epochs
    traces = _gen_traces(args.bench, n, args.o3, args.cache_dir)
    pcfg = PredictorConfig(kind=args.kind, ctx_len=args.ctx_len, output=args.output)
    sn = SimNet.train(
        traces, pcfg, SimConfig(ctx_len=args.ctx_len),
        epochs=epochs, batch_size=args.batch_size, lr=args.lr,
        seed=args.seed, log_every=args.log_every, device=args.device,
    )
    out = {"train": sn.train_result.to_dict(), "artifact": None, "eval": None}
    if args.artifact:
        sn.save(args.artifact)
        out["artifact"] = args.artifact
    if args.eval_bench:
        ev = _gen_traces(args.eval_bench, args.eval_n or n, args.o3, args.cache_dir)
        out["eval"] = sn.simulate_many(ev, n_lanes=args.lanes).to_dict()
    _emit(out)
    return 0


def _session(args) -> SimNet:
    import dataclasses

    from repro_torch.checkpoint.artifact import PredictorArtifact

    kw = {"use_kernel": bool(getattr(args, "use_kernel", False)),
          "device": args.device}
    layout = getattr(args, "layout", None)
    if args.artifact:
        art = PredictorArtifact.load(args.artifact, device=args.device)
        if layout:  # run the artifact's config under the requested layout
            kw["sim_cfg"] = dataclasses.replace(art.sim_cfg, layout=layout)
        return SimNet(art, **kw)
    # teacher-forced: replay the DES labels through the same engine path
    if layout:
        kw["sim_cfg"] = SimConfig(layout=layout)
    return SimNet(**kw)


def cmd_simulate(args) -> int:
    sn = _session(args)
    traces = _gen_traces(args.bench, args.n, args.o3, args.cache_dir)
    res = sn.simulate_many(traces, n_lanes=args.lanes, timeit=args.timeit)
    _emit({"artifact": args.artifact, "result": res.to_dict()})
    return 0


def cmd_sweep(args) -> int:
    from repro_torch.des.history import trace_with_history
    from repro_torch.des.o3 import O3Simulator
    from repro_torch.des.workloads import get_benchmark

    defaults = {
        "l2": ["262144", "1048576", "4194304"],
        "bpred": ["bimodal", "bimode", "tage"],
    }[args.param]
    n = min(args.n, 4000) if args.quick else args.n
    points = args.points or (defaults[:2] if args.quick else defaults)
    sn = _session(args)
    jobs = []
    if args.multicore or args.mix:
        # multicore sweep: at each design point, co-run the mix on the
        # multicore DES (contention-dependent features ride the traces —
        # there is no lightweight co-run history path) and sweep one job
        # per core
        from repro_torch.des.multicore import MulticoreSim
        from repro_torch.des.workloads import get_mix

        mix = args.mix or "mix_stream_chase"
        progs = get_mix(mix, n, n_cores=args.multicore)
        for pt in points:
            if args.param == "l2":
                label, kw = f"l2={int(pt)//1024}kB", {"caches": dict(l2_size=int(pt))}
            else:
                label, kw = f"bpred={pt}", {"bpred": pt}
            traces, _ = MulticoreSim(O3Config(**kw)).run(progs)
            for i, tr in enumerate(traces):
                jobs.append((f"{label}/c{i}", tr))
    else:
        for bench in args.bench:
            prog = get_benchmark(bench, n)
            for pt in points:
                if args.param == "l2":
                    label, kw = f"l2={int(pt)//1024}kB", {"caches": dict(l2_size=int(pt))}
                else:
                    label, kw = f"bpred={pt}", {"bpred": pt}
                if sn.params is None:
                    # teacher-forced needs DES labels at each design point
                    tr = O3Simulator(O3Config(**kw)).run(prog)
                else:
                    tr = trace_with_history(prog, **kw)
                jobs.append((label, tr))
    res = sn.sweep(jobs, n_lanes=args.lanes)
    _emit({
        "param": args.param,
        "benchmarks": (args.mix or "mix_stream_chase") if (args.multicore or args.mix)
        else args.bench,
        "n_instructions": n,
        "mode": "predictor" if sn.params is not None else "teacher-forced",
        "sweep": res.to_dict(),
    })
    return 0


def cmd_serve(args) -> int:
    """Batch-mode service: load the job file's models once as residents,
    submit every job, run the queue (continuous batching per resident
    model), and emit per-job results plus batch/cache statistics.

    With ``--async`` the background drain loop dispatches while jobs are
    still being submitted (``--max-wait-ms`` batch window, round-robin
    across resident models) and ``--max-queue-depth`` bounds admission;
    without it the queue drains synchronously after the last submit.

    With ``--http PORT`` (0 = ephemeral) the jobs round-trip over a live
    HTTP front-end instead: the server binds, each job is POSTed to
    ``/v1/jobs`` as a real network client, results are polled from
    ``/v1/jobs/<id>`` and stats from ``/v1/stats`` — the CI smoke for
    the wire path. ``--priority`` / ``--deadline-ms`` set per-job QoS
    defaults (a job file entry's own "priority"/"deadline_ms" wins).

    With ``--http PORT`` and NO ``--jobs`` this becomes a standing
    replica server: bind, print the listening line, serve until
    SIGTERM/SIGINT — the mode `repro_torch fleet` spawns N of. ``--model
    ID=PATH`` makes artifacts resident (teacher-forced replay is always
    available)."""
    from repro_torch.checkpoint import ArtifactCorrupt
    from repro_torch.serving import faults
    from repro_torch.serving.backoff import Backoff

    if getattr(args, "faults", None):
        faults.install(faults.FaultPlan.from_spec(args.faults))
    spec = json.loads(Path(args.jobs).read_text()) if args.jobs else {}
    serve = SimServe(
        chunk=args.chunk,
        max_queue_depth=args.max_queue_depth,
        max_wait_ms=args.max_wait_ms,
        batch_timeout_s=args.batch_timeout_s,
        device=args.device,
    )
    models = dict(spec.get("models") or {})
    for entry in args.model or []:
        mid, sep, path = entry.partition("=")
        if not sep or not mid or not path:
            print(f"--model wants ID=ARTIFACT_DIR, got {entry!r}",
                  file=sys.stderr)
            return 2
        models[mid] = path
    for mid, path in models.items():
        try:
            serve.register(mid, path)
        except ArtifactCorrupt as e:
            # the registry already tripped this model's breaker — keep the
            # replica up so its healthy residents stay in rotation and
            # /v1/healthz reports "degraded" with the open breaker
            print(f"model {mid!r} failed integrity check, serving without "
                  f"it: {e}", file=sys.stderr)
    if args.jobs is None:
        if args.http is None:
            print("serve needs --jobs (batch mode) or --http "
                  "(standing server)", file=sys.stderr)
            return 2
        return _serve_listen(args, serve)
    if args.http is not None:
        return _serve_http(args, spec, serve)
    if args.async_:
        serve.start()
    handles = []
    backoff = Backoff(0.005, 0.25)  # QueueFull retry pacing (async mode)
    trace_memo = {}  # jobs repeating a (bench, n, o3) cell share one DES run
    for i, job in enumerate(spec.get("jobs", [])):
        bench = job.get("bench") or (args.bench[0] if args.bench else "sim_loop")
        n = int(job.get("n", args.n))
        tkey = (bench, n, job.get("o3", args.o3))
        if tkey not in trace_memo:
            trace_memo[tkey] = _gen_traces([tkey[0]], n, tkey[2], args.cache_dir)[0]
        tr = trace_memo[tkey]
        while True:
            try:
                h = serve.submit(
                    tr, job.get("model"),
                    n_lanes=int(job.get("lanes", args.lanes)),
                    name=job.get("id") or f"job{i}",
                    priority=int(job.get("priority", args.priority)),
                    deadline_ms=job.get("deadline_ms", args.deadline_ms),
                )
                backoff.reset()  # admitted — the next wait starts snappy
                break
            except QueueFull:
                # the documented client response to backpressure: let the
                # queue shrink, then retry (async: the loop is draining,
                # wait with capped exponential backoff; sync: drain here —
                # nothing else will)
                if args.async_:
                    backoff.sleep()
                else:
                    serve.drain()
        handles.append((job.get("id") or f"job{i}", job.get("model"), h))
    if args.async_:
        for _, _, h in handles:
            h.wait()
        serve.stop()  # joins the loop; drains any straggler inline
    else:
        serve.drain()
    _emit({
        "mode": "async" if args.async_ else "sync",
        "jobs": [
            {"id": jid, "model": mid, "result": h.result().to_dict()}
            for jid, mid, h in handles
        ],
        "batches": [b.to_dict() for b in serve.batches],
        "stats": serve.stats(),
    })
    return 0


def _job_payloads(spec, args) -> list:
    """The job file's entries as wire payloads (bench specs — the server
    side runs/caches the DES trace), CLI defaults applied."""
    payloads = []
    for i, job in enumerate(spec.get("jobs", [])):
        payload = {
            "id": job.get("id") or f"job{i}",
            "model": job.get("model"),
            "bench": job.get("bench") or (args.bench[0] if args.bench
                                          else "sim_loop"),
            "n": int(job.get("n", args.n)),
            "o3": job.get("o3", args.o3),
            "lanes": int(job.get("lanes", args.lanes)),
            "priority": int(job.get("priority", args.priority)),
        }
        deadline = job.get("deadline_ms", args.deadline_ms)
        if deadline is not None:
            payload["deadline_ms"] = float(deadline)
        payloads.append(payload)
    return payloads


def _serve_listen(args, serve: SimServe) -> int:
    """The standing replica server: bind, announce the port on stdout as
    one JSON line (the fleet manager reads it to collect ephemeral
    ports), serve until SIGTERM/SIGINT, exit with the final stats."""
    import os
    import signal
    import threading

    from repro_torch.serving.http import SimServeHTTP

    front = SimServeHTTP(serve, port=args.http, cache_dir=args.cache_dir)
    port = front.start()
    # ONE compact line: the fleet manager line-parses stdout for this
    print(json.dumps({"event": "listening", "port": port, "url": front.url,
                      "pid": os.getpid(),
                      "models": sorted(serve.registry.ids())}),
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    front.stop(stop_service=True)
    _emit({"event": "stopped", "port": port, "stats": serve.stats()})
    return 0


def _serve_http(args, spec, serve: SimServe) -> int:
    """The ``--http`` round trip: bind the front-end, act as a real HTTP
    client against it (POST every job, poll every result), emit JSON."""
    from repro_torch.serving.backoff import Backoff
    from repro_torch.serving.http import SimServeHTTP, http_request, wait_job

    front = SimServeHTTP(serve, port=args.http, cache_dir=args.cache_dir)
    port = front.start()
    base = front.url
    try:
        posted = []
        backoff = Backoff(0.005, 0.25)
        for payload in _job_payloads(spec, args):
            while True:
                status, body = http_request(f"{base}/v1/jobs", "POST", payload)
                if status != 429:  # queue-full backpressure: wait and retry
                    backoff.reset()
                    break
                backoff.sleep()
            if status != 202:
                print(f"submit {payload['id']!r} failed: {status} {body}",
                      file=sys.stderr)
                return 1
            posted.append((payload["id"], payload.get("model"), body["job_id"]))
        jobs_out = []
        failed = 0
        for jid, mid, job_id in posted:
            body = wait_job(base, job_id)
            entry = {"id": jid, "model": mid, "status": body["status"]}
            if body["status"] == "done":
                entry["result"] = body["result"]
            else:
                failed += 1
                entry["error"] = body.get("error")
            jobs_out.append(entry)
        _, health = http_request(f"{base}/v1/healthz")
        _, stats = http_request(f"{base}/v1/stats")
    finally:
        front.stop(stop_service=True)
    _emit({
        "mode": "http",
        "port": port,
        "healthz": health,
        "jobs": jobs_out,
        "stats": stats,
    })
    return 1 if failed else 0


def cmd_fleet(args) -> int:
    """Fleet mode: spawn ``--replicas`` SimServe subprocesses (each a
    standing ``repro_torch serve --http 0 --device DEV`` with the job
    file's models
    resident), start the router tier over their collected ports, then
    act as a real HTTP client against the ROUTER — POST every job
    (model-aware p2c placement, failover), poll every result (resubmit
    on a lost replica), and emit per-job results plus the aggregated
    fleet stats. ``--quick`` shrinks the per-job instruction counts to
    CI-smoke size."""
    from repro_torch.serving.fleet import Fleet
    from repro_torch.serving.http import http_request
    from repro_torch.serving.router import route_jobs

    spec = json.loads(Path(args.jobs).read_text())
    if args.quick:
        args.n = min(args.n, 2000)
        for job in spec.get("jobs", []):
            if "n" in job:
                job["n"] = min(int(job["n"]), 2000)
    fleet = Fleet(
        args.replicas,
        models=spec.get("models"),
        router_port=args.http,
        max_queue_depth=args.max_queue_depth,
        max_wait_ms=args.max_wait_ms,
        chunk=args.chunk,
        cache_dir=args.cache_dir,
        startup_timeout_s=args.startup_timeout,
        device=args.device,
    )
    with fleet:
        port = fleet.router.port
        entries = route_jobs(fleet.url, _job_payloads(spec, args),
                             timeout=args.timeout)
        _, health = http_request(f"{fleet.url}/v1/healthz")
        stats = fleet.stats()
    failed = sum(e["status"] != "done" for e in entries)
    _emit({
        "mode": "fleet",
        "replicas": len(fleet.replicas),
        "port": port,
        "healthz": health,
        "jobs": entries,
        "stats": stats,
    })
    return 1 if failed else 0


def cmd_chaos(args) -> int:
    """Seeded chaos drill over the serving stack: deterministic faults at
    the named injection sites (corrupt artifact bytes, failed compile,
    hung batch vs the watchdog, NaN-poisoned cycles — plus transport
    drops and a replica crash when ``--replicas`` > 0), then assert the
    self-healing invariants: every non-faulted job completes bit-identical
    to a fault-free baseline, zero jobs lost or duplicated, the corrupt
    model breaker-isolated while the others serve, the crashed replica
    restarted and readmitted. Exits non-zero if any invariant fails."""
    from repro_torch.serving.chaos import run_chaos

    out = run_chaos(seed=args.seed, quick=args.quick,
                    replicas=args.replicas,
                    batch_timeout_s=args.batch_timeout_s,
                    device=args.device)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2))
    _emit(out)
    return 0 if out["ok"] else 1


def cmd_bench(args) -> int:
    """Packed-vs-sequential: W workloads through one packed engine call vs
    one freshly-compiled engine per workload (the pre-packing behaviour —
    each sequential call gets its own COLD cache, otherwise it would
    free-ride on the shared executable cache it predates). On the card
    that cold cache means each sequential call builds its own CUDA graph."""
    import dataclasses

    from repro_torch.serving.compile_cache import CompileCache

    n = 3000 if args.quick else args.n
    if args.multicore or args.mix:
        # co-run traces: genuinely heterogeneous lane dynamics in the pack
        traces = api.generate_corun_traces(
            args.mix or "mix_stream_chase", n, o3=O3_CONFIGS[args.o3],
            n_cores=args.multicore, cache_dir=args.cache_dir,
        )
    else:
        names = args.bench or ["mlb_stream", "mlb_compute", "sim_loop", "mlb_branchy"]
        traces = _gen_traces(names, n, args.o3, args.cache_dir)
    art = (SimNet.from_artifact(args.artifact, device=args.device).artifact
           if args.artifact else None)

    def fresh():
        kw = {"cache": CompileCache(), "use_kernel": bool(args.use_kernel),
              "device": args.device}
        if args.layout:
            base = art.sim_cfg if art else SimConfig()
            kw["sim_cfg"] = dataclasses.replace(base, layout=args.layout)
        return SimNet(art, **kw) if art else SimNet(**kw)

    t0 = time.time()
    seq = [fresh().simulate(t, n_lanes=args.lanes, timeit=False) for t in traces]
    seq_wall = time.time() - t0
    packed = fresh().simulate_many(traces, n_lanes=args.lanes)
    _emit({
        "n_workloads": len(traces),
        "lanes_per_workload": args.lanes,
        "sequential": {"wall_seconds": seq_wall,
                       "ips": sum(r.total_instructions for r in seq) / seq_wall},
        "packed": {"wall_seconds": packed.first_call_seconds,
                   "ips": packed.throughput_ips},
        "speedup_wall": seq_wall / packed.first_call_seconds,
    })
    return 0


def cmd_lint(args) -> int:
    """Domain static analysis (the port's copy of the reference's
    stdlib-only analysis package, src/repro_torch/analysis): lock
    discipline, compile-cache-key completeness, determinism, exception
    hygiene. Exit 1 on any finding not in the committed baseline."""
    from repro_torch import analysis

    if args.list_rules:
        _emit({"rules": [
            {"id": r.rule_id, "family": r.family,
             "description": r.description}
            for r in analysis.ALL_RULES
        ]})
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = [r for part in args.rules for r in part.split(",") if r]
    paths = [Path(p) for p in (args.paths or ["src"])]
    try:
        findings, modules = analysis.run_lint(paths, rule_ids=rule_ids)
    except ValueError as e:  # unknown rule id
        print(f"repro lint: {e}", file=sys.stderr)
        return 2

    baseline_path = Path(args.baseline)
    if args.update_baseline:
        analysis.write_baseline(baseline_path, findings, modules)
        print(f"repro lint: wrote {len(findings)} finding(s) to "
              f"{baseline_path}", file=sys.stderr)
        return 0

    baseline = analysis.load_baseline(baseline_path)
    new, old, stale = analysis.split_by_baseline(findings, baseline, modules)
    if args.format == "json":
        _emit(analysis.render_json(new, old, stale))
    else:
        print(analysis.render_text(new, old, stale))
    return 1 if new else 0


# ---------------------------------------------------------------- parser

def _common(p, n_default=10000):
    p.add_argument("--bench", nargs="+", default=None,
                   help="benchmark names (see repro_torch.des.workloads)")
    p.add_argument("-n", type=int, default=n_default, help="instructions per benchmark")
    p.add_argument("--o3", choices=sorted(O3_CONFIGS), default="default",
                   help="processor configuration for the reference DES")
    p.add_argument("--cache-dir", default="artifacts/traces")
    p.add_argument("--lanes", type=int, default=8)
    p.add_argument("--quick", action="store_true", help="tiny settings (CI smoke)")


def _multicore_flags(p):
    p.add_argument("--multicore", type=int, default=None, metavar="N",
                   help="co-run N cores on the multicore DES (shared L2 + "
                        "bus + MSHRs); N defaults to the mix's natural "
                        "width when only --mix is given")
    p.add_argument("--mix", default=None,
                   help="co-run mix name (see `repro_torch trace --list`); "
                        "defaults to mix_stream_chase when --multicore is "
                        "given")


def _engine_flags(p):
    p.add_argument("--layout", choices=["ring", "roll"], default=None,
                   help="simulator step layout (default: the artifact's / "
                        "SimConfig default; totals are bit-identical, ring "
                        "is the fast path)")
    p.add_argument("--use-kernel", action="store_true",
                   help="run the hand-written CUDA predictor kernels (with "
                        "--layout ring and a c3 model: the fully fused "
                        "sim-step K1; --layout roll: the trunk kernel K2; "
                        "their plain versions on --device cpu)")


def _device_flag(p, default):
    p.add_argument("--device", choices=DEVICE_KINDS, default=default,
                   help="where every engine, dataset, trainer and replica "
                        "runs (default cuda; raises without a GPU — no "
                        "silent CPU fallback)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="SimNet: train latency predictors, simulate programs (JSON out)",
    )
    _device_flag(ap, "cuda")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("trace", help="run the reference DES, cache traces")
    _common(p)
    _multicore_flags(p)
    p.add_argument("--list", action="store_true",
                   help="enumerate benchmarks and multicore mixes as JSON")
    p.set_defaults(fn=cmd_trace, bench_default=["mlb_mixed"])

    p = sub.add_parser("train", help="train a predictor, save a PredictorArtifact")
    _common(p, n_default=20000)
    p.add_argument("--kind", default="c3")
    p.add_argument("--ctx-len", type=int, default=64)
    p.add_argument("--output", choices=["hybrid", "reg"], default="hybrid")
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--artifact", default=None, help="directory to save the artifact")
    p.add_argument("--eval-bench", nargs="+", default=None,
                   help="simulate these after training (reports CPI vs DES)")
    p.add_argument("--eval-n", type=int, default=None)
    p.set_defaults(fn=cmd_train, bench_default=["mlb_mixed", "mlb_branchy"])

    p = sub.add_parser("simulate", help="simulate benchmarks from a saved artifact")
    _common(p)
    _engine_flags(p)
    p.add_argument("--artifact", default=None,
                   help="PredictorArtifact directory (omit for teacher-forced replay)")
    p.add_argument("--timeit", action="store_true",
                   help="measure steady-state throughput (second compiled pass)")
    p.set_defaults(fn=cmd_simulate, bench_default=["sim_loop"])

    p = sub.add_parser("sweep", help="design-space sweep in one packed call")
    _common(p)
    _engine_flags(p)
    _multicore_flags(p)
    p.add_argument("--artifact", default=None,
                   help="PredictorArtifact directory (omit for teacher-forced replay)")
    p.add_argument("--param", choices=["l2", "bpred"], default="l2")
    p.add_argument("--points", nargs="+", default=None,
                   help="design points: l2 sizes in bytes, or bpred names")
    p.set_defaults(fn=cmd_sweep, bench_default=["sim_chase_mid"])

    p = sub.add_parser("serve", help="batch-mode SimServe over a JSON job file")
    _common(p)
    p.add_argument("--jobs", default=None,
                   help='JSON job file: {"models": {id: artifact_dir}, '
                        '"jobs": [{"id", "model", "bench", "n", "lanes", "o3"}]}'
                        " — omit it (with --http) for a standing server")
    p.add_argument("--model", action="append", metavar="ID=ARTIFACT_DIR",
                   help="make an artifact resident (repeatable; adds to the "
                        'job file\'s "models" map — the way `repro_torch fleet` '
                        "hands each replica subprocess its zoo)")
    p.add_argument("--chunk", type=int, default=1024,
                   help="streaming chunk cap (bucketed per batch)")
    p.add_argument("--async", dest="async_", action="store_true",
                   help="run the background drain loop: batches dispatch "
                        "while jobs are still being submitted, round-robin "
                        "across resident models")
    p.add_argument("--max-queue-depth", type=int, default=0,
                   help="admission control: refuse submits (QueueFull) past "
                        "this many pending jobs (0 = unbounded)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="async batch window: after the first pending job, "
                        "wait this long for batchmates before dispatching "
                        "(latency traded for pack density)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve over HTTP: bind the stdlib front-end on "
                        "PORT (0 = ephemeral) and round-trip the job file "
                        "through POST /v1/jobs + GET /v1/jobs/<id> as a "
                        "real network client")
    p.add_argument("--priority", type=int, default=0,
                   help="default QoS priority for submitted jobs (higher "
                        "= served sooner; a job file entry's own "
                        '"priority" wins)')
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-job deadline: jobs still queued this "
                        "many ms after submit fail loudly before dispatch "
                        '(a job file entry\'s own "deadline_ms" wins)')
    p.add_argument("--batch-timeout-s", type=float, default=0.0,
                   help="batch watchdog: a dispatch still running after "
                        "this many seconds fails its own jobs and the "
                        "drain loop keeps serving (0 = disabled)")
    p.add_argument("--faults", default=None, metavar="SPEC",
                   help="arm a deterministic fault plan, e.g. "
                        "'seed=7;compile=fail_once:1' (the REPRO_FAULTS "
                        "env var works everywhere; this flag wins)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "fleet",
        help="N replica subprocesses + the router tier over a JSON job file",
    )
    _common(p)
    p.add_argument("--jobs", required=True,
                   help="JSON job file (same shape as `serve`); jobs are "
                        "POSTed through the router as a real HTTP client")
    p.add_argument("--replicas", type=int, default=2,
                   help="SimServe replica subprocesses to spawn")
    p.add_argument("--http", type=int, default=0, metavar="PORT",
                   help="router port (0 = ephemeral; replicas always bind "
                        "ephemeral ports)")
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--max-queue-depth", type=int, default=0,
                   help="per-replica admission bound (QueueFull past it; "
                        "the router fails a full replica over to the next "
                        "candidate)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="per-replica async batch window")
    p.add_argument("--priority", type=int, default=0)
    p.add_argument("--deadline-ms", type=float, default=None)
    p.add_argument("--timeout", type=float, default=600.0,
                   help="overall client budget for submitting + polling")
    p.add_argument("--startup-timeout", type=float, default=180.0,
                   help="per-replica limit to announce its port")
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser(
        "chaos",
        help="seeded fault-injection drill: corrupt/fail/hang/poison the "
             "serving stack and assert the self-healing invariants",
    )
    p.add_argument("--seed", type=int, default=7,
                   help="fault-plan seed: the same seed reproduces the "
                        "same fault schedule bit-for-bit")
    p.add_argument("--quick", action="store_true",
                   help="CI-smoke sizing (shorter traces)")
    p.add_argument("--replicas", type=int, default=0,
                   help="also run the fleet drill with this many replica "
                        "subprocesses (transport drops + replica crash + "
                        "supervised restart; 0 = single-process drill only)")
    p.add_argument("--batch-timeout-s", type=float, default=10.0,
                   help="watchdog deadline the hung-batch fault must trip")
    p.add_argument("--out", default=None,
                   help="also write the JSON report here")
    p.set_defaults(fn=cmd_chaos)

    p = sub.add_parser("bench", help="packed vs sequential throughput microbench")
    _common(p, n_default=6000)
    _engine_flags(p)
    _multicore_flags(p)
    p.add_argument("--artifact", default=None)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "lint",
        help="domain static analysis: lock discipline, cache-key "
             "completeness, determinism, exception hygiene",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to lint (default: src)")
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.add_argument("--baseline", default="lint-baseline.json",
                   help="grandfathered-findings file (missing = empty)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from the current findings")
    p.add_argument("--rules", nargs="+", default=None,
                   help="run only these rule ids (space/comma separated)")
    p.add_argument("--list-rules", action="store_true",
                   help="print every registered rule as JSON and exit")
    p.set_defaults(fn=cmd_lint)

    # ``--device`` also after the subcommand (``serve --http 0 --device
    # cpu``, as a fleet spawns its replicas); absent there, the global
    # value stands
    for p in sub.choices.values():
        _device_flag(p, argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "bench", None) is None:
        args.bench = getattr(args, "bench_default", None)
    if getattr(args, "faults", None) is None:
        # REPRO_FAULTS arms the process-wide plan for ANY subcommand; an
        # explicit --faults flag (serve) wins and installs in cmd_serve
        from repro_torch.serving import faults
        faults.install_from_env()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
