"""Seeded chaos drills over the serving stack — the port of
``repro.serving.chaos``, run on the drills' ``device`` (default ``cuda``;
the fleet drill hands it to every replica).

Two drills, both driven by a deterministic :class:`FaultPlan` so a seed
reproduces the exact fault schedule bit-for-bit:

* ``run_chaos_single`` — one in-process ``SimServe`` with faults armed at
  four sites (``artifact.load`` corrupt, ``compile`` fail-once,
  ``batch.execute`` hang beyond the watchdog, ``batch.numeric`` NaN
  poison). The drill drains inline — no background loop — so the batch
  order, and therefore the site arrival each fault lands on, is a pure
  function of the seed. Every non-faulted job must finish bit-identical
  to a fault-free baseline; the corrupt model must be breaker-isolated
  while the others keep serving.

* ``run_chaos_fleet`` — a real replica fleet behind the router. Client-
  side faults (``http.request`` drops, a ``replica.crash`` fired through
  the supervisor) plus a replica-side plan handed to each subprocess via
  ``--faults`` (compile failure, hung batch, NaN poison), plus an
  on-disk corrupt artifact every replica tolerates at registration.
  Router retries and the fleet supervisor must deliver every job
  bit-identical to the in-process baseline with zero jobs lost, the
  crashed replica restarted and readmitted.

The drills return plain dicts (JSON-able) with an ``ok`` flag and a
per-invariant ``checks`` map so the CLI / CI can assert on them.

The tiny model's weights come from the port's own `init_predictor` and a
seeded ``torch.Generator``, so they differ from the reference drill's
(which seeds ``jax.random.PRNGKey``). That is harmless: every check
compares runs inside this package against a fault-free baseline of the
same weights.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import ArtifactCorrupt
from repro_torch.serving import faults
from repro_torch.serving.faults import FaultPlan, FaultSpec

# Tiny, ragged on purpose — compile cost is the drill's floor, keep it low.
_STYLES = ("mlb_stream", "sim_loop", "mlb_branchy")
_SIZES_QUICK = (1200, 900, 1000)
_SIZES_FULL = (3000, 2000, 2600)
_LANES = (4, 2, 8)

# A delay far beyond any drill's runtime: the hung dispatch thread is
# abandoned by the watchdog and must never wake up *during* the drill —
# that keeps its later site arrivals out of the deterministic schedule.
_HANG_MS = 600_000.0


def make_traces(quick: bool = True):
    from repro_torch.des.o3 import O3Config, O3Simulator
    from repro_torch.des.workloads import get_benchmark

    sizes = _SIZES_QUICK if quick else _SIZES_FULL
    sim = O3Simulator(O3Config())
    return [sim.run(get_benchmark(n, s)) for n, s in zip(_STYLES, sizes)]


def make_tiny_artifact(path, key: int = 7) -> Path:
    """A real (untrained) predictor artifact — cheap enough for CI. Its
    weights are drawn on the CPU from ``torch.Generator().manual_seed(key)``
    (the same bytes whichever device later loads them)."""
    import torch

    from repro_torch.checkpoint.artifact import PredictorArtifact
    from repro_torch.core.predictor import PredictorConfig, init_predictor
    from repro_torch.core.simulator import SimConfig

    pcfg = PredictorConfig(kind="c1", ctx_len=16, channels=(16, 16, 16), hidden=32)
    params = init_predictor(torch.Generator().manual_seed(key), pcfg, device="cpu")
    art = PredictorArtifact(params=params, pcfg=pcfg,
                            sim_cfg=SimConfig(ctx_len=16),
                            metadata={"origin": "chaos-drill"})
    return art.save(path)


def corrupt_artifact_copy(src, dst) -> Path:
    """Copy an artifact dir and flip one payload byte in its newest step —
    the on-disk bit-rot the sha256 manifest guard must catch."""
    src, dst = Path(src), Path(dst)
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    steps = sorted(dst.glob("step_*/arrays.npz"))
    if not steps:
        raise FileNotFoundError(f"no step_*/arrays.npz under {dst}")
    payload = bytearray(steps[-1].read_bytes())
    payload[len(payload) // 2] ^= 0xFF
    steps[-1].write_bytes(bytes(payload))
    return dst


def _schedule_digest(plan: FaultPlan) -> str:
    """sha256 over the decisions the plan actually made — two runs of the
    same seed over the same arrival sequence must produce the same digest."""
    log = json.dumps(plan.decision_log(), sort_keys=True).encode()
    return hashlib.sha256(log).hexdigest()


def _settle(serve, jobs: Dict[str, Tuple[Any, str, int]], *,
            max_rounds: int = 8) -> Tuple[Dict[str, float], int, int]:
    """Submit ``jobs`` (name -> (trace, model, lanes)), drain inline until
    every job holds a result, resubmitting batch-failed jobs. Returns
    (totals by name, resubmit count, drain error count)."""
    handles = {n: serve.submit(tr, mid, n_lanes=ln)
               for n, (tr, mid, ln) in jobs.items()}
    totals: Dict[str, float] = {}
    resubmits = drain_errors = 0
    for _ in range(max_rounds):
        while serve.pending:
            try:
                serve.drain()
            # the drill injects faults at arbitrary sites, so the drain
            # error type is unbounded by design — count and carry on
            except Exception:  # repro-lint: disable=hygiene-broad-except — fault sites raise arbitrary injected errors
                drain_errors += 1
        for name in sorted(set(jobs) - set(totals)):
            try:
                totals[name] = handles[name].result().total_cycles
            # every batch failure surfaces as a RuntimeError subclass
            # (FaultInjected, BatchTimeout, NumericError, cancellation);
            # TimeoutError covers a result() wait that gave up
            except (RuntimeError, TimeoutError):
                tr, mid, ln = jobs[name]
                handles[name] = serve.submit(tr, mid, n_lanes=ln)
                resubmits += 1
        if len(totals) == len(jobs):
            break
    return totals, resubmits, drain_errors


def run_chaos_single(*, seed: int = 7, quick: bool = True,
                     batch_timeout_s: float = 10.0,
                     artifact_dir: Optional[str] = None,
                     device: str = "cuda") -> Dict[str, Any]:
    """Single-process chaos drill. See module docstring for the script."""
    from repro_torch.core.simulator import SimConfig
    from repro_torch.serving.compile_cache import CompileCache
    from repro_torch.serving.http import SimServeHTTP, http_request
    from repro_torch.serving.service import SimServe

    t_start = time.time()
    traces = make_traces(quick)
    tmp_ctx = None
    try:
        if artifact_dir is None:
            tmp_ctx = tempfile.TemporaryDirectory(prefix="repro-torch-chaos-")
            artifact_dir = str(Path(tmp_ctx.name) / "model")
            make_tiny_artifact(artifact_dir, key=seed)

        jobs = {f"{mid}/{tr.name}": (tr, mid, ln)
                for mid in ("tf", "m")
                for tr, ln in zip(traces, _LANES)}

        # --- fault-free baseline --------------------------------------
        faults.clear()
        base = SimServe(cache=CompileCache(), device=device)
        base.register("tf", sim_cfg=SimConfig(ctx_len=16))
        base.register("m", artifact_dir)
        baseline, _, base_errs = _settle(base, jobs)
        assert base_errs == 0 and len(baseline) == len(jobs)

        # --- chaos run ------------------------------------------------
        # A private CompileCache guarantees real builds, so the compile
        # site actually fires. Inline drains make arrival order — and
        # therefore which batch each fault lands on — seed-deterministic.
        plan = FaultPlan(seed, {
            "artifact.load": FaultSpec(corrupt=1),
            "compile": FaultSpec(fail_once=1),
            "batch.execute": FaultSpec(delay_ms=_HANG_MS, delay_once=1),
            "batch.numeric": FaultSpec(corrupt=1),
        })
        faults.install(plan)
        serve = SimServe(cache=CompileCache(), batch_timeout_s=batch_timeout_s,
                         device=device)

        # The corrupt model registers FIRST so artifact.load arrival 1 —
        # the corrupted one — deterministically hits it.
        corrupt_error = None
        try:
            serve.register("corrupt-model", artifact_dir)
        except ArtifactCorrupt as e:  # breaker already tripped
            corrupt_error = type(e).__name__
        serve.register("tf", sim_cfg=SimConfig(ctx_len=16))
        serve.register("m", artifact_dir)

        totals, resubmits, drain_errors = _settle(serve, jobs)
        st = serve.stats()
        snap = faults.snapshot()

        # degraded health over the real wire: the open breaker must turn
        # /v1/healthz to 200 {"status": "degraded", ...}
        with SimServeHTTP(serve) as front:
            hz_status, hz = http_request(f"{front.url}/v1/healthz")
        serve.stop()
        faults.clear()

        breakers = st["breakers"]
        checks = {
            "survivors_bit_identical": totals == baseline,
            "zero_jobs_lost": len(totals) == len(jobs),
            "zero_jobs_duplicated": st["jobs_completed"] == len(jobs),
            "corrupt_artifact_detected": corrupt_error == "ArtifactCorrupt",
            "corrupt_model_isolated":
                breakers.get("corrupt-model", {}).get("state") == "open",
            "others_kept_serving": all(
                breakers.get(m, {}).get("state", "closed") == "closed"
                for m in ("tf", "m")),
            "compile_fault_fired": snap["sites"]["compile"]["fails"] >= 1,
            "watchdog_fired": st["batches_timed_out"] >= 1,
            "numeric_guard_fired": st["jobs_failed_numeric"] >= 1,
            "healthz_degraded": (hz_status == 200
                                 and hz.get("status") == "degraded"
                                 and "corrupt-model" in hz.get("open_breakers", [])),
        }
        return {
            "drill": "single",
            "ok": all(checks.values()),
            "checks": checks,
            "seed": seed,
            "spec": plan.to_spec(),
            "schedule_digest": _schedule_digest(plan),
            "n_jobs": len(jobs),
            "resubmits": resubmits,
            "drain_errors": drain_errors,
            "fault_snapshot": snap,
            "counters": {k: st[k] for k in
                         ("jobs_completed", "jobs_failed_numeric",
                          "batches_timed_out", "batches")},
            "wall_seconds": time.time() - t_start,
        }
    finally:
        faults.clear()
        if tmp_ctx is not None:
            tmp_ctx.cleanup()


def run_chaos_fleet(*, seed: int = 7, n_replicas: int = 2, quick: bool = True,
                    batch_timeout_s: float = 30.0,
                    timeout_s: float = 600.0,
                    device: str = "cuda") -> Dict[str, Any]:
    """Fleet chaos drill — all five sites at once. See module docstring."""
    from repro_torch.core import features as F
    from repro_torch.core.simulator import SimConfig
    from repro_torch.serving.compile_cache import CompileCache
    from repro_torch.serving.fleet import Fleet
    from repro_torch.serving.http import http_request
    from repro_torch.serving.router import route_jobs
    from repro_torch.serving.service import SimServe

    t_start = time.time()
    traces = make_traces(quick)
    with tempfile.TemporaryDirectory(prefix="repro-torch-chaos-fleet-") as tmp:
        tmp = Path(tmp)
        models = {}
        for i in range(2):
            mid = f"m{i}"
            make_tiny_artifact(tmp / mid, key=seed + i)
            models[mid] = str(tmp / mid)
        # every replica also boots with a bit-rotted artifact: the sha256
        # guard must trip its breaker at registration while the replica
        # keeps serving the healthy residents (healthz turns "degraded")
        corrupt_artifact_copy(tmp / "m0", tmp / "corrupt")
        fleet_models = dict(models, corrupt=str(tmp / "corrupt"))

        grid = [(mid, tr, ln) for mid in models
                for tr, ln in zip(traces, _LANES)]
        wire = {tr.name: {k: np.asarray(v).tolist()
                          for k, v in F.trace_arrays(tr).items()}
                for tr in traces}
        payloads = [{"id": f"chaos-{c}", "trace": wire[tr.name],
                     "model": mid, "lanes": ln}
                    for c, (mid, tr, ln) in enumerate(grid)]

        # --- in-process fault-free baseline ---------------------------
        faults.clear()
        base = SimServe(cache=CompileCache(), device=device)
        for mid, path in models.items():
            base.register(mid, path)
        jobs = {f"chaos-{c}": (tr, mid, ln)
                for c, (mid, tr, ln) in enumerate(grid)}
        baseline, _, base_errs = _settle(base, jobs)
        assert base_errs == 0 and len(baseline) == len(jobs)

        # --- chaos fleet ----------------------------------------------
        # Replica-side plan (each subprocess arms its own copy): one
        # failed compile, one hung batch for the watchdog, one NaN batch.
        replica_spec = (f"seed={seed}"
                        f";compile=fail_once:1"
                        f";batch.execute=delay_ms:{_HANG_MS:.0f},delay_once:1"
                        f";batch.numeric=corrupt:1")
        # Driver-side plan: transport drops (before the bytes leave, so a
        # retry can never duplicate work) and one supervisor-fired crash.
        client_plan = FaultPlan(seed, {
            "http.request": FaultSpec(after=5, fail_rate=0.05),
            "replica.crash": FaultSpec(after=3, fail_once=1),
        })
        result: Dict[str, Any] = {"drill": "fleet", "seed": seed,
                                  "n_replicas": n_replicas,
                                  "replica_spec": replica_spec,
                                  "client_spec": client_plan.to_spec(),
                                  "n_jobs": len(payloads)}
        try:
            faults.install(client_plan)
            with Fleet(n_replicas, models=fleet_models, max_wait_ms=25.0,
                       batch_timeout_s=batch_timeout_s,
                       replica_faults=replica_spec,
                       supervise=True, restart_budget=3,
                       stop_grace_s=5.0, device=device) as fleet:
                entries = route_jobs(fleet.url, payloads,
                                     timeout=timeout_s, retry_failed=6)
                client_snap = faults.snapshot()
                faults.clear()  # drill over: stats/healthz ride clean wire

                # let the supervisor finish restarting the crashed replica
                # and the prober readmit it before reading the counters
                deadline = time.time() + 120.0
                while time.time() < deadline:
                    fst = fleet.stats()
                    sup = fst.get("supervisor", {})
                    healthy = fst["router"]["healthy_replicas"]
                    if (sup.get("chaos_kills", 0) >= 1
                            and sup.get("restarts_total", 0) >= 1
                            and healthy >= n_replicas):
                        break
                    time.sleep(0.5)
                fst = fleet.stats()
                _, hz = http_request(f"{fleet.url}/v1/healthz")

            totals = {e["id"]: e["result"]["total_cycles"]
                      for e in entries if e["status"] == "done"}
            sup = fst.get("supervisor", {})
            degraded = hz.get("degraded", {})
            checks = {
                "survivors_bit_identical": totals == baseline,
                "zero_jobs_lost":
                    sum(e["status"] == "done" for e in entries) == len(payloads),
                "replica_crashed": sup.get("chaos_kills", 0) >= 1,
                "replica_restarted": sup.get("restarts_total", 0) >= 1,
                "replica_readmitted": fst["router"]["readmissions"] >= 1,
                "corrupt_model_degraded_everywhere": all(
                    "corrupt" in opens for opens in degraded.values())
                    and len(degraded) >= 1,
                "watchdog_fired_in_replica":
                    fst["fleet"].get("batches_timed_out", 0) >= 1,
                "numeric_guard_fired_in_replica":
                    fst["fleet"].get("jobs_failed_numeric", 0) >= 1,
            }
            result.update({
                "ok": all(checks.values()),
                "checks": checks,
                "client_fault_snapshot": client_snap,
                "schedule_digest": _schedule_digest(client_plan),
                "resubmits": sum(e["resubmits"] for e in entries),
                "supervisor": sup,
                "router": {k: fst["router"].get(k) for k in
                           ("ejections", "readmissions", "failovers",
                            "jobs_routed")},
                "healthz": {"status": hz.get("status"),
                            "degraded": degraded},
                "wall_seconds": time.time() - t_start,
            })
            return result
        finally:
            faults.clear()


def run_chaos(*, seed: int = 7, quick: bool = True, replicas: int = 0,
              batch_timeout_s: float = 10.0,
              device: str = "cuda") -> Dict[str, Any]:
    """CLI entry: the single-process drill, plus the fleet drill when
    ``replicas`` > 0, both on ``device``."""
    out: Dict[str, Any] = {"seed": seed, "quick": quick}
    out["single"] = run_chaos_single(seed=seed, quick=quick,
                                     batch_timeout_s=batch_timeout_s,
                                     device=device)
    ok = out["single"]["ok"]
    if replicas > 0:
        out["fleet"] = run_chaos_fleet(seed=seed, quick=quick,
                                       n_replicas=replicas,
                                       batch_timeout_s=max(batch_timeout_s, 20.0),
                                       device=device)
        ok = ok and out["fleet"]["ok"]
    out["ok"] = ok
    return out
