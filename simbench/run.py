"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m simbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The program under test is the PyTorch and
CUDA port, ``repro_torch`` (under ``src/``): one
``SimNetEngine.simulate_many`` entry, shared by the mix's client threads,
each calling it in a closed loop with jobs drawn from the seed
(`simbench.traffic`). Set-up (``setup_s``) runs from the process's start
to the first timed call ready: imports, CUDA, the kernels' build or load,
the trace pool, the weights, the engine and each client's warm-up calls,
which build the chunk graph. ``--trace 0`` then measures for ``--seconds``
and reports the cell's end-to-end metrics; ``--trace 1`` profiles a few
calls of each client instead and reports its per-layer metrics, the
device's busy time and a ``breakdown``. Either way the reference
(`simbench.reference`) then recomputes a sample of the calls drawn from
the seed, and ``correct`` says whether the program's answers hold to the
cell's limits (``simbench/limits/<cell>.json``). The last line of standard
output is the result's JSON; the last lines of standard error are the
numbers compared, each beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from simbench import manifest, profile, traffic  # noqa: E402
from simbench.manifest import ROOT  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Call:
    client: int
    index: int
    jobs: list
    t0: float = 0.0
    t1: float = 0.0
    cycles: Optional[np.ndarray] = None
    overflow: Optional[np.ndarray] = None
    n_instructions: Optional[np.ndarray] = None
    error: Optional[str] = None


class Cell:
    """One cell's inputs and its program: the configuration, the mix, the
    pool, the weights and the engine."""

    def __init__(self, name: str, seed: int, device, mix_override: Optional[dict] = None,
                 limits_override: Optional[dict] = None):
        import torch

        from simbench.des.workloads import SIM_BENCHMARKS
        from simbench.weights import make_weights

        self.man = manifest.load()
        self.spec = manifest.cell(self.man, name)
        self.cfg = manifest.config(self.man, self.spec)
        self.mix = traffic.load_mix(manifest.mix_path(self.spec["traffic"]))
        self.mix.update(mix_override or {})
        self.limits = dict(manifest.limits(name), **(limits_override or {}))
        self.name, self.seed, self.device = name, seed, torch.device(device)
        self.programs = list(SIM_BENCHMARKS)
        self.pool = traffic.load_pool(self.programs, self.mix["pool_instructions"],
                                      directory=traffic.POOL_DIR)
        self.params = make_weights(self.cfg["predictor"], seed, self.device, self.cfg["sim"],
                                   self.pool)

        from repro_torch.core.predictor import PredictorConfig
        from repro_torch.core.simulator import SimConfig
        from repro_torch.serving.simnet_engine import SimNetEngine

        pred = dict(self.cfg["predictor"], channels=tuple(self.cfg["predictor"]["channels"]))
        self.sim_cfg = SimConfig(**self.cfg["sim"])
        self.engine = SimNetEngine(self.params, PredictorConfig(**pred), self.sim_cfg,
                                   use_kernel=self.cfg["engine"]["use_kernel"], device=self.device)

    def call(self, client: int, index: int) -> Call:
        """One call of the entry, timed from the call to the per-workload
        totals on the host."""
        jobs = traffic.call_jobs(self.mix, self.programs, self.seed, client, index)
        arrays = [traffic.job_arrays(self.pool, j) for j in jobs]
        cfgs = [dataclasses.replace(self.sim_cfg, retire_width=j.retire_width) for j in jobs]
        c = Call(client, index, jobs)
        c.t0 = time.perf_counter()
        try:
            res = self.engine.simulate_many(arrays, n_lanes=self.mix["lanes_per_job"],
                                            chunk=self.mix["chunk"], cfgs=cfgs)
            c.t1 = time.perf_counter()
            c.cycles, c.overflow = res["workload_cycles"], res["workload_overflow"]
            c.n_instructions = res["n_instructions"]
        # the benchmark counts a failed call and goes on; correct turns false
        except Exception as e:  # noqa: BLE001
            c.t1 = time.perf_counter()
            c.error = f"{type(e).__name__}: {e}"
        return c


def run_clients(cell: Cell, between, seconds=None, calls_each=None):
    """Each client's warm-up calls, then ``between()`` once all are done
    (it returns the window's start on the ``perf_counter`` clock), then
    each client's calls until ``seconds`` after that start (a client starts
    no call later) or ``calls_each`` calls. Returns (window calls, start)."""
    n = cell.mix["clients"]
    ready, go = threading.Barrier(n + 1), threading.Barrier(n + 1)
    warm: List[Call] = []
    done: List[Call] = []
    state = {}

    def client(c: int):
        for i in range(cell.mix["warmup_calls"]):
            warm.append(cell.call(c, -1 - i))
        ready.wait()
        go.wait()
        i = 0
        while True:
            if calls_each is not None and i >= calls_each:
                break
            if calls_each is None and time.perf_counter() >= state["stop"]:
                break
            done.append(cell.call(c, i))
            i += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"client{c}") for c in range(n)]
    for t in threads:
        t.start()
    try:
        ready.wait()
        failed = [c.error for c in warm if c.error]
        if failed:
            raise RuntimeError(f"a warm-up call failed: {failed[0]}")
        t_go = between()
        state["stop"] = t_go + (seconds or 0.0)
        go.wait()
    except BaseException:
        ready.abort()
        go.abort()
        raise
    finally:
        for t in threads:
            t.join()
    return done, t_go


def sample(cell: Cell, calls: List[Call]) -> List[tuple]:
    """(call, job index, job) of every job of a sample of the completed
    calls, ``check_calls`` of them drawn from the seed."""
    ok = [c for c in calls if c.error is None]
    rng = np.random.default_rng(traffic.seed_words(cell.seed) + [0xC4EC])
    k = min(cell.mix["check_calls"], len(ok))
    picked = [ok[i] for i in sorted(rng.choice(len(ok), size=k, replace=False))] if k else []
    return [(c, j, job) for c in picked for j, job in enumerate(c.jobs)]


def reference_totals(cell: Cell, jobs: List[tuple], precision: str = "f32") -> List[dict]:
    """The reference's per-job totals of ``jobs`` (from `sample`)."""
    from simbench import reference

    return reference.simulate(
        [{"arrays": traffic.job_arrays(cell.pool, job), "retire_width": job.retire_width,
          "lanes": job.lanes} for _, _, job in jobs],
        cell.params, cell.cfg["predictor"], cell.cfg["sim"], cell.device, precision=precision)


def answer_gap(answers: List[dict], ref: List[dict]) -> float:
    """Mean over jobs of |cycles - the reference's| + |overflow - the
    reference's|, as a share of the reference's cycles."""
    gaps = [(abs(a["cycles"] - r["cycles"]) + abs(a["overflow"] - r["overflow"]))
            / max(r["cycles"], 1.0) for a, r in zip(answers, ref)]
    return float(np.mean(gaps)) if gaps else float("inf")


def answers(jobs: List[tuple]) -> List[dict]:
    """The program's per-job totals of ``jobs`` (from `sample`)."""
    return [{"cycles": float(c.cycles[j]), "overflow": int(c.overflow[j]),
             "instructions": int(c.n_instructions[j])} for c, j, _ in jobs]


def check_numbers(calls: List[Call], jobs: List[tuple], got: List[dict],
                  ref: List[dict]) -> dict:
    """The numbers compared: ``got``, the per-job totals of ``jobs`` (from
    `sample`), against the reference's, and the window's ``calls``. A job
    of ``got`` without ``instructions`` counts as simulating all of its own."""
    return {
        "answer_gap_mean": answer_gap(got, ref),
        "instr_mismatch": sum(g.get("instructions", job.instructions) != job.instructions
                              for g, (_, _, job) in zip(got, jobs)),
        "failed_calls": sum(c.error is not None for c in calls),
        "checked_jobs": len(jobs),
    }


def check(cell: Cell, calls: List[Call]) -> dict:
    """The reference's totals of a sample of the completed calls, drawn
    from the seed, against the program's: the numbers compared."""
    jobs = sample(cell, calls)
    return check_numbers(calls, jobs, answers(jobs), reference_totals(cell, jobs))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, and at least the limits' least count of jobs checked."""
    table = {
        "answer_gap_mean": (numbers["answer_gap_mean"], limits["answer_gap_mean"]["limit"]),
        "instr_mismatch": (numbers["instr_mismatch"], 0),
        "failed_calls": (numbers["failed_calls"], 0),
    }
    correct = all(v <= lim for v, lim in table.values())
    correct &= numbers["checked_jobs"] >= limits["min_checked_jobs"]
    out = {k: {"value": v, "limit": lim} for k, (v, lim) in table.items()}
    out["checked_jobs"] = {"value": numbers["checked_jobs"], "limit": limits["min_checked_jobs"]}
    return correct, out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class _Spans:
    """In a traced run: the engine's calls of ``pack_workloads`` and
    ``pad_packed_lanes`` ("pack") and of its passes over the chunk
    program ("passes": the wait for the program's lock, the copies in, the
    replays and the read-out), each kept as (thread, label, start, end) on
    the host's clock. The program is not changed: its module's names are
    wrapped while the traced window runs."""

    def __init__(self):
        from repro_torch.serving import simnet_engine as se

        self.se = se
        self.saved = {k: getattr(se, k) for k in ("pack_workloads", "pad_packed_lanes",
                                                   "_run_passes")}
        self.spans: List[tuple] = []

    def _wrap(self, fn, label):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((threading.current_thread().name, label, t0,
                                   time.perf_counter()))
        return wrapped

    def __enter__(self):
        for k, fn in self.saved.items():
            setattr(self.se, k, self._wrap(fn, "passes" if k == "_run_passes" else "pack"))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.se, k, fn)
        return False

    def pack_seconds(self, calls) -> List[float]:
        """Each call's seconds in "pack" spans."""
        return [sum(t1 - t0 for th, lab, t0, t1 in self.spans
                    if lab == "pack" and th == f"client{c.client}" and c.t0 <= t0 and t1 <= c.t1)
                for c in calls]


def run(name: str, seed: int, seconds: float, traced: bool, device=None,
        mix_override: Optional[dict] = None, limits_override: Optional[dict] = None) -> dict:
    """One run of cell ``name``; returns the result (``device`` None: the
    card, which must be there)."""
    import torch

    import repro_torch  # noqa: F401  (the program under test: without it, no run)

    torch.set_num_threads(1)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = manifest.cell(manifest.load(), name)
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < spec["chips"]:
            raise SystemExit(f"no result: cell {name} needs {spec['chips']} CUDA device(s), "
                             f"found {found}")
        device = "cuda:0"
    cell = Cell(name, seed, device, mix_override, limits_override)
    dev = cell.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    cache_before = cell.engine.cache.counters()
    rec = {"cell": name, "cfg": cell.cfg, "mix": cell.mix}

    def set_up():
        rec["setup_s"] = time.perf_counter() - T_START
        rec["cache_setup"] = cell.engine.cache.delta_since(cache_before)

    if not traced:
        def between():
            set_up()
            return time.perf_counter()

        calls, t_go = run_clients(cell, between, seconds=seconds)
    else:
        from torch.profiler import ProfilerActivity, profile as tprofile, record_function, schedule

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = tprofile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        spans = _Spans()
        window = record_function(profile.WINDOW_SPAN)

        def between():
            set_up()
            prof.start()
            cell.call(0, -1000)  # the profiler's warm-up step replays the graph once
            if on_card:
                torch.cuda.synchronize(dev)
            prof.step()
            spans.__enter__()
            window.__enter__()
            return time.perf_counter()

        try:
            calls, t_go = run_clients(cell, between, calls_each=cell.mix["trace_calls"])
            if on_card:
                torch.cuda.synchronize(dev)
            window.__exit__(None, None, None)
            prof.step()
        finally:
            spans.__exit__()
            prof.stop()
    log(f"window: {len(calls)} calls, {time.perf_counter() - t_go:.3f} s after its start")
    t_end = max([c.t1 for c in calls], default=t_go)
    rec["window_host_s"] = t_end - t_go
    ok = [c for c in calls if c.error is None]
    rec["instructions"] = sum(j.instructions for c in ok for j in c.jobs)
    rec["latencies_s"] = [c.t1 - c.t0 for c in ok]
    rec["lanes"] = _lanes(cell.mix)
    rec["steps"] = len(ok) * _steps(cell.mix)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                     "count": spec["chips"], "memory_peak_bytes": memory_peak}
    breakdown = None
    if traced:
        rec["pack_s"] = spans.pack_seconds(ok)
        if on_card:
            t_red = time.perf_counter()
            host = [(f"{th}.{lab}", t0 - t_go, t1 - t_go) for th, lab, t0, t1 in spans.spans]
            host += [(f"client{c.client}.call", c.t0 - t_go, c.t1 - t_go) for c in calls]
            tr = profile.reduce(prof.events(), host)
            rec.update(profile.summary(tr))
            rec["kernels"] = profile.kernels(tr)
            breakdown = profile.breakdown(tr)
            result_device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
            log(f"trace: {len(tr['ops'])} device operations, read in "
                f"{time.perf_counter() - t_red:.3f} s")
    metrics = {}
    for m in manifest.metrics(cell.man, name, traced):
        value = manifest.reader(m["name"])(rec)
        if value is None:
            if not traced:
                raise RuntimeError(f"the end-to-end metric {m['name']} read nothing")
            log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs
    cell.engine.cache.clear()
    cell.engine = None
    if on_card:
        torch.cuda.empty_cache()
        log(f"card: {card_line()}")
    t_check = time.perf_counter()
    numbers = check(cell, calls)
    log(f"check: {numbers['checked_jobs']} jobs in {time.perf_counter() - t_check:.3f} s")
    correct, table = judge(numbers, cell.limits)
    result = {"correct": bool(correct), "attempted": len(calls), "failed": numbers["failed_calls"],
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = table
    for k, v in table.items():
        log(f"check {k}: {v['value']} limit {v['limit']}")
    # last, after the metrics' readers and the reference have run too
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"no result: the run loaded {bad} (jax, jaxlib, flax and repro are not "
                         "allowed in a run of the port)")
    return result


def _lanes(mix: dict) -> int:
    return mix["workloads_per_call"] * len(mix["retire_widths"]) * mix["lanes_per_job"]


def _steps(mix: dict) -> int:
    per = mix["job_instructions"] // mix["lanes_per_job"]
    return -(-per // mix["chunk"]) * mix["chunk"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
