"""SimNet public API — sessions, typed results, predictor artifacts — the
port of ``repro.core.api``.

The API is built around the `SimNet` session (`repro_torch.core.session`):
a trained latency predictor is a reusable artifact, and every simulation —
one workload, a multi-workload pack, a design-space sweep — runs through
the same chunked engine pack path, on ``cuda`` unless ``device="cpu"``.

    from repro_torch.core import api
    from repro_torch.core.api import SimNet
    from repro_torch.core.predictor import PredictorConfig

    # 1. ground truth: run the reference DES (cached as npz)
    traces = api.generate_traces(["mlb_mixed", "mlb_branchy"], 20_000)

    # 2. train once, save the artifact (params + PredictorConfig +
    #    SimConfig + training metadata in one atomic directory)
    sn = SimNet.train(traces, PredictorConfig(kind="c3"), epochs=6)
    sn.save("artifacts/models/c3")

    # 3. simulate anywhere — a later process reloads the artifact and
    #    reproduces the in-process results exactly
    sn = SimNet.from_artifact("artifacts/models/c3")
    res = sn.simulate(trace, n_lanes=64)          # SimResult
    many = sn.simulate_many(traces, n_lanes=8)    # one packed scan
    swept = sn.sweep({"256kB": tr0, "4MB": tr1})  # SweepResult, one pack

Results are frozen dataclasses (`repro_torch.core.results`) with
`.to_dict()` for JSON. Serving many concurrent requests / many resident
models is `SimServe` (`repro_torch.serving.service`): a session is just a
service with one client. The same flows are scriptable end-to-end via the
CLI:

    python -m repro_torch trace --bench mlb_mixed -n 20000
    python -m repro_torch train --bench mlb_mixed mlb_branchy --artifact m/c3
    python -m repro_torch simulate --artifact m/c3 --bench sim_loop
    python -m repro_torch sweep --artifact m/c3 --bench sim_chase
    python -m repro_torch serve --jobs jobs.json

`generate_traces`, `build_training_data`, `prediction_errors` and
`phase_cpis` are the data-side helpers. (The pre-session loose functions
`simulate` / `simulate_many` / `train_predictor` completed their one
deprecation release and are gone — use the session / service methods.)
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch._tree import tree_leaves
from repro_torch.core import features as F
from repro_torch.core.dataset import build_dataset
from repro_torch.core.predictor import make_predict_fn
from repro_torch.core.results import SimResult, SweepResult, TrainResult, WorkloadResult
from repro_torch.core.session import SimNet, prediction_errors
from repro_torch.core.simulator import SimConfig, simulate_trace
from repro_torch.des.o3 import O3Config, O3Simulator
from repro_torch.des.trace import Trace
from repro_torch.des.workloads import get_benchmark
from repro_torch.serving.service import SimServe

__all__ = [
    "SimNet", "SimServe",
    "SimResult", "SweepResult", "TrainResult", "WorkloadResult",
    "generate_traces", "generate_corun_traces", "build_training_data",
    "prediction_errors", "phase_cpis",
]


def generate_traces(
    benchmarks: Sequence[str],
    n_instructions: int,
    o3: Optional[O3Config] = None,
    cache_dir: Optional[str] = None,
) -> List[Trace]:
    """Run the reference DES over benchmarks (with optional npz caching)."""
    o3 = o3 or O3Config()
    sim = O3Simulator(o3)
    out = []
    for name in benchmarks:
        if cache_dir:
            p = Path(cache_dir) / f"{name}_{o3.name}_{n_instructions}.npz"
            if p.exists():
                out.append(Trace.load(p))
                continue
        prog = get_benchmark(name, n_instructions)
        tr = sim.run(prog)
        if cache_dir:
            Path(cache_dir).mkdir(parents=True, exist_ok=True)
            tr.save(p)
        out.append(tr)
    return out


def generate_corun_traces(
    mix: str,
    n_instructions: int,
    o3: Optional[O3Config] = None,
    mc=None,
    n_cores: Optional[int] = None,
    seed: int = 0,
    cache_dir: Optional[str] = None,
) -> List[Trace]:
    """Run the multicore DES over a co-run mix (with optional npz caching).

    Returns one `Trace` per core — same schema as single-core traces, but
    with contention-dependent latencies/levels baked in, so the feature
    pipeline, training and the packed engine consume them unchanged.
    Per-core lengths differ (mixes balance cycle time, not instruction
    count). `seed` selects the program instances: use one seed for
    training sets and a different one for held-out co-run evaluation.
    """
    from repro_torch.des.multicore import MulticoreConfig, MulticoreSim
    from repro_torch.des.workloads import get_mix

    o3 = o3 or O3Config()
    mc = mc if mc is not None else MulticoreConfig()
    progs = get_mix(mix, n_instructions, n_cores=n_cores, seed=seed)
    tag = f"{mix}_{o3.name}_{mc.cache_tag}_s{seed}_{n_instructions}"
    paths = (
        [Path(cache_dir) / f"{tag}_c{i}.npz" for i in range(len(progs))]
        if cache_dir
        else None
    )
    if paths and all(p.exists() for p in paths):
        return [Trace.load(p) for p in paths]
    traces, _ = MulticoreSim(o3, mc).run(progs)
    traces = [
        dataclasses.replace(t, name=f"{mix}_s{seed}_c{i}")
        for i, t in enumerate(traces)
    ]
    if paths:
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        for t, p in zip(traces, paths):
            t.save(p)
    return traces


def build_training_data(traces, sim_cfg: Optional[SimConfig] = None, **kw):
    return build_dataset(traces, sim_cfg or SimConfig(), **kw)


@torch.no_grad()
def phase_cpis(trace: Trace, params, pcfg, sim_cfg=None, n_lanes=16, window=10000):
    """Per-window CPI curves (paper Fig. 6): returns (simnet, des) arrays.

    Needs the per-step latency stream, which the streaming engine does not
    materialise (its memory is O(state)); this analysis path runs the
    one-shot step loop with per-step outputs instead, eagerly, on the
    device the params are on.
    """
    sim_cfg = sim_cfg or SimConfig(ctx_len=pcfg.ctx_len)
    arrs = F.trace_arrays(trace)
    predict = make_predict_fn(params, pcfg)
    dev = next(tree_leaves(params)).device
    res = simulate_trace(arrs, predict, sim_cfg, n_lanes, device=dev)
    lats = res["outs"]["lats"].cpu().numpy()  # (per, L, 3)
    fetch = np.swapaxes(lats[:, :, 0], 0, 1).reshape(-1)  # lane-major timeline
    des_fetch = trace.fetch_lat[: len(fetch)]
    k = len(fetch) // window
    sim_cpi = fetch[: k * window].reshape(k, window).sum(1) / window
    des_cpi = des_fetch[: k * window].reshape(k, window).sum(1) / window
    return sim_cpi, des_cpi
