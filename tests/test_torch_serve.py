"""The port's `SimServe` (and its registry) against the reference's: the
scenarios of the reference's service, async and QoS tests, each driven
once through each package with the same workloads and, where the clock
matters, the same fake clock.

A scenario asserts its own contract (one batch per model, round-robin,
priority/EDF/aging order, QueueFull, DeadlineExceeded, the breaker's trip
and half-open probe, cancel, the watchdog's BatchTimeout) and returns what
it observed, times left out: dispatch order, each batch's jobs and lanes,
counters, error types and every job's total. The port's observation must
equal the reference's.
"""
import threading
import types

import numpy as np
import pytest
from conftest import synth_arrays

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.serving.faults as ref_faults  # noqa: E402
import repro.serving.service as ref_service  # noqa: E402
import repro_torch.serving.faults as port_faults  # noqa: E402
import repro_torch.serving.service as port_service  # noqa: E402
from repro.core.predictor import PredictorConfig as RefPredictorConfig  # noqa: E402
from repro.core.predictor import init_predictor as ref_init_predictor  # noqa: E402
from repro.core.session import SimNet as RefSimNet  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.serving.compile_cache import CompileCache as RefCache  # noqa: E402
from repro_torch.core.predictor import PredictorConfig, params_from_numpy  # noqa: E402
from repro_torch.core.session import SimNet  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.serving.compile_cache import CompileCache  # noqa: E402

TRACES = {f"w{i}": synth_arrays(48 + 16 * i, 10 + i) for i in range(3)}
MODELS = ("alpha", "beta")
ZOO_PCFG = dict(kind="c1", ctx_len=16, channels=(16, 16, 16), hidden=32)


class FakeClock:
    """A manually advanced monotonic clock (seconds)."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _package(name):
    """What a scenario needs of one package. Each keeps one program cache
    for its teacher-forced runs, so a shape is built once a module."""
    if name == "ref":
        return types.SimpleNamespace(
            name=name, svc=ref_service, faults=ref_faults, SimConfig=RefSimConfig,
            CompileCache=RefCache, SimNet=RefSimNet, cache=RefCache(), kw={},
            params=lambda tree, pcfg: tree, PredictorConfig=RefPredictorConfig)
    return types.SimpleNamespace(
        name=name, svc=port_service, faults=port_faults, SimConfig=SimConfig,
        CompileCache=CompileCache, SimNet=SimNet, cache=CompileCache(), kw={"device": "cpu"},
        params=lambda tree, pcfg: params_from_numpy(tree, pcfg, "cpu"),
        PredictorConfig=PredictorConfig)


PKGS = {name: _package(name) for name in ("ref", "port")}


def make_serve(P, clock=None, models=MODELS, cache=None, **kw):
    serve = P.svc.SimServe(clock=clock or FakeClock(), cache=cache or P.cache, **P.kw, **kw)
    for mid in models:
        serve.register(mid, sim_cfg=P.SimConfig(ctx_len=8))
    return serve


def batches(reports):
    return [(r.model_id, r.job_ids, r.n_jobs, r.n_live_lanes, r.n_lanes, r.chunk,
             r.total_instructions) for r in reports]


def fail_engine(serve, model_id, error="device lost"):
    """Make one resident engine's dispatch raise; returns the restorer."""
    engine = serve.registry.get(model_id)

    def boom(*a, **k):
        raise RuntimeError(error)

    engine.simulate_many = boom
    return lambda: delattr(engine, "simulate_many")


def zoo_weights(_memo=[]):
    """The zoo's three c1 weight sets as numpy trees, drawn once by the
    reference's initialiser and handed to both packages."""
    if not _memo:
        pcfg = RefPredictorConfig(**ZOO_PCFG)
        _memo.extend(jax.tree_util.tree_map(np.asarray, ref_init_predictor(
            jax.random.PRNGKey(i), pcfg)[0]) for i in range(3))
    return _memo


# ---------------------------------------------------------------- scenarios

def sc_zoo_one_batch_per_model_and_cache_reuse(P):
    """Three resident models of one kind, three workloads each: one batch
    per model, one program built and reused by the other two, and each
    model's totals equal its own session's."""
    pcfg = P.PredictorConfig(**ZOO_PCFG)
    zoo = {f"m{i}": P.params(w, pcfg) for i, w in enumerate(zoo_weights())}
    cache = P.CompileCache()
    serve = P.svc.SimServe(cache=cache, chunk=512, **P.kw)
    for mid, params in zoo.items():
        serve.register(mid, params=params, pcfg=pcfg, sim_cfg=P.SimConfig(ctx_len=16))
    handles = {(mid, w): serve.submit(TRACES[w], mid, n_lanes=2, name=w)
               for mid in zoo for w in sorted(TRACES)}
    reports = serve.drain()
    st = serve.stats()
    assert st["batches"] == 3 and [r.n_jobs for r in reports] == [3, 3, 3]
    assert st["cache"]["misses"] == 1 and st["cache"]["n_executables"] == 1
    assert st["cache"]["hits"] >= st["cache"]["misses"]
    totals = {k: h.result().total_cycles for k, h in handles.items()}
    for mid, params in zoo.items():
        sn = P.SimNet(params=params, pcfg=pcfg, sim_cfg=P.SimConfig(ctx_len=16),
                      cache=cache, chunk=512, **P.kw)
        res = sn.simulate_many([TRACES[w] for w in sorted(TRACES)], n_lanes=2)
        assert [w.total_cycles for w in res] == [totals[(mid, w)] for w in sorted(TRACES)]
    assert cache.stats()["misses"] == 1  # the sessions hit the same program
    return {"batches": batches(reports), "totals": sorted(totals.items()),
            "cache": {k: st["cache"][k] for k in ("hits", "misses", "n_executables")}}


def sc_background_loop_equals_sync_drain(P):
    """Client threads against the background drain loop, each waiting on
    its own handles: every total equals a synchronous drain's."""
    sync = make_serve(P)
    jobs = [(w, mid) for mid in MODELS for w in sorted(TRACES)] * 2
    want = [sync.submit(TRACES[w], mid, n_lanes=2) for w, mid in jobs]
    sync.drain()
    want = [h.result().total_cycles for h in want]
    got = [None] * len(jobs)
    with make_serve(P, clock=None, max_wait_ms=10.0) as serve:
        def client(lo):
            for i in range(lo, len(jobs), 4):
                w, mid = jobs[i]
                got[i] = serve.submit(TRACES[w], mid, n_lanes=2).result(timeout=120)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
        st = serve.stats()
    assert [r.total_cycles for r in got] == want
    assert st["loop_errors"] == 0 and st["jobs_completed"] == len(jobs)
    return {"totals": want}


def sc_queue_full_backpressure(P):
    serve = make_serve(P, max_queue_depth=2)
    serve.submit(TRACES["w0"], "alpha", n_lanes=2)
    serve.submit(TRACES["w1"], "alpha", n_lanes=2)
    with pytest.raises(P.svc.QueueFull, match="max_queue_depth=2"):
        serve.submit(TRACES["w2"], "alpha", n_lanes=2)
    st = serve.stats()
    assert st["jobs_rejected"] == 1 and st["jobs_pending"] == 2  # nothing enqueued
    first = serve.drain()
    h = serve.submit(TRACES["w2"], "alpha", n_lanes=2)  # admitted again
    serve.drain()
    return {"batches": batches(first), "total": h.result().total_cycles,
            "rejected": serve.stats()["jobs_rejected"]}


def sc_round_robin_fairness(P):
    """alpha's backlog needs three batches; beta's single job, submitted
    last, rides the second dispatch."""
    serve = make_serve(P, max_batch_lanes=4)
    for _ in range(6):
        serve.submit(TRACES["w0"], "alpha", n_lanes=2)
    serve.submit(TRACES["w1"], "beta", n_lanes=2)
    reports = serve.drain()
    assert [r.model_id for r in reports] == ["alpha", "beta", "alpha", "alpha"]
    return {"batches": batches(reports)}


def sc_priority_edf_and_packing_order(P):
    """Priority classes first; EDF inside a class; priority beats a tight
    deadline; a split group packs high priority first, then FIFO."""
    orders = []
    serve = make_serve(P)
    serve.submit(TRACES["w0"], "alpha", n_lanes=2, priority=0)
    serve.submit(TRACES["w0"], "beta", n_lanes=2, priority=5)
    orders.append([r.model_id for r in serve.drain()])
    serve.submit(TRACES["w0"], "alpha", n_lanes=2, deadline_ms=500.0)
    serve.submit(TRACES["w1"], "beta", n_lanes=2, deadline_ms=100.0)
    orders.append([r.model_id for r in serve.drain()])
    serve.submit(TRACES["w0"], "alpha", n_lanes=2, priority=0, deadline_ms=50.0)
    serve.submit(TRACES["w1"], "beta", n_lanes=2, priority=5)
    orders.append([r.model_id for r in serve.drain()])
    assert orders == [["beta", "alpha"]] * 3
    serve = make_serve(P, max_batch_lanes=4)
    h1 = serve.submit(TRACES["w0"], "alpha", n_lanes=2, priority=0)
    h2 = serve.submit(TRACES["w1"], "alpha", n_lanes=2, priority=0)
    h3 = serve.submit(TRACES["w2"], "alpha", n_lanes=2, priority=9)
    reports = serve.drain()
    assert [r.job_ids for r in reports] == [(h3.job_id, h1.job_id), (h2.job_id,)]
    return {"orders": orders, "batches": batches(reports)}


def sc_deadline_expires_before_dispatch(P):
    clock = FakeClock()
    serve = make_serve(P, clock)
    doomed = serve.submit(TRACES["w0"], "alpha", n_lanes=2, deadline_ms=100.0)
    safe = serve.submit(TRACES["w1"], "alpha", n_lanes=2)
    clock.advance(0.2)  # 200 ms > the 100 ms deadline
    reports = serve.drain()
    assert doomed.done()
    with pytest.raises(P.svc.DeadlineExceeded, match="missed its deadline"):
        doomed.result()
    assert all(doomed.job_id not in r.job_ids for r in reports)
    st = serve.stats()
    assert st["jobs_expired"] == 1 and st["jobs_completed"] == 1
    return {"batches": batches(reports), "total": safe.result().total_cycles}


def sc_lane_budget_and_aging(P):
    """Light load shrinks batches; a wide job still rides alone; a parked
    priority-0 job ages past fresh priority-3 traffic."""
    light = make_serve(P, max_batch_lanes=8, min_batch_lanes=2, lane_budget_depth=4)
    for name in ("w0", "w1"):
        light.submit(TRACES[name], "alpha", n_lanes=3)
    heavy = make_serve(P, max_batch_lanes=8, min_batch_lanes=2, lane_budget_depth=4)
    for name in ("w0", "w1", "w0", "w1"):
        heavy.submit(TRACES[name], "alpha", n_lanes=3)
    wide = make_serve(P, max_batch_lanes=16, min_batch_lanes=1, lane_budget_depth=8)
    h = wide.submit(TRACES["w0"], "alpha", n_lanes=12)  # depth 1 -> budget 2
    n_jobs = [[r.n_jobs for r in s.drain()] for s in (light, heavy, wide)]
    assert n_jobs == [[1, 1], [2, 1, 1], [1]] and h.result().n_lanes == 12
    clock = FakeClock()
    aged = make_serve(P, clock, aging_ms=100.0)
    aged.submit(TRACES["w0"], "alpha", n_lanes=2, priority=0)
    clock.advance(0.45)  # effective priority 0 + int(450 / 100) = 4
    aged.submit(TRACES["w1"], "beta", n_lanes=2, priority=3)
    order = [r.model_id for r in aged.drain()]
    assert order == ["alpha", "beta"]
    return {"n_jobs": n_jobs, "aged": order, "wide": h.result().total_cycles}


def sc_breaker_trips_and_half_open_probe_recovers(P):
    """Two failed batches open alpha's breaker: its submits fast-fail with
    ModelUnavailable while beta serves; after the cooldown one probe is
    admitted, succeeds and closes the breaker."""
    clock = FakeClock()
    serve = make_serve(P, clock, breaker_threshold=2, breaker_reset_s=30.0)
    restore = fail_engine(serve, "alpha")
    for _ in range(2):
        h = serve.submit(TRACES["w0"], "alpha", n_lanes=2)
        with pytest.raises(RuntimeError, match="device lost"):
            serve.drain()
        with pytest.raises(RuntimeError, match="failed in its batch"):
            h.result()
    states = [serve.registry.breaker_snapshots()["alpha"]["state"]]
    with pytest.raises(P.svc.ModelUnavailable, match="circuit breaker"):
        serve.submit(TRACES["w0"], "alpha", n_lanes=2)
    other = serve.submit(TRACES["w1"], "beta", n_lanes=2)
    serve.drain()
    restore()
    clock.advance(31.0)
    probe = serve.submit(TRACES["w0"], "alpha", n_lanes=2)  # half-open: one probe
    states.append(serve.registry.breaker_snapshots()["alpha"]["state"])
    serve.drain()
    states.append(serve.registry.breaker_snapshots()["alpha"]["state"])
    assert states == ["open", "half_open", "closed"]
    st = serve.stats()
    assert st["jobs_breaker_rejected"] == 1
    return {"states": states, "totals": [other.result().total_cycles,
                                         probe.result().total_cycles],
            "breaker": st["breakers"]["alpha"]}


def sc_cancel_and_failed_batch_isolation(P):
    """Cancel withdraws a pending job only; a failed batch pins its error
    on its own jobs, and their result() never runs another client's job."""
    serve = make_serve(P)
    h = serve.submit(TRACES["w0"], "alpha", n_lanes=2)
    assert serve.cancel(h) and serve.pending == 0 and not serve.cancel(h)
    assert serve.drain() == []
    with pytest.raises(RuntimeError, match="was cancelled"):
        h.result()
    bad = serve.submit(TRACES["w0"], "alpha", n_lanes=2)
    restore = fail_engine(serve, "alpha")
    with pytest.raises(RuntimeError, match="device lost"):
        serve.drain()
    restore()
    other = serve.submit(TRACES["w1"], "alpha", n_lanes=2)
    with pytest.raises(RuntimeError, match="failed in its batch"):
        bad.result()
    assert not other.done() and serve.pending == 1  # result() ran nothing
    serve.drain()
    return {"total": other.result().total_cycles, "completed": serve.stats()["jobs_completed"]}


def sc_watchdog_fails_hung_batch_and_keeps_serving(P):
    """A dispatch hung past ``batch_timeout_s`` fails its batch with
    BatchTimeout; the next batch runs and matches the first one's total."""
    P.faults.install(P.faults.FaultPlan(4, {
        "batch.execute": P.faults.FaultSpec(after=1, delay_ms=600_000.0, delay_once=1),
    }))
    try:
        serve = make_serve(P, batch_timeout_s=1.0)
        ha = serve.submit(TRACES["w0"], "alpha", n_lanes=2)
        serve.drain()
        hb = serve.submit(TRACES["w0"], "alpha", n_lanes=2)
        with pytest.raises(P.svc.BatchTimeout):
            serve.drain()  # arrival 2 hangs; the watchdog fails the batch
        with pytest.raises(RuntimeError, match="failed in its batch"):
            hb.result()
        hc = serve.submit(TRACES["w0"], "alpha", n_lanes=2)
        serve.drain()
        assert hc.result().total_cycles == ha.result().total_cycles
        st = serve.stats()
        assert st["batches_timed_out"] == 1
        return {"total": hc.result().total_cycles, "timed_out": st["batches_timed_out"],
                "faults": st["faults"]["sites"]["batch.execute"]}
    finally:
        P.faults.clear()


def sc_invalid_jobs_refused_at_submit(P):
    """Jobs that would poison a shared batch are refused at submit; an
    oversized job gets a batch of its own."""
    serve = make_serve(P, models=("tf16",), max_batch_lanes=4)
    errors = []
    for call in (
        lambda: serve.submit(TRACES["w0"], "nope"),
        lambda: serve.submit(TRACES["w0"], "tf16", n_lanes=9999),
        lambda: serve.submit(TRACES["w0"], "tf16", n_lanes=0),
        lambda: serve.submit(TRACES["w0"], "tf16", sim_cfg=P.SimConfig(ctx_len=8, max_latency=50.0)),
        lambda: serve.submit(TRACES["w0"], "tf16", sim_cfg=P.SimConfig(ctx_len=32)),
        lambda: serve.submit(TRACES["w0"], "tf16", sim_cfg=P.SimConfig(ctx_len=8, layout="roll")),
    ):
        with pytest.raises((KeyError, ValueError)) as e:
            call()
        errors.append((type(e.value).__name__, str(e.value).split(" ")[0]))
    assert serve.pending == 0
    big = serve.submit(TRACES["w0"], "tf16", n_lanes=6)
    small = serve.submit(TRACES["w1"], "tf16", n_lanes=2,
                         sim_cfg=P.SimConfig(ctx_len=4, retire_width=2))
    reports = serve.drain()
    assert [r.n_jobs for r in reports] == [1, 1]
    return {"errors": errors, "batches": batches(reports),
            "totals": [big.result().total_cycles, small.result().total_cycles]}


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_scenario_port_equals_reference(scenario):
    want = scenario(PKGS["ref"])
    got = scenario(PKGS["port"])
    assert got == want


def test_registry_places_engines_on_its_device(tmp_path):
    """Engines the port's registry builds, or loads from an artifact, live
    on the registry's device; a GPU asked for without one raises."""
    from repro_torch.checkpoint import PredictorArtifact
    from repro_torch.core.predictor import init_predictor
    from repro_torch.serving.registry import ModelRegistry

    pcfg = PredictorConfig(**ZOO_PCFG)
    PredictorArtifact(init_predictor(torch.Generator().manual_seed(0), pcfg, "cpu"), pcfg,
                      SimConfig(ctx_len=16)).save(tmp_path / "m")
    reg = ModelRegistry(device="cpu")
    reg.load("m", tmp_path / "m")
    reg.ensure_teacher_forced()
    assert all(reg.get(m).device.type == "cpu" for m in reg.ids())
    assert reg.get("m").params["conv0"]["w"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ModelRegistry()
        with pytest.raises(RuntimeError, match="CUDA"):
            port_service.SimServe()
