"""The lane mesh on the CPU: the port's `SimNetEngine(mesh=)` over 2 and 4
gloo ranks against its one-rank engine and the reference's
`SimNetEngine(mesh=Mesh(4 CPU devices, ("data",)))`.

This process is the controller (rank 0); the followers are processes
started with the spawn method (`run_follower`), one intra-op thread each,
on a gloo group whose store is a file under the module's temporary
directory (no TCP port, so parallel test workers cannot clash). One group
a world size, for the whole module.

Every comparison of totals is exact: the lanes never communicate, each
rank runs the one-rank chunk program on its slice, and the controller
reduces the gathered per-lane totals as one rank would.
"""
import json
import multiprocessing
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint import PredictorArtifact  # noqa: E402
from repro_torch.core.features import trace_arrays  # noqa: E402
from repro_torch.core.session import SimNet  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro_torch.des.workloads import get_benchmark  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serving import simnet_engine  # noqa: E402
from repro_torch.serving.compile_cache import CompileCache, mesh_fingerprint  # noqa: E402
from repro_torch.serving.service import SimServe  # noqa: E402
from repro_torch.serving.simnet_engine import SimNetEngine, run_follower  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CTX = 16
# the pack: two DES workloads of 600 instructions, 4 lanes each (a bucket
# of 8, 150 steps padded to two chunks of 128)
BENCHES, N_INSTR, LANES, CHUNK = ("sim_loop", "mlb_mixed"), 600, 4, 128
# the meshes of each world, built in this order by every rank: 2 ranks as
# (data 2); 4 ranks as (pod 2, data 2) and as (data 2, model 2), whose
# model-axis ranks run the same lanes
WORLDS = {2: (((2, 1), ("data", "model")),),
          4: (((2, 2, 1), ("pod", "data", "model")), ((2, 2), ("data", "model")))}
TIMEOUT_S = 300  # any wait of the group, a follower's idle wait too
ROUTES = ("teacher-forced", "c3", "c3-kernel", "roll")

# The reference on a 4-device CPU mesh, in a process of its own (the
# device count is fixed when JAX starts): it writes its c3 weights as an
# artifact and each route's totals.
REFERENCE = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.checkpoint.artifact import PredictorArtifact
from repro.core import features as F
from repro.core.predictor import PredictorConfig, init_predictor
from repro.core.simulator import SimConfig
from repro.des.o3 import O3Config, O3Simulator
from repro.des.workloads import get_benchmark
from repro.serving.compile_cache import CompileCache
from repro.serving.simnet_engine import SimNetEngine
out, ctx, benches, n, lanes, chunk = sys.argv[1], int(sys.argv[2]), sys.argv[3].split(","), \\
    int(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
sim = O3Simulator(O3Config())
arrs = [F.trace_arrays(sim.run(get_benchmark(b, n))) for b in benches]
pcfg = PredictorConfig(kind="c3", ctx_len=ctx)
params, _ = init_predictor(jax.random.PRNGKey(0), pcfg)
PredictorArtifact(params, pcfg, SimConfig(ctx_len=ctx), {}).save(out + "/art")
routes = {"teacher-forced": dict(sim_cfg=SimConfig(ctx_len=ctx)),
          "c3": dict(params=params, pcfg=pcfg),
          "c3-kernel": dict(params=params, pcfg=pcfg, use_kernel=True),
          "roll": dict(params=params, pcfg=pcfg, sim_cfg=SimConfig(ctx_len=ctx, layout="roll"))}
res = {}
for name, kw in routes.items():
    r = SimNetEngine(mesh=mesh, cache=CompileCache(), **kw).simulate_many(arrs, n_lanes=lanes, chunk=chunk)
    res[name] = [r["workload_cycles"].tolist(), r["workload_overflow"].tolist()]
json.dump(res, open(out + "/totals.json", "w"))
"""


@pytest.fixture(scope="module")
def arrs():
    sim = O3Simulator(O3Config())
    return [trace_arrays(sim.run(get_benchmark(b, N_INSTR))) for b in BENCHES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the reference's c3 artifact loaded on the CPU, its totals by route)."""
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out), str(CTX), ",".join(BENCHES),
                           str(N_INSTR), str(LANES), str(CHUNK)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    totals = json.loads((out / "totals.json").read_text())
    return PredictorArtifact.load(out / "art", device="cpu"), totals


def _engine_kw(route, art):
    return {"teacher-forced": dict(sim_cfg=SimConfig(ctx_len=CTX)),
            "c3": dict(params=art.params, pcfg=art.pcfg),
            "c3-kernel": dict(params=art.params, pcfg=art.pcfg, use_kernel=True),
            "roll": dict(params=art.params, pcfg=art.pcfg,
                         sim_cfg=SimConfig(ctx_len=CTX, layout="roll"))}[route]


@pytest.fixture(scope="module")
def one_rank(arrs, reference):
    """The port's one-rank totals of each route (no mesh)."""
    art, _ = reference
    out = {}
    for route in ROUTES:
        r = SimNetEngine(device="cpu", cache=CompileCache(), **_engine_kw(route, art)).simulate_many(
            arrs, n_lanes=LANES, chunk=CHUNK)
        out[route] = r["workload_cycles"], r["workload_overflow"]
    return out


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda n: f"{n}ranks")
def world(request, tmp_path_factory):
    """A gloo world of ``n`` ranks, this process the controller: its
    meshes. Torn down by the end of a `SimNet` context on the first mesh,
    which must end every follower's loop."""
    n = request.param
    specs = WORLDS[n]
    init = f"file://{tmp_path_factory.mktemp(f'world{n}')}/store"
    ctx = multiprocessing.get_context("spawn")
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the followers' intra-op threads
    try:
        procs = [ctx.Process(target=run_follower, args=(r, n, init, specs, "cpu", "cpu", TIMEOUT_S),
                             daemon=True) for r in range(1, n)]
        for p in procs:
            p.start()
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    try:
        dist.init_process_group("gloo", init_method=init, rank=0, world_size=n,
                                timeout=timedelta(seconds=TIMEOUT_S))
        meshes = [make_mesh(shape, axes, "cpu") for shape, axes in specs]
        yield meshes
        with SimNet(mesh=meshes[0], device="cpu", cache=CompileCache()):
            pass
        for p in procs:
            p.join(60)
        assert [p.exitcode for p in procs] == [0] * (n - 1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_totals_equal_one_rank_and_reference(world, arrs, reference, one_rank, route):
    """Teacher-forced, c3 plain, c3 with the fused kernel (its plain
    version on the CPU) and roll: on every mesh of the world, with two
    passes (timeit), the totals equal the one-rank engine's and the
    reference's 4-device mesh's bit for bit."""
    art, totals = reference
    want_cycles, want_overflow = one_rank[route]
    np.testing.assert_array_equal(want_cycles, totals[route][0])
    np.testing.assert_array_equal(want_overflow, totals[route][1])
    for mesh in world:
        got = SimNetEngine(mesh=mesh, device="cpu", cache=CompileCache(),
                           **_engine_kw(route, art)).simulate_many(arrs, n_lanes=LANES, chunk=CHUNK,
                                                                   timeit=True)
        np.testing.assert_array_equal(got["workload_cycles"], want_cycles)
        np.testing.assert_array_equal(got["workload_overflow"], want_overflow)
        assert got["n_lanes"] == 2 * LANES and got["workload_cycles"].dtype == np.float64


def test_mesh_keys_programs_by_global_bucket_and_fingerprint(world, arrs, reference):
    """The key holds the global bucket and the mesh's fingerprint, the
    program runs this rank's share, and a mesh is a cache miss beside the
    one-rank program of the same shape."""
    art, _ = reference
    cache = CompileCache()
    SimNetEngine(art.params, art.pcfg, device="cpu", cache=cache).simulate_many(
        arrs, n_lanes=LANES, chunk=CHUNK)
    for mesh in world:
        eng = SimNetEngine(art.params, art.pcfg, mesh=mesh, device="cpu", cache=cache)
        res = eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)
        assert res["cache"]["misses"] == 1 and res["cache"]["hits"] == 0
        key = eng.executable_key(2 * LANES, CHUNK)
        assert key.n_lanes == 2 * LANES and key.mesh == mesh_fingerprint(mesh)
        shards = eng._lanes.n_shards
        assert eng.executable(2 * LANES, CHUNK).n_lanes == 2 * LANES // shards
    assert cache.stats()["n_executables"] == 1 + len(world)


def test_indivisible_bucket_raises(world, arrs):
    """A bucket the lane axes do not divide raises before any request
    goes out, and the next call runs."""
    for mesh in world:
        eng = SimNetEngine(mesh=mesh, sim_cfg=SimConfig(ctx_len=CTX), device="cpu",
                           cache=CompileCache())
        with pytest.raises(ValueError, match="does not split"):
            eng.simulate_many(arrs[:1], n_lanes=1, chunk=CHUNK)
        assert eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["n_lanes"] == 2 * LANES


def test_rebound_weights_reach_the_followers(world, arrs, reference):
    """The weights go with every request: after ``engine.params`` is
    rebound, every rank runs the new ones (the totals equal a fresh
    one-rank engine's on them, and differ from the first weights')."""
    from repro_torch.core.predictor import init_predictor

    art, _ = reference
    other = init_predictor(torch.Generator().manual_seed(7), art.pcfg, "cpu")
    want = SimNetEngine(other, art.pcfg, device="cpu", cache=CompileCache()).simulate_many(
        arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"]
    for mesh in world:
        eng = SimNetEngine(art.params, art.pcfg, mesh=mesh, use_kernel=True, device="cpu",
                           cache=CompileCache())
        first = eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"]
        eng.params = other
        got = eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"]
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, first)


def test_session_and_service_serve_on_the_mesh(world, arrs, reference, one_rank):
    """`SimNet(art, mesh=, background=True)` serves a job through its
    drain thread, and a `SimServe(mesh=)` registers an artifact and
    serves through its registry's sharded engine; both equal the
    one-rank totals. (Only the fixture's teardown closes a session: that
    releases the followers.)"""
    from repro_torch.des.o3 import O3Config, O3Simulator

    art, _ = reference
    sim = O3Simulator(O3Config())
    traces = [sim.run(get_benchmark(b, N_INSTR)) for b in BENCHES]
    want = list(one_rank["c3"][0])
    mesh = world[0]
    sn = SimNet(art, mesh=mesh, background=True, device="cpu", cache=CompileCache())
    try:
        assert sn.service.running
        res = sn.simulate_many(traces, n_lanes=LANES, chunk=CHUNK)
        assert [w.total_cycles for w in res] == want
    finally:
        sn.service.stop()
    serve = SimServe(mesh=mesh, chunk=CHUNK, device="cpu", cache=CompileCache())
    serve.register("c3", art)
    assert serve.registry.get("c3").mesh is mesh
    handles = [serve.submit(t, "c3", n_lanes=LANES) for t in traces]
    serve.drain()
    assert [h.result().total_cycles for h in handles] == want


def test_no_collective_inside_a_chunk(world, arrs, reference, monkeypatch):
    """The scan is collective-free: every call of a wrapped
    ``torch.distributed`` function happens outside the chunk body (the
    request before, the gather after), on this rank. The followers run
    the same `run_chunk`."""
    art, _ = reference
    inside, calls = [False], {"inside": 0, "outside": 0}
    names = [n for n in ("send", "recv", "isend", "irecv", "broadcast", "all_reduce", "reduce",
                         "all_gather", "all_gather_into_tensor", "gather", "scatter",
                         "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
                         "all_to_all_single", "barrier", "broadcast_object_list",
                         "all_gather_object", "gather_object", "scatter_object_list",
                         "send_object_list", "recv_object_list", "batch_isend_irecv")
             if hasattr(dist, n)]
    for name in names:
        def counted(*a, _fn=getattr(dist, name), **k):
            calls["inside" if inside[0] else "outside"] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(dist, name, counted)
    run_chunk = simnet_engine.run_chunk

    def chunk_body(*a, **k):
        inside[0] = True
        try:
            return run_chunk(*a, **k)
        finally:
            inside[0] = False

    monkeypatch.setattr(simnet_engine, "run_chunk", chunk_body)
    for mesh in world:
        eng = SimNetEngine(art.params, art.pcfg, mesh=mesh, use_kernel=True, device="cpu",
                           cache=CompileCache())
        eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK, timeit=True)
    followers = len(world[0].mesh.flatten()) - 1
    # a request (2 sends) and two passes' answers (2 receives each) a follower and mesh
    assert calls == {"inside": 0, "outside": len(world) * followers * 6}
