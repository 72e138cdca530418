"""The port's `SimNet` session and `core.api` against the reference's, on
the CPU: the same DES traces, and predicted runs load the same weights
from one artifact the reference's `PredictorArtifact` wrote.

Every comparison of totals is exact (``==`` on the float64 totals the
host reduces): the teacher-forced path has no floating-point GEMM, and on
these packs the predicted path decodes the same latencies at every step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint.artifact import PredictorArtifact as RefArtifact  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core.predictor import PredictorConfig as RefPredictorConfig  # noqa: E402
from repro.core.predictor import init_predictor as ref_init_predictor  # noqa: E402
from repro.core.session import SimNet as RefSimNet  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro.des.workloads import get_benchmark  # noqa: E402
from repro.serving.compile_cache import CompileCache as RefCache  # noqa: E402
from repro_torch.checkpoint import PredictorArtifact  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.predictor import PredictorConfig  # noqa: E402
from repro_torch.core.results import SimResult, SweepResult  # noqa: E402
from repro_torch.core.session import SimNet  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.serving.compile_cache import CompileCache  # noqa: E402
from repro_torch.serving.registry import ModelRegistry  # noqa: E402
from repro_torch.serving.service import SimServe  # noqa: E402

CTX = 16
STYLES = ["mlb_stream", "sim_loop", "mlb_branchy"]
SIZES = [3000, 2000, 2600]  # ragged on purpose
LANES = [3, 2, 5]  # 10 live lanes in a bucket of 16
# narrow widths: the kernels' widths are not on this path (use_kernel=False)
KINDS = {
    "c1": dict(kind="c1", ctx_len=CTX, channels=(16, 16, 16), hidden=32),
    "c3": dict(kind="c3", ctx_len=CTX, channels=(8, 16, 16), hidden=32),
}
TIME_KEYS = {"seconds", "first_call_seconds", "throughput_ips", "compile_seconds"}


@pytest.fixture(scope="module")
def traces():
    sim = O3Simulator(O3Config())
    return [sim.run(get_benchmark(n, s)) for n, s in zip(STYLES, SIZES)]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One artifact a kind, written by the reference package."""
    out = {}
    for seed, (kind, kw) in enumerate(KINDS.items()):
        pcfg = RefPredictorConfig(**kw)
        params, _ = ref_init_predictor(jax.random.PRNGKey(seed + 3), pcfg)
        path = tmp_path_factory.mktemp(f"art_{kind}")
        RefArtifact(params, pcfg, RefSimConfig(ctx_len=CTX), {"origin": "test"}).save(path)
        out[kind] = path
    return out


def _sessions(path, **kw):
    ref = RefSimNet(RefArtifact.load(path), cache=RefCache(), **kw)
    port = SimNet(PredictorArtifact.load(path, device="cpu"), cache=CompileCache(),
                  device="cpu", **kw)
    return ref, port


def _strip_times(d):
    """A result's ``.to_dict()`` without its wall-clock fields."""
    if isinstance(d, dict):
        return {k: _strip_times(v) for k, v in d.items() if k not in TIME_KEYS}
    if isinstance(d, list):
        return [_strip_times(v) for v in d]
    return d


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_key_tree(v) for v in d]
    return type(d).__name__


def test_teacher_forced_totals_equal_des_and_reference(traces):
    """At one lane a teacher-forced run replays the DES exactly: each total
    is the trace's ``total_cycles``, and the reference session's."""
    got = SimNet(device="cpu", cache=CompileCache()).simulate_many(traces, n_lanes=1)
    want = RefSimNet(cache=RefCache()).simulate_many(traces, n_lanes=1)
    assert [w.total_cycles for w in got] == [float(t.total_cycles) for t in traces]
    assert [w.total_cycles for w in got] == [w.total_cycles for w in want]
    assert isinstance(got, SimResult) and got.to_dict()["n_workloads"] == len(traces)
    assert _key_tree(got.to_dict()) == _key_tree(want.to_dict())
    assert _strip_times(got.to_dict()) == _strip_times(want.to_dict())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_predicted_simulate_many_equals_reference(traces, artifacts, kind):
    """A ragged pack (three workloads, 3/2/5 lanes in a bucket of 16) of
    one artifact: every workload's total equal to the reference's, and
    the same ``.to_dict()`` apart from times."""
    ref, port = _sessions(artifacts[kind])
    want = ref.simulate_many(traces, n_lanes=LANES)
    got = port.simulate_many(traces, n_lanes=LANES)
    assert [w.total_cycles for w in got] == [w.total_cycles for w in want]
    assert [w.overflow for w in got] == [w.overflow for w in want]
    assert _key_tree(got.to_dict()) == _key_tree(want.to_dict())
    assert _strip_times(got.to_dict()) == _strip_times(want.to_dict())
    assert got.cache["misses"] == 1  # a cold private cache built one program


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_predicted_sweep_with_sim_configs_equals_reference(traces, artifacts, kind):
    """The 3-tuple sweep: one predictor over processor SimConfigs (ctx_len
    and retire width) in one pack, labels and totals equal the
    reference's."""
    ref, port = _sessions(artifacts[kind])
    points = [("ctx16/rw4", dict(ctx_len=16, retire_width=4)),
              ("ctx8/rw2", dict(ctx_len=8, retire_width=2))]
    jobs_ref = [(lab, t, RefSimConfig(**kw)) for lab, kw in points for t in traces[:2]]
    jobs_port = [(lab, t, SimConfig(**kw)) for lab, kw in points for t in traces[:2]]
    want = ref.sweep(jobs_ref, n_lanes=2)
    got = port.sweep(jobs_port, n_lanes=2)
    assert isinstance(got, SweepResult) and got.labels == want.labels
    assert [w.total_cycles for w in got.result] == [w.total_cycles for w in want.result]
    assert _strip_times(got.to_dict()) == _strip_times(want.to_dict())


def test_background_session_equals_sync(traces, artifacts):
    """The session on the service's drain loop gives the synchronous
    session's totals bit for bit, all three jobs in one batch."""
    path = artifacts["c1"]
    art = PredictorArtifact.load(path, device="cpu")
    sync = SimNet(art, device="cpu", cache=CompileCache()).simulate_many(traces, n_lanes=LANES)
    with SimNet(art, device="cpu", cache=CompileCache(), background=True) as sn:
        assert sn.service.running
        got = sn.simulate_many(traces, n_lanes=LANES)
        st = sn.stats()
    assert not sn.service.running
    assert [w.total_cycles for w in got] == [w.total_cycles for w in sync]
    assert st["jobs_per_batch"] == 3.0 and st["loop_errors"] == 0


def test_train_save_load_simulate_round_trip(traces, tmp_path):
    """`SimNet.train` on the CPU (dataset, trainer and session on the
    device asked for), then the artifact it saves reloads in both
    packages with the same totals."""
    pcfg = PredictorConfig(**KINDS["c1"])
    sn = SimNet.train(traces[:2], pcfg, epochs=1, batch_size=256, device="cpu",
                      cache=CompileCache())
    tr = sn.train_result
    assert tr.kind == "c1" and tr.epochs == 1 and len(tr.train_loss) == 1
    assert set(tr.pred_errors) == {"fetch", "execution", "store"}
    assert sn.device.type == "cpu"
    res = sn.simulate(traces[1], n_lanes=2)
    sn.save(tmp_path / "m")
    back = SimNet.from_artifact(tmp_path / "m", device="cpu", cache=CompileCache())
    assert back.simulate(traces[1], n_lanes=2).total_cycles == res.total_cycles
    ref = RefSimNet.from_artifact(tmp_path / "m", cache=RefCache())
    assert ref.simulate(traces[1], n_lanes=2).total_cycles == res.total_cycles
    assert ref.artifact.metadata["train"] == back.artifact.metadata["train"]


def test_mesh_is_not_ported():
    """A device mesh raises where the reference would shard (ROADMAP item
    12), in the session, the registry and the service."""
    for make in (lambda: SimNet(mesh=object(), device="cpu"),
                 lambda: ModelRegistry(mesh=object(), device="cpu"),
                 lambda: SimServe(mesh=object(), device="cpu")):
        with pytest.raises(NotImplementedError, match="item 12"):
            make()


def test_c1_with_kernel_raises_as_the_reference_does(traces, artifacts):
    """The trunk kernels fuse exactly three conv layers: c1 with
    ``use_kernel=True`` fails in both packages, with no fallback."""
    ref, port = _sessions(artifacts["c1"], use_kernel=True)
    with pytest.raises(AssertionError, match="C3 depth"):
        ref.simulate(traces[1], n_lanes=2)
    with pytest.raises(ValueError, match="C3 depth"):
        port.simulate(traces[1], n_lanes=2)
    assert port.stats()["breakers"][port.model_id]["consecutive_failures"] == 1


def test_phase_cpis_equal_reference(traces, artifacts):
    """Per-window CPI curves (paper Fig. 6) through the one-shot step loop."""
    art_ref = RefArtifact.load(artifacts["c3"])
    art = PredictorArtifact.load(artifacts["c3"], device="cpu")
    want = ref_api.phase_cpis(traces[0], art_ref.params, art_ref.pcfg, n_lanes=4, window=250)
    got = api.phase_cpis(traces[0], art.params, art.pcfg, n_lanes=4, window=250)
    for g, w in zip(got, want):
        assert len(g) == 12
        np.testing.assert_array_equal(g, np.asarray(w))


def test_trace_helpers_equal_reference(tmp_path):
    """`generate_traces` (through its npz cache too) and
    `generate_corun_traces` give the reference's traces."""
    for cache_dir in (None, tmp_path / "tr", tmp_path / "tr"):  # miss, then hit
        got = api.generate_traces(["sim_loop"], 800, cache_dir=cache_dir)
        want = ref_api.generate_traces(["sim_loop"], 800)
        np.testing.assert_array_equal(got[0].fetch_lat, want[0].fetch_lat)
        assert got[0].total_cycles == want[0].total_cycles
    got = api.generate_corun_traces("mix_stream_chase", 600, seed=1, cache_dir=tmp_path / "mc")
    want = ref_api.generate_corun_traces("mix_stream_chase", 600, seed=1)
    assert [t.name for t in got] == [t.name for t in want]
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(w, f.name), getattr(g, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=f.name)
            else:
                assert b == a, f.name
