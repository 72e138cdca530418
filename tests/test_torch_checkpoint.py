"""The port's checkpoints and predictor artifacts
(`repro_torch.checkpoint`) against the reference's (`repro.checkpoint`):
the same on-disk format both ways, the same atomicity, keep-N and sha256
guard, and the `artifact.load` fault seam through the port's own `faults`.
An artifact written by either package gives the other the same params,
bit for bit, and the same simulated totals."""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.checkpoint import PredictorArtifact as RefArtifact  # noqa: E402
from repro.core import features as F  # noqa: E402
from repro.core.predictor import PredictorConfig as RefPredictorConfig  # noqa: E402
from repro.core.predictor import init_predictor as ref_init_predictor  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro.des.workloads import get_benchmark  # noqa: E402
from repro.serving.compile_cache import CompileCache as RefCache  # noqa: E402
from repro.serving.simnet_engine import SimNetEngine as RefEngine  # noqa: E402
from repro_torch.checkpoint import ArtifactCorrupt, CheckpointManager, PredictorArtifact  # noqa: E402
from repro_torch.checkpoint.manager import _flatten, _unflatten  # noqa: E402
from repro_torch.core.predictor import PredictorConfig, init_predictor  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.compile_cache import CompileCache  # noqa: E402
from repro_torch.serving.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.serving.simnet_engine import SimNetEngine  # noqa: E402

CTX = 16


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear()
    yield
    faults.clear()


def tree():
    return {
        "params": {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": (np.zeros(2, np.float32), torch.ones(3))},
    }


def _leaves(t):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k])
    elif isinstance(t, (list, tuple)):
        for v in t:
            yield from _leaves(v)
    else:
        yield np.asarray(t)


def _same(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


# ------------------------------------------------------------- the manager


def test_flatten_roundtrip():
    flat = _flatten(tree())
    assert sorted(flat) == ["opt/m/#0", "opt/m/#1", "opt/step", "params/a", "params/b/c"]
    back = _unflatten(flat)
    assert isinstance(back["opt"]["m"], tuple)
    _same(back, tree())


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(10, tree(), metadata={"note": "x"})
    restored, step = mgr.restore()
    assert step == 10 and isinstance(restored["params"]["a"], np.ndarray)
    _same(restored, tree())
    assert mgr.read_manifest()["metadata"] == {"note": "x"}
    on_cpu, _ = mgr.restore(device="cpu")
    assert isinstance(on_cpu["params"]["a"], torch.Tensor) and on_cpu["params"]["a"].device.type == "cpu"
    assert torch.equal(on_cpu["params"]["a"], tree()["params"]["a"])


def test_keep_n_prunes_and_restores_a_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, {"x": torch.tensor(float(s))})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    restored, step = mgr.restore(step=3)
    assert step == 3 and float(restored["x"]) == 3.0


def test_async_save_and_no_partial_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path / "a", async_save=True)
    mgr.save(5, tree())
    mgr.wait()
    assert mgr.latest_step() == 5
    other = CheckpointManager(tmp_path / "b")
    (tmp_path / "b" / ".tmp_step_99").mkdir()
    assert other.all_steps() == [] and other.latest_step() is None
    with pytest.raises(FileNotFoundError):
        other.restore()


def test_manifest_carries_payload_sha256(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, tree())
    digest = mgr.read_manifest(5)["sha256"]["arrays.npz"]
    raw = (tmp_path / "step_0000000005" / "arrays.npz").read_bytes()
    assert hashlib.sha256(raw).hexdigest() == digest


def test_restore_detects_payload_corruption(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, tree())
    npz = tmp_path / "step_0000000005" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(ArtifactCorrupt, match="sha256 mismatch"):
        mgr.restore()


def test_artifact_load_fault_raises_artifact_corrupt(tmp_path, port_artifact):
    """The port's own `faults`: the "artifact.load" corrupt trigger flips a
    payload byte before the checksum, which catches it; the next load is
    clean."""
    plan = FaultPlan(3, {"artifact.load": FaultSpec(corrupt=1)})
    faults.install(plan)
    with pytest.raises(ArtifactCorrupt, match="sha256 mismatch"):
        PredictorArtifact.load(port_artifact, device="cpu")
    PredictorArtifact.load(port_artifact, device="cpu")
    assert plan.snapshot()["sites"]["artifact.load"] == {"arrivals": 2, "fails": 0, "delays": 0,
                                                         "corruptions": 1}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    data = {"params": {"a": np.arange(6.0, dtype=np.float32).reshape(2, 3)},
            "opt": {"step": np.int32(7), "m": (np.zeros(2, np.float32), np.ones(3, np.int64))}}
    (RefManager if writer == "reference" else CheckpointManager)(tmp_path, keep=2).save(
        3, data, metadata={"by": writer})
    for reader in (RefManager, CheckpointManager):
        restored, step = reader(tmp_path).restore()
        assert step == 3 and reader(tmp_path).read_manifest()["metadata"] == {"by": writer}
        _same(restored, data)


# ------------------------------------------------------------- artifacts


@pytest.fixture(scope="module")
def ref_artifact(tmp_path_factory):
    """A JAX-written c3 artifact (reference params, reference writer)."""
    rcfg = RefPredictorConfig(kind="c3", ctx_len=CTX)
    rparams, _ = ref_init_predictor(jax.random.PRNGKey(11), rcfg)
    path = tmp_path_factory.mktemp("ref") / "model"
    RefArtifact(rparams, rcfg, RefSimConfig(ctx_len=CTX, retire_width=4),
                metadata={"origin": "jax"}).save(path)
    return path


@pytest.fixture
def port_artifact(tmp_path):
    pcfg = PredictorConfig(kind="c3", ctx_len=CTX)
    params = init_predictor(torch.Generator().manual_seed(2), pcfg, "cpu")
    return PredictorArtifact(params, pcfg, SimConfig(ctx_len=CTX), metadata={"origin": "torch"}
                             ).save(tmp_path / "model")


def test_jax_written_artifact_loads_into_the_port(ref_artifact):
    ref = RefArtifact.load(ref_artifact)
    art = PredictorArtifact.load(ref_artifact, device="cpu")
    assert art.pcfg == PredictorConfig(kind="c3", ctx_len=CTX)
    assert isinstance(art.pcfg.channels, tuple)
    assert art.sim_cfg == SimConfig(ctx_len=CTX, retire_width=4)
    assert art.metadata == {"origin": "jax"}
    assert set(art.params) == set(ref.params)
    for name in ref.params:
        for k in ("w", "b"):
            want = np.asarray(ref.params[name][k])
            got = art.params[name][k]
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
            assert got.numpy().tobytes() == want.tobytes(), f"{name}.{k}"


def test_port_written_artifact_loads_through_the_reference(port_artifact):
    art = PredictorArtifact.load(port_artifact, device="cpu")
    ref = RefArtifact.load(port_artifact)
    assert ref.pcfg == RefPredictorConfig(kind="c3", ctx_len=CTX)
    assert ref.sim_cfg == RefSimConfig(ctx_len=CTX) and ref.metadata == {"origin": "torch"}
    for name in art.params:
        for k in ("w", "b"):
            assert np.asarray(ref.params[name][k]).tobytes() == art.params[name][k].numpy().tobytes()
    assert RefArtifact.exists(port_artifact) and PredictorArtifact.exists(port_artifact)


def test_one_artifact_gives_the_reference_engines_totals(ref_artifact):
    """A predicted run in the port starts from the artifact on disk and
    decodes the JAX engine's totals on the same artifact, exactly."""
    sim = O3Simulator(O3Config())
    arrs = [F.trace_arrays(sim.run(get_benchmark(n, s))) for n, s in (("mlb_stream", 900),
                                                                      ("sim_loop", 700))]
    ref = RefArtifact.load(ref_artifact)
    want = RefEngine(ref.params, ref.pcfg, ref.sim_cfg, cache=RefCache()).simulate_many(
        arrs, n_lanes=4, chunk=64)
    art = PredictorArtifact.load(ref_artifact, device="cpu")
    for use_kernel in (False, True):
        got = SimNetEngine(art.params, art.pcfg, art.sim_cfg, use_kernel=use_kernel, device="cpu",
                           cache=CompileCache()).simulate_many(arrs, n_lanes=4, chunk=64)
        np.testing.assert_array_equal(got["workload_cycles"], want["workload_cycles"])
        np.testing.assert_array_equal(got["workload_overflow"], want["workload_overflow"])


def test_overwrite_keeps_a_single_artifact(tmp_path, port_artifact):
    art = PredictorArtifact.load(port_artifact, device="cpu")
    art.save(tmp_path / "a")
    art.save(tmp_path / "a")
    assert CheckpointManager(tmp_path / "a").all_steps() == [0]


def test_exists_and_load_are_pure_reads(tmp_path):
    missing = tmp_path / "nope" / "deep"
    assert not PredictorArtifact.exists(missing)
    with pytest.raises(FileNotFoundError):
        PredictorArtifact.load(missing, device="cpu")
    assert not (tmp_path / "nope").exists()
    CheckpointManager(tmp_path / "ckpt").save(3, {"x": np.zeros(2)})
    assert not PredictorArtifact.exists(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="not a simnet-predictor"):
        PredictorArtifact.load(tmp_path / "ckpt", device="cpu")


def test_load_defaults_to_cuda(port_artifact):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error path cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictorArtifact.load(port_artifact)
