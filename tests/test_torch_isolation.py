"""The PyTorch port stands alone: no JAX, nothing of the reference package,
its own copies of the DES and of the fault injector giving the reference's
traces and fault schedules, and no silent CPU fallback when CUDA is asked
for."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import features as ref_features  # noqa: E402
from repro.des.o3 import O3Config as RefO3Config  # noqa: E402
from repro.des.o3 import O3Simulator as RefO3Simulator  # noqa: E402
from repro.des.workloads import get_benchmark as ref_get_benchmark  # noqa: E402
from repro.serving import faults as ref_faults  # noqa: E402
from repro_torch.core import features as port_features  # noqa: E402
from repro_torch.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro_torch.des.workloads import get_benchmark  # noqa: E402
from repro_torch.serving import faults as port_faults  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = [(root, line) for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.simulator, repro_torch.core.predictor\n"
        "import repro_torch.kernels.ops, repro_torch.serving.simnet_engine\n"
        "import repro_torch.des.o3, repro_torch.core.features\n"
        "import repro_torch.models.lm, repro_torch.models.registry, repro_torch.serving.engine\n"
        "import repro_torch.nn.attention, repro_torch.configs.registry\n"
        "import repro_torch.serving.faults, repro_torch.serving.compile_cache\n"
        "import repro_torch.serving.graphs, repro_torch.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("bench,n", [("mlb_mixed", 1500), ("sim_loop", 1200)])
def test_des_copy_gives_the_reference_traces(bench, n):
    ref = RefO3Simulator(RefO3Config()).run(ref_get_benchmark(bench, n))
    port = O3Simulator(O3Config()).run(get_benchmark(bench, n))
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name
    assert ref.total_cycles == port.total_cycles
    ra, pa = ref_features.trace_arrays(ref), port_features.trace_arrays(port)
    assert ra.keys() == pa.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k], pa[k], err_msg=k)
        assert ra[k].dtype == pa[k].dtype, k


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error path cannot be exercised")
    from repro_torch._device import resolve_device
    from repro_torch.core.simulator import SimConfig, init_state
    from repro_torch.serving.simnet_engine import SimNetEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(2, SimConfig())  # entry points default to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        SimNetEngine()
    assert resolve_device("cpu").type == "cpu"


def test_faults_copy_is_the_reference_verbatim():
    """`serving/faults.py` imports nothing of either package, so the copy
    is the reference's file, byte for byte."""
    ref = (REPO / "src" / "repro" / "serving" / "faults.py").read_bytes()
    assert (REPO / "src" / "repro_torch" / "serving" / "faults.py").read_bytes() == ref


@pytest.mark.parametrize("spec", [
    "seed=7;compile=fail_once:1;batch.execute=delay_ms:5,delay_once:2",
    "seed=11;http.request=after:2,fail_rate:0.4;batch.numeric=corrupt:2;artifact.load=corrupt:1",
    "seed=3;replica.crash=after:1,fail_rate:0.5,corrupt:3",
])
def test_same_fault_plan_gives_the_same_schedule_in_both_packages(spec):
    """One seed, one arrival sequence: the same decisions at the same
    sites, the same corrupted payloads and the same spec round trip."""
    sites = ("artifact.load", "compile", "batch.execute", "batch.numeric", "http.request",
             "replica.crash")
    rng = np.random.default_rng(0)
    order = [sites[i] for i in rng.integers(0, len(sites), 120)]
    payload = {"artifact.load": b"0123456789abcdef", "batch.numeric": np.arange(6, dtype=np.float64),
               "replica.crash": np.arange(4, dtype=np.int32)}

    def drive(mod):
        plan = mod.FaultPlan.from_spec(spec)
        out = []
        for site in order:
            try:
                got = plan.fire(site, payload.get(site), sleep=lambda s: None)
                out.append(("ok", got.tobytes() if isinstance(got, np.ndarray) else got))
            except mod.FaultInjected as e:
                out.append(("fail", e.site, e.arrival))
        return plan.to_spec(), plan.decision_log(), plan.snapshot(), out

    ref, port = drive(ref_faults), drive(port_faults)
    assert port == ref
    assert any(d[2] != "pass" for d in ref[1])  # the plan did fire
    assert port_faults.FAULT_SITES == ref_faults.FAULT_SITES
