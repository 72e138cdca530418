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
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from repro.core import features as ref_features  # noqa: E402
from repro.des import history as ref_history  # noqa: E402
from repro.des import multicore as ref_multicore  # noqa: E402
from repro.des import workloads as ref_workloads  # noqa: E402
from repro.des.o3 import O3Config as RefO3Config  # noqa: E402
from repro.des.o3 import O3Simulator as RefO3Simulator  # noqa: E402
from repro.des.workloads import get_benchmark as ref_get_benchmark  # noqa: E402
from repro.serving import faults as ref_faults  # noqa: E402
from repro_torch.core import features as port_features  # noqa: E402
from repro_torch.des import history as port_history  # noqa: E402
from repro_torch.des import multicore as port_multicore  # noqa: E402
from repro_torch.des import workloads as port_workloads  # noqa: E402
from repro_torch.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro_torch.des.workloads import get_benchmark  # noqa: E402
from repro_torch.serving import faults as port_faults  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "serve_lm_torch.py",
    REPO / "examples" / "train_lm_torch.py"]
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
        "import repro_torch.models.hybrid, repro_torch.models.whisper, repro_torch.models.rwkv\n"
        "import repro_torch.nn.moe, repro_torch.nn.ssm, repro_torch.nn.rope\n"
        "import repro_torch.nn.attention, repro_torch.configs.registry\n"
        "import repro_torch.serving.faults, repro_torch.serving.compile_cache\n"
        "import repro_torch.serving.graphs, repro_torch.checkpoint\n"
        "import repro_torch.core.dataset, repro_torch.core.session, repro_torch.training.optimizer\n"
        "import repro_torch.des.history, repro_torch.des.multicore\n"
        "import repro_torch.core.results, repro_torch.core.api, repro_torch.cli\n"
        "import repro_torch.serving.backoff, repro_torch.serving.telemetry\n"
        "import repro_torch.serving.registry, repro_torch.serving.service\n"
        "import repro_torch.serving.http, repro_torch.serving.router\n"
        "import repro_torch.serving.fleet, repro_torch.serving.chaos, repro_torch.analysis\n"
        "import repro_torch.training.losses, repro_torch.training.train_loop\n"
        "import repro_torch.training.compression, repro_torch.data.pipeline\n"
        "import repro_torch.runtime.straggler, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
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


@pytest.mark.parametrize("bench,caches,bpred", [
    ("mlb_mixed", None, "bimodal"),
    ("sim_branchy_hard", {"l1d_size": 8 * 1024, "l2_size": 64 * 1024}, "tage"),
])
def test_history_copy_gives_the_reference_features(bench, caches, bpred):
    """The 14 history-context features (mispred, fetch level / table walks
    / write-backs, data level / table walks / write-backs), and the
    label-free trace built on them."""
    prog = ref_get_benchmark(bench, 1500)
    ref = ref_history.history_features(prog, caches, bpred)
    port = port_history.history_features(get_benchmark(bench, 1500), caches, bpred)
    assert list(port) == list(ref)
    assert sum(1 if ref[k].ndim == 1 else ref[k].shape[1] for k in ref) == 14
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        assert port[k].dtype == ref[k].dtype, k
    rt = ref_history.trace_with_history(prog, caches, bpred)
    pt = port_history.trace_with_history(get_benchmark(bench, 1500), caches, bpred)
    for f in dataclasses.fields(rt):
        a, b = getattr(rt, f.name), getattr(pt, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_multicore_copy_gives_the_reference_traces_and_report():
    """One co-run mix at a fixed seed: the per-core traces and the
    `ContentionReport` of the shared fabric."""
    ref_progs = ref_workloads.get_mix("mix_stream_chase", 1500, seed=3)
    port_progs = port_workloads.get_mix("mix_stream_chase", 1500, seed=3)
    ref_traces, ref_report = ref_multicore.contention_report(ref_progs, mix="mix_stream_chase")
    port_traces, port_report = port_multicore.contention_report(port_progs, mix="mix_stream_chase")
    assert port_report.to_dict() == ref_report.to_dict()
    assert len(port_traces) == len(ref_traces) == 2
    for rt, pt in zip(ref_traces, port_traces):
        for f in dataclasses.fields(rt):
            a, b = getattr(rt, f.name), getattr(pt, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
                assert a.dtype == b.dtype, f.name
            else:
                assert a == b, f.name
    assert any(c["slowdown"] > 1.0 for c in port_report.cores)  # the fabric was shared


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


# the framework-free modules the port keeps as copies: (reference, port)
COPIES = [("core/results.py", "core/results.py"), ("serving/backoff.py", "serving/backoff.py"),
          ("serving/telemetry.py", "serving/telemetry.py"), ("data/pipeline.py", "data/pipeline.py"),
          ("runtime/straggler.py", "runtime/straggler.py")] + [
    (f"analysis/{p.name}", f"analysis/{p.name}")
    for p in sorted((REPO / "src" / "repro" / "analysis").glob("*.py"))]


def _without_imports(text: str):
    """The file's lines, its import statements left out (they name the
    package)."""
    tree = ast.parse(text)
    skip = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            skip.update(range(node.lineno, node.end_lineno + 1))
    return [ln for i, ln in enumerate(text.splitlines(), 1) if i not in skip]


@pytest.mark.parametrize("ref,port", COPIES, ids=[p for _, p in COPIES])
def test_copy_is_the_reference_apart_from_imports(ref, port):
    """A stdlib-only module is copied, not imported: its text is the
    reference's, import lines aside (the analysis package's relative
    imports make those copies byte for byte)."""
    want = (REPO / "src" / "repro" / ref).read_text()
    got = (REPO / "src" / "repro_torch" / port).read_text()
    assert _without_imports(got) == _without_imports(want)
    assert len(got.splitlines()) == len(want.splitlines())
    assert len(COPIES) == 11


def _lint(analysis, paths, cwd):
    """One package's linter over ``paths`` (relative to ``cwd``), in this
    process: the findings as sortable strings."""
    findings, _ = analysis.run_lint([cwd / p for p in paths], root=cwd)
    return sorted(f"{f.rule}|{f.path}|{f.line}|{f.message}" for f in findings)


def test_both_linters_give_the_same_findings(tmp_path):
    """`python -m repro_torch lint` runs the port's copy of the analysis
    package: over ``src/`` (both packages, clean) and over a file that
    breaks the lock, hygiene and determinism rules, its findings are the
    reference's. Both linters run in this process (the copy imports only
    the stdlib; `test_importing_the_port_loads_neither_jax_nor_reference`
    holds the port's imports in a fresh interpreter)."""
    bad = tmp_path / "repro" / "des" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(
        "import random\nimport threading\nimport time\n\n\n"
        "class Q:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._items = []  # guarded-by: _lock\n\n"
        "    def push(self, x):\n"
        "        self._items.append(x)\n\n"
        "    def pick(self):\n"
        "        try:\n"
        "            return random.random() + time.time()\n"
        "        except Exception:\n"
        "            return 0.0\n")
    from repro import analysis as ref_analysis
    from repro_torch import analysis as port_analysis

    ref_src, port_src = _lint(ref_analysis, ["src"], REPO), _lint(port_analysis, ["src"], REPO)
    assert port_src == ref_src == []
    rel = bad.relative_to(tmp_path)
    ref_bad, port_bad = _lint(ref_analysis, [rel], tmp_path), _lint(port_analysis, [rel], tmp_path)
    assert port_bad == ref_bad
    assert {f.split("|")[0] for f in ref_bad} == {
        "lock-guarded-field", "hygiene-broad-except", "det-unseeded-random", "det-wall-clock"}
