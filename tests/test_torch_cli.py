"""``python -m repro_torch`` against ``python -m repro`` on the CPU: the
same subcommands give JSON with the same keys and, where nothing is timed,
the same values; a predictor trained by one package simulates to the same
CPI in the other, both ways round; ``--device`` is the port's one extra
option and never falls back to the CPU on its own.

Both CLIs run in this process through their ``main(argv)``, which is what
``python -m`` calls; one test runs the port's ``-m`` entry as a child
process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from repro.cli import main as ref_main  # noqa: E402
from repro.serving.compile_cache import global_cache as ref_global_cache  # noqa: E402
from repro_torch.cli import build_parser, main  # noqa: E402
from repro_torch.serving.compile_cache import global_cache  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TIME_KEYS = {"seconds", "first_call_seconds", "throughput_ips", "compile_seconds",
             "wall_seconds", "ips", "speedup_wall"}
TRAIN = ["train", "--bench", "mlb_mixed", "--quick", "--epochs", "2", "--kind", "c1",
         "--ctx-len", "16", "--batch-size", "128", "-n", "10000", "--eval-bench", "sim_loop",
         "--eval-n", "1500", "--lanes", "2"]


def _run(capsys, entry, argv):
    assert entry(argv) == 0
    return json.loads(capsys.readouterr().out)


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_key_tree(v) for v in d]
    return None


def _strip_times(d):
    if isinstance(d, dict):
        return {k: _strip_times(v) for k, v in d.items() if k not in TIME_KEYS}
    if isinstance(d, list):
        return [_strip_times(v) for v in d]
    return d


@pytest.mark.parametrize("argv,same_values", [
    (["trace", "--bench", "sim_loop", "mlb_stream", "-n", "1500"], True),
    (["trace", "--list"], True),
    (["trace", "--mix", "mix_stream_chase", "-n", "800"], True),
    (["simulate", "--bench", "sim_loop", "mlb_branchy", "-n", "1500", "--lanes", "2"], True),
    (["simulate", "--bench", "sim_loop", "-n", "1500", "--lanes", "2", "--layout", "roll"], True),
    (["sweep", "--quick", "--bench", "sim_loop", "-n", "1500", "--lanes", "2"], True),
    (["sweep", "--quick", "--param", "bpred", "--bench", "sim_loop", "-n", "1200",
      "--lanes", "2", "--points", "bimodal", "tage"], True),
    (["bench", "--bench", "sim_loop", "mlb_stream", "-n", "1200", "--lanes", "2"], False),
    (["lint", "--format", "json"], True),
], ids=["trace", "trace-list", "trace-mix", "simulate", "simulate-roll", "sweep-l2",
        "sweep-bpred", "bench", "lint"])
def test_subcommand_json_matches_reference(tmp_path, capsys, monkeypatch, argv, same_values):
    """The port's JSON has the reference's keys everywhere and, apart from
    wall-clock fields, the reference's values (teacher-forced runs, DES
    traces, lint findings)."""
    monkeypatch.chdir(REPO)  # lint's default paths are the repo's src/
    extra = [] if argv[0] == "lint" else ["--cache-dir", str(tmp_path / "tr")]
    # both packages start from a cold process-wide program cache, so each
    # result's "cache" delta does not depend on what tests ran earlier in
    # this worker process
    ref_global_cache().clear()
    global_cache("cpu").clear()
    want = _run(capsys, ref_main, argv + extra)
    got = _run(capsys, main, ["--device", "cpu"] + argv + extra)
    assert _key_tree(got) == _key_tree(want)
    if same_values:
        assert _strip_times(got) == _strip_times(want)


@pytest.mark.parametrize("trainer", ["ref", "port"])
def test_train_in_one_package_simulate_in_the_other(tmp_path, capsys, trainer):
    """``train`` saves an artifact; ``simulate`` of it in the other package
    (and in the same one) reports the CPI the trainer's own evaluation
    did, on the same benchmark and lanes."""
    mains = {"ref": (ref_main, []), "port": (main, ["--device", "cpu"])}
    art = str(tmp_path / "m")
    cache = ["--cache-dir", str(tmp_path / "tr")]
    entry, pre = mains[trainer]
    trained = _run(capsys, entry, pre + TRAIN + ["--artifact", art] + cache)
    assert trained["artifact"] == art and trained["train"]["kind"] == "c1"
    cpi = trained["eval"]["workloads"][0]["cpi"]
    for entry, pre in mains.values():
        out = _run(capsys, entry, pre + ["simulate", "--artifact", art, "--bench", "sim_loop",
                                         "-n", "1500", "--lanes", "2"] + cache)
        assert out["artifact"] == art
        assert out["result"]["workloads"][0]["cpi"] == cpi


def test_c1_with_use_kernel_raises_and_never_falls_back(tmp_path, capsys):
    """The trunk kernels fuse exactly the C3 depth: ``--use-kernel`` with a
    c1 artifact raises in the port's CLI, as it does in the reference's."""
    art = str(tmp_path / "m")
    _run(capsys, main, ["--device", "cpu"] + TRAIN[:-6] + ["--artifact", art,
                                                           "--cache-dir", str(tmp_path / "tr")])
    argv = ["simulate", "--artifact", art, "--bench", "sim_loop", "-n", "1500", "--lanes", "2",
            "--use-kernel", "--cache-dir", str(tmp_path / "tr")]
    with pytest.raises(AssertionError, match="C3 depth"):
        ref_main(argv)
    with pytest.raises(ValueError, match="C3 depth"):
        main(["--device", "cpu"] + argv)


def test_device_option_before_or_after_the_subcommand():
    ap = build_parser()
    assert ap.parse_args(["simulate"]).device == "cuda"
    assert ap.parse_args(["--device", "cpu", "simulate"]).device == "cpu"
    assert ap.parse_args(["serve", "--device", "cpu", "--http", "0"]).device == "cpu"
    assert ap.parse_args(["--device", "cpu", "fleet", "--jobs", "j"]).device == "cpu"
    with pytest.raises(SystemExit):
        ap.parse_args(["--device", "tpu", "simulate"])


def test_module_entry_runs_and_cuda_without_a_gpu_fails(tmp_path):
    """``python -m repro_torch`` as a child process: ``--device cpu``
    simulates (teacher-forced at one lane: the DES total); the default
    ``cuda`` exits non-zero without a GPU and prints no result."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "repro_torch", "simulate", "--bench", "sim_loop", "-n",
            "1200", "--lanes", "1", "--cache-dir", str(tmp_path / "tr")]
    proc = subprocess.run(argv + ["--device", "cpu"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    w = json.loads(proc.stdout)["result"]["workloads"][0]
    assert w["total_cycles"] == w["des_cycles"] and w["cpi_error"] == 0.0
    if not torch.cuda.is_available():
        proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout == ""
        assert "CUDA device requested" in proc.stderr
