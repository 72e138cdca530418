"""The port's fleet tier on the CPU: replica subprocesses (``python -m
repro_torch serve --http 0 --device cpu``) behind the router, the failure
drill (kill → resubmit → restart → readmit), the supervisor's
``replica.crash`` seam, and the chaos drill's CLI.

Each replica child runs one intra-op thread (``OMP_NUM_THREADS=1``), as
the suite's own processes do.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from repro_torch.checkpoint import PredictorArtifact  # noqa: E402
from repro_torch.cli import main  # noqa: E402
from repro_torch.core.predictor import PredictorConfig, init_predictor  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.serving.fleet import (  # noqa: E402
    Fleet,
    ReplicaProcess,
    ReplicaSpawnError,
    _repro_env,
)
from repro_torch.serving.http import http_request  # noqa: E402
from repro_torch.serving.router import route_jobs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def test_replica_command_carries_the_device(tmp_path):
    """Every replica runs ``repro_torch serve`` on the device its fleet was
    given; the child environment resolves ``-m repro_torch`` to this
    checkout."""
    import repro_torch

    cmd = ReplicaProcess("r0", device="cpu", log_dir=str(tmp_path)).command()
    assert cmd[:5] == [sys.executable, "-u", "-m", "repro_torch", "serve"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert ReplicaProcess("r1", log_dir=str(tmp_path)).command()[
        cmd.index("--device") + 1] == "cuda"  # the default: never a CPU fallback
    fleet = Fleet(2, device="cpu")
    assert all(r.device == "cpu" for r in fleet.replicas)
    with pytest.raises(ValueError, match="device must be one of"):
        ReplicaProcess("r2", device="tpu", log_dir=str(tmp_path))
    first = _repro_env()["PYTHONPATH"].split(os.pathsep)[0]
    assert os.path.isdir(os.path.join(first, "repro_torch"))
    assert first in {os.path.dirname(os.path.abspath(p)) for p in repro_torch.__path__}


def test_replica_without_a_gpu_exits_and_is_reported(tmp_path):
    """A replica told ``--device cuda`` on a machine without a GPU raises
    and exits before listening; the fleet reports it, it never serves on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error path cannot be exercised")
    r = ReplicaProcess("gpu", device="cuda", log_dir=str(tmp_path)).spawn()
    with pytest.raises(ReplicaSpawnError, match="CUDA device requested"):
        r.wait_listening(timeout_s=120)
    assert not r.alive


def test_cli_fleet_totals_equal_sync(tmp_path, capsys):
    """``repro_torch --device cpu fleet --replicas 2`` against a job file
    with a predicted and a teacher-forced model: every job done, each
    total equal to the synchronous ``serve --jobs`` run's."""
    pcfg = PredictorConfig(kind="c1", ctx_len=16, channels=(16, 16, 16), hidden=32)
    PredictorArtifact(init_predictor(torch.Generator().manual_seed(2), pcfg, "cpu"), pcfg,
                      SimConfig(ctx_len=16)).save(tmp_path / "m")
    spec = {"models": {"m": str(tmp_path / "m")}, "jobs": [
        {"id": "a", "model": "m", "bench": "sim_loop", "n": 1500, "lanes": 2},
        {"id": "b", "model": "m", "bench": "mlb_stream", "n": 1200, "lanes": 3},
        {"id": "c", "bench": "sim_loop", "n": 1500, "lanes": 1},
        {"id": "d", "bench": "mlb_stream", "n": 1200, "lanes": 2, "priority": 2}]}
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps(spec))
    common = ["--jobs", str(jobs), "--cache-dir", str(tmp_path / "tr")]
    assert main(["--device", "cpu", "serve", *common]) == 0
    sync = json.loads(capsys.readouterr().out)
    assert main(["fleet", "--device", "cpu", "--replicas", "2", "--max-wait-ms", "5",
                 *common]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["mode"] == "fleet" and out["replicas"] == 2
    assert out["healthz"]["ok"] is True and out["healthz"]["healthy_replicas"] == 2
    assert all(j["status"] == "done" and j["replica"] in ("r0", "r1") for j in out["jobs"])
    assert ([(j["id"], j["result"]["total_cycles"]) for j in out["jobs"]]
            == [(j["id"], j["result"]["total_cycles"]) for j in sync["jobs"]])
    assert out["stats"]["router"]["jobs_routed"] == 4
    assert out["stats"]["fleet"]["jobs_completed"] == 4


def test_fleet_kill_resubmit_restart_drill():
    """SIGKILL the replica holding an accepted job: the job is resubmitted
    to the survivor and completes; the replica restarted on its original
    port is readmitted."""
    with Fleet(2, max_wait_ms=3000.0, poll_interval_s=0.05, probe_initial_s=0.05,
               probe_cap_s=0.5, device="cpu") as fleet:
        payloads = [{"id": "drill", "bench": "sim_loop", "n": 1500, "lanes": 1,
                     "replica": "r0"}]
        out = {}

        def run():
            out["entries"] = route_jobs(fleet.url, payloads, timeout=180)

        t = threading.Thread(target=run)
        t.start()
        _wait_until(lambda: fleet.router.stats(refresh=False)["router"]["jobs_routed"] >= 1,
                    msg="job accepted on r0")
        fleet.kill_replica(0)
        t.join(timeout=180)
        assert not t.is_alive()
        (e,) = out["entries"]
        assert e["status"] == "done" and e["replica"] == "r1" and e["resubmits"] >= 1
        stats = fleet.stats()
        assert stats["router"]["ejections"] >= 1 and stats["router"]["healthy_replicas"] == 1
        port = fleet.replicas[0].port
        fleet.restart_replica(0)
        assert fleet.replicas[0].port == port
        _wait_until(lambda: fleet.router.stats(refresh=False)["router"]["readmissions"] >= 1,
                    msg="r0 readmitted")
        st, body = http_request(f"{fleet.url}/v1/healthz")
        assert st == 200 and body["healthy_replicas"] == 2


def test_supervisor_replica_crash_seam_restarts_the_replica():
    """The supervisor's ``replica.crash`` site kills a replica (seeded);
    the supervisor restarts it under its budget and the router readmits
    it."""
    faults.install(FaultPlan(1, {"replica.crash": FaultSpec(fail_once=1)}))
    try:
        with Fleet(1, supervise=True, restart_budget=2, supervise_interval_s=0.05,
                   restart_backoff_initial_s=0.05, restart_backoff_cap_s=0.2,
                   probe_initial_s=0.05, probe_cap_s=0.5, device="cpu") as fleet:
            _wait_until(lambda: fleet.supervisor_stats()["restarts_total"] >= 1,
                        timeout=120, msg="supervised restart")
            faults.clear()  # one kill was the drill
            _wait_until(lambda: fleet.replicas[0].alive, msg="replica back up")
            sup = fleet.stats()["supervisor"]
            assert sup["chaos_kills"] == 1 and sup["restart_failures"] == 0
            _wait_until(lambda: fleet.router.stats(refresh=False)["router"]["readmissions"] >= 1,
                        msg="restarted replica readmitted")
    finally:
        faults.clear()


def test_cli_chaos_quick_passes_every_check(tmp_path):
    """``python -m repro_torch chaos --quick --device cpu``: exit 0, and
    every invariant of the single-process drill holds (survivors bit
    identical to the fault-free baseline, nothing lost or duplicated, the
    corrupt artifact isolated, the compile fault, watchdog and numeric
    guard fired, healthz degraded)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "chaos", "--quick", "--device", "cpu",
         "--out", str(tmp_path / "chaos.json")],
        env=env, capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = json.loads((tmp_path / "chaos.json").read_text())
    assert out["ok"] is True and out["quick"] is True
    checks = out["single"]["checks"]
    assert len(checks) == 10 and all(checks.values()), checks
    assert out["single"]["n_jobs"] == 6
