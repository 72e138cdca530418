"""The port's HTTP tier (`repro_torch.serving.http`) on the CPU: real
requests against a live `ThreadingHTTPServer` on an ephemeral port.

Wire totals are held to in-process submits of the same arrays bit for bit
(f32/i32 survive the JSON round trip), for teacher-forced and predicted
models; the error mapping, the healthz flip and the ``http.request``
fault seam are the reference's; and one job file gives the same per-job
totals through both packages' ``serve --jobs``.
"""
import json
import threading

import numpy as np
import pytest
from conftest import synth_arrays

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from repro.cli import main as ref_main  # noqa: E402
from repro_torch.checkpoint import PredictorArtifact  # noqa: E402
from repro_torch.cli import main  # noqa: E402
from repro_torch.core.predictor import PredictorConfig, init_predictor  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.compile_cache import CompileCache  # noqa: E402
from repro_torch.serving.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.serving.http import (  # noqa: E402
    SimServeHTTP,
    TransportError,
    _trace_from_wire,
    http_request,
    wait_job,
)
from repro_torch.serving.service import SimServe  # noqa: E402

CFG = SimConfig(ctx_len=16)
TRACES = {f"w{i}": synth_arrays(64 + 24 * i, 20 + i) for i in range(4)}
PCFG = PredictorConfig(kind="c1", ctx_len=16, channels=(16, 16, 16), hidden=32)


def _wire(arrs):
    return {k: np.asarray(v).tolist() for k, v in arrs.items()}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("art") / "m"
    params = init_predictor(torch.Generator().manual_seed(5), PCFG, "cpu")
    return PredictorArtifact(params, PCFG, CFG).save(path)


def _make_serve(artifact, **kw):
    serve = SimServe(cache=kw.pop("cache", CompileCache()), device="cpu", **kw)
    serve.register("tf", sim_cfg=CFG)
    serve.register("m", artifact)
    return serve


def test_wire_totals_equal_in_process_bit_for_bit(artifact):
    """Four client threads post every (model, workload) as wire arrays and
    poll their results: each total and overflow equals an in-process
    submit of the same arrays, no job is lost, and overlapping clients
    share batches."""
    grid = [(mid, w) for mid in ("tf", "m") for w in sorted(TRACES)]
    seq = _make_serve(artifact)
    want = {}
    for mid, w in grid:
        h = seq.submit(TRACES[w], mid, n_lanes=2)
        seq.drain()
        want[(mid, w)] = (h.result().total_cycles, h.result().overflow)
    got, errors = {}, []
    serve = _make_serve(artifact, max_wait_ms=20.0)
    with SimServeHTTP(serve) as front:
        def client(c):
            try:
                posted = []
                for mid, w in grid[c::4] + grid[(c + 1) % 4::4]:
                    st, body = http_request(f"{front.url}/v1/jobs", "POST", {
                        "trace": _wire(TRACES[w]), "model": mid, "lanes": 2,
                        "id": f"c{c}-{mid}-{w}"})
                    assert st == 202, (st, body)
                    posted.append((mid, w, body["job_id"]))
                for mid, w, jid in posted:
                    done = wait_job(front.url, jid, timeout=120)
                    assert done["status"] == "done", done
                    got[(c, mid, w)] = (done["result"]["total_cycles"],
                                        done["result"]["overflow"])
            except Exception as e:  # noqa: BLE001 - the failure readout below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not any(t.is_alive() for t in threads)
        _, stats = http_request(f"{front.url}/v1/stats")
    serve.stop()
    assert not errors, errors
    assert len(got) == 2 * len(grid)
    for (c, mid, w), v in got.items():
        assert v == want[(mid, w)], (c, mid, w)
    assert stats["jobs_completed"] == 2 * len(grid) and stats["loop_errors"] == 0
    assert stats["telemetry"]["service_ms"]["count"] == 2 * len(grid)


def test_trace_from_wire_keeps_f32_and_i32_bits():
    """Awkward f32 values (denormals, extremes, -0.0) and i32 extremes come
    back bit for bit from their JSON text."""
    arrs = dict(TRACES["w0"])
    feat = arrs["feat"].copy()
    feat[0, :4] = [np.float32(1e-45), np.float32(3.4028235e38), np.float32(-0.0),
                   np.float32(0.1)]
    addr = arrs["addr"].copy()
    addr[0, :2] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    arrs.update(feat=feat, addr=addr)
    back = _trace_from_wire(json.loads(json.dumps(_wire(arrs))))
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes(), k


def test_error_mapping_and_healthz_flip(artifact):
    """400 malformed JSON / bad trace / bad request, 404 unknown model /
    job / route, 410 evicted, 429 queue full, 503 open breaker; /v1/healthz
    answers 200 while the loop runs and 503 after stop()."""
    serve = _make_serve(artifact, max_queue_depth=1)
    front = SimServeHTTP(serve, start_service=False, max_tracked_jobs=1)
    front.start()
    url = front.url
    try:
        wire = _wire(TRACES["w0"])
        codes = {}
        codes["malformed"] = http_request(f"{url}/v1/jobs", "POST", data=b"{not json")[0]
        codes["bad_trace"] = http_request(f"{url}/v1/jobs", "POST",
                                          {"trace": {"feat": [[1.0]]}, "model": "tf"})[0]
        codes["no_trace"] = http_request(f"{url}/v1/jobs", "POST", {"model": "tf"})[0]
        codes["unknown_model"] = http_request(f"{url}/v1/jobs", "POST",
                                              {"trace": wire, "model": "nope"})[0]
        codes["unknown_job"] = http_request(f"{url}/v1/jobs/12345")[0]
        codes["bad_job_id"] = http_request(f"{url}/v1/jobs/abc")[0]
        codes["no_route"] = http_request(f"{url}/v1/nowhere")[0]
        st, first = http_request(f"{url}/v1/jobs", "POST", {"trace": wire, "model": "tf",
                                                             "lanes": 2})
        codes["accepted"] = st
        st, body = http_request(f"{url}/v1/jobs", "POST", {"trace": wire, "model": "tf"})
        codes["queue_full"] = st
        assert body["error"]["type"] == "queue_full"
        serve.drain()
        st, second = http_request(f"{url}/v1/jobs", "POST", {"trace": wire, "model": "tf",
                                                              "lanes": 2})
        codes["evicted"] = http_request(f"{url}/v1/jobs/{first['job_id']}")[0]
        serve.registry.breaker("m").trip("test")
        st, body = http_request(f"{url}/v1/jobs", "POST", {"trace": wire, "model": "m"})
        codes["breaker_open"] = st
        assert body["error"]["type"] == "model_unavailable"
        assert codes == {"malformed": 400, "bad_trace": 400, "no_trace": 400,
                         "unknown_model": 404, "unknown_job": 404, "bad_job_id": 400,
                         "no_route": 404, "accepted": 202, "queue_full": 429,
                         "evicted": 410, "breaker_open": 503}
        assert http_request(f"{url}/v1/healthz")[0] == 503  # the loop never started
        serve.start()
        assert wait_job(url, second["job_id"], timeout=60)["status"] == "done"
        st, hz = http_request(f"{url}/v1/healthz")
        assert st == 200 and hz["status"] == "degraded" and hz["open_breakers"] == ["m"]
        assert http_request(f"{url}/v1/models")[1] == {"models": ["m", "tf"]}
        serve.stop()
        st, hz = http_request(f"{url}/v1/healthz")
        assert st == 503 and hz["status"] == "down"
    finally:
        front.stop(stop_service=True)


def test_http_request_fault_seam_fires_before_sending(artifact):
    """An injected ``http.request`` fault raises `TransportError` before
    the bytes leave: the server never saw the job, and a retry goes
    through."""
    serve = _make_serve(artifact)
    faults.install(FaultPlan(3, {"http.request": FaultSpec(fail_once=1)}))
    try:
        with SimServeHTTP(serve) as front:
            payload = {"trace": _wire(TRACES["w1"]), "model": "tf", "lanes": 2}
            with pytest.raises(TransportError, match="injected fault"):
                http_request(f"{front.url}/v1/jobs", "POST", payload)
            st, body = http_request(f"{front.url}/v1/jobs", "POST", payload)
            assert st == 202
            assert wait_job(front.url, body["job_id"], timeout=60)["status"] == "done"
            assert serve.stats()["jobs_submitted"] == 1
            assert faults.snapshot()["sites"]["http.request"]["fails"] == 1
        serve.stop()
    finally:
        faults.clear()


@pytest.mark.parametrize("http", [False, True], ids=["sync", "http"])
def test_job_file_same_totals_through_both_packages(tmp_path, capsys, artifact, http):
    """One job file (a predicted model written by the port, teacher-forced
    jobs, ragged lanes) through ``repro serve --jobs`` and ``repro_torch
    --device cpu serve --jobs`` (``--http 0``: every job over a live
    server): the same per-job totals, and the same JSON keys."""
    spec = {"models": {"m": str(artifact)}, "jobs": [
        {"id": "a", "model": "m", "bench": "sim_loop", "n": 1500, "lanes": 2},
        {"id": "b", "model": "m", "bench": "mlb_stream", "n": 1200, "lanes": 3},
        {"id": "tf", "bench": "sim_loop", "n": 1500, "lanes": 1}]}
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps(spec))
    extra = ["--http", "0"] if http else []
    out = {}
    for name, entry, argv in (
            ("ref", ref_main, ["serve", "--jobs", str(jobs), *extra]),
            ("port", main, ["--device", "cpu", "serve", "--jobs", str(jobs), *extra])):
        assert entry(argv + ["--cache-dir", str(tmp_path / name)]) == 0
        out[name] = json.loads(capsys.readouterr().out)
    ref, port = out["ref"], out["port"]
    assert port["mode"] == ref["mode"] == ("http" if http else "sync")
    assert sorted(port) == sorted(ref)
    totals = {k: [(j["id"], j["result"]["total_cycles"]) for j in v["jobs"]]
              for k, v in out.items()}
    assert totals["port"] == totals["ref"]
    assert port["jobs"][2]["result"]["cpi_error"] == 0.0  # 1 lane replays the DES
    assert sorted(port["stats"]) == sorted(ref["stats"])
    if http:
        assert port["healthz"]["ok"] and port["stats"]["telemetry"]["service_ms"]["count"] == 3
