"""Whole runs at a cut size on the CPU (the harness's look for a card
skipped): a sound run is correct; the timed path broken underneath makes
``correct`` false; the control (the reference in TF32 in the program's
place) reads above the program; nothing loads JAX or the JAX package."""
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import ROOT, TINY  # noqa: E402
from simbench import manifest, run  # noqa: E402

SEED = 2**31 + 4242
CELLS = {w["name"]: w["traffic"] for w in manifest.load()["workloads"]}


def tiny_run(cell, traced=False):
    return run.run(cell, SEED, 1.0, traced, device="cpu", mix_override=TINY[CELLS[cell]],
                   limits_override={"min_checked_jobs": 1})


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell, tiny_pool):
    r = tiny_run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "check" and r["check"]["answer_gap_mean"]["value"] == 0.0
    names = {m["name"] for m in manifest.metrics(manifest.load(), cell, False)}
    assert set(r["metrics"]) == names and r["metrics"]["setup_s"]["value"] > 0


def test_a_traced_run_reads_its_host_metrics(tiny_pool):
    r = tiny_run("c3-sweep", traced=True)
    assert r["correct"] and r["metrics"]["pack_ms.sweep"]["value"] > 0


def _unchanged(orig):
    def chunk(pcfg, sim_cfg, use_kernel, params, state, xs, rw, lc):
        return state
    return chunk


def _half(orig):
    def chunk(pcfg, sim_cfg, use_kernel, params, state, xs, rw, lc):
        xs = dict(xs)
        xs["active"] = xs["active"].clone()
        xs["active"][:, xs["active"].shape[1] // 2:] = False
        return orig(pcfg, sim_cfg, use_kernel, params, state, xs, rw, lc)
    return chunk


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_lanes", "latency_altered"])
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny_pool, monkeypatch):
    """The faults a cell of one chip can have (it exchanges nothing between
    chips): a step that returns its state unchanged, half of the lanes left
    out, a predicted latency altered where it is produced."""
    from repro_torch.core import predictor
    from repro_torch.serving import simnet_engine as se

    if fault == "latency_altered":
        orig = predictor.decode_latency

        def altered(raw, cfg):
            out = orig(raw, cfg).clone()
            out[:, 0] += 1.0
            return out
        monkeypatch.setattr(predictor, "decode_latency", altered)
        monkeypatch.setattr(se, "decode_latency", altered)
    else:
        wrap = _unchanged if fault == "state_unchanged" else _half
        monkeypatch.setattr(se, "run_chunk", wrap(se.run_chunk))
    r = tiny_run(cell)
    assert not r["correct"]
    assert r["check"]["answer_gap_mean"]["value"] > r["check"]["answer_gap_mean"]["limit"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_reads_above_the_program(cell, tiny_pool):
    """At a cut size: the reference with TF32 operands in the program's
    place moves the answers past the cell's limit, where the program (the
    port's CPU path, the same float32 arithmetic as the reference) does
    not move them at all."""
    mix = dict(TINY[CELLS[cell]], check_calls=2)
    cell_ = run.Cell(cell, SEED, "cpu", mix)
    calls = [cell_.call(0, i) for i in range(2)]
    jobs = run.sample(cell_, calls)
    ref = run.reference_totals(cell_, jobs)
    control = run.reference_totals(cell_, jobs, precision="tf32")
    limits = dict(cell_.limits, min_checked_jobs=1)
    program = run.check_numbers(calls, jobs, run.answers(jobs), ref)
    assert program["answer_gap_mean"] == 0.0 and run.judge(program, limits)[0]
    control = run.check_numbers([], jobs, control, ref)
    assert not run.judge(control, limits)[0]


def test_the_judge_needs_every_number_within_its_limit():
    lim = {"answer_gap_mean": {"limit": 1e-5}, "min_checked_jobs": 4}
    base = {"answer_gap_mean": 1e-6, "instr_mismatch": 0, "failed_calls": 0, "checked_jobs": 8}
    assert run.judge(base, lim)[0]
    for k, v in (("answer_gap_mean", 2e-5), ("instr_mismatch", 1), ("failed_calls", 1),
                 ("checked_jobs", 3), ("answer_gap_mean", float("inf"))):
        assert not run.judge(dict(base, **{k: v}), lim)[0], k


def test_no_run_loads_jax_or_the_jax_package(tiny_pool):
    """A whole run in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or repro (compared whole: repro_torch is the port);
    and the reference alone loads no module of the port."""
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import simbench.reference, simbench.work, simbench.weights, simbench.traffic
ref_mods = sorted(m for m in sys.modules if m.split('.')[0] in ('repro_torch', 'jax', 'repro'))
from simbench import run, traffic
from pathlib import Path
traffic.POOL_DIR = Path({str(tiny_pool)!r})
r = run.run('c3-sweep', 1, 0.5, False, device='cpu', mix_override={TINY['sweep']!r},
            limits_override={{'min_checked_jobs': 1}})
print(json.dumps({{'ref': ref_mods, 'bad': run.forbidden_modules(), 'correct': r['correct'],
                  'port': 'repro_torch' in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ref": [], "bad": [], "correct": True, "port": True}


def test_the_command_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, "-m", "simbench.run", "--workload", "c3-sweep",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_forbidden_module_loaded_by_the_check_refuses_the_result(tiny_pool, monkeypatch):
    """The look at ``sys.modules`` comes after the metrics' readers and the
    reference: what they load refuses the run too."""
    orig = run.check

    def loading(cell, calls):
        monkeypatch.setitem(sys.modules, "repro.core", object())
        return orig(cell, calls)
    monkeypatch.setattr(run, "check", loading)
    with pytest.raises(SystemExit, match="no result"):
        tiny_run("c3-sweep")


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in run.forbidden_modules()


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(cuda):
    out = subprocess.run([sys.executable, "-m", "simbench.run", "--workload", "c3-sweep",
                          "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert np.isfinite(r["metrics"]["throughput_ips"]["value"])
