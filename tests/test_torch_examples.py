"""The port's SimNet examples (``examples/*_torch.py``) on the CPU against
the reference's, at a cut size.

Each pair runs in this process, each example in a working directory of
its own, with the same module constants patched to the same cut values
(stated below) and every training at one epoch. The DES is a copy, so its
runs are held exactly: every DES run's cycles, by ``O3Simulator.run``.
The SimNet totals are held as `tests/test_torch_session.py` holds
predicted totals, exactly, where both packages load one artifact the
reference wrote (simulate_workload, design_space, serve_requests). The
quickstart trains its own predictor in each package: from the
reference's initial weights (the port's init patched to return them) and
in the same batch order, its CPI is held within ``TRAINED_RTOL``.
"""
import dataclasses
import importlib
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint.artifact import PredictorArtifact as RefArtifact  # noqa: E402
from repro.core import session as ref_session  # noqa: E402
from repro.core.predictor import PredictorConfig as RefPredictorConfig  # noqa: E402
from repro.core.predictor import init_predictor as ref_init_predictor  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.des import o3 as ref_o3  # noqa: E402
from repro_torch.core import predictor as port_pred  # noqa: E402
from repro_torch.core import session as port_session  # noqa: E402
from repro_torch.des import o3 as port_o3  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = "artifacts/simnet/models/c3_hybrid"  # where get_session looks first
# the cut: instructions, epochs and requests (the examples' defaults in comments)
QUICKSTART = dict(T_TRAIN=2000, T_EVAL=2000)  # 20000, 10000; 6 epochs
SIMULATE_ARGS = ["--n", "3000", "--lanes", "8"]  # --n 60000 --lanes 32
DESIGN = dict(N=3000)  # 60000
REQUESTS = [  # the example's six clients at a quarter of their instructions
    ("alice", "sim_loop", 2000, 4, True),
    ("bob", "mlb_stream", 1500, 2, True),
    ("carol", "sim_branchy_easy", 1750, 8, True),
    ("dave", "mlb_compute", 1500, 4, False),
    ("erin", "mlb_mixed", 2250, 4, True),
    ("frank", "sim_stream2", 1250, 2, False),
]
EPOCHS = 1
# quickstart's two trainings: the per-step losses drift ~2e-7 relative over
# the first 20 steps (tests/test_torch_training.py), so a decoded latency
# can change where a class score is near a tie
TRAINED_RTOL = 1e-3


def _example(name):
    sys.modules.pop(f"examples.{name}", None)
    return importlib.import_module(f"examples.{name}")


@pytest.fixture
def run(monkeypatch, tmp_path, capsys):
    """run(package, module, argv, **constants) → (stdout, DES cycles, SimNet
    totals by call, training results): one example's ``main`` in a
    directory of its own."""
    monkeypatch.syspath_prepend(str(REPO))
    des, sims, trained = [], [], []
    for mod in (ref_session, port_session):
        cls = mod.SimNet
        train = cls.train.__func__

        def one_epoch(klass, *a, _train=train, **k):
            sn = _train(klass, *a, **{**k, "epochs": EPOCHS})
            trained.append(sn.train_result)
            return sn

        monkeypatch.setattr(cls, "train", classmethod(one_epoch))
    # the port's trainer starts from the reference's initial weights
    monkeypatch.setattr(port_session, "init_predictor", lambda gen, cfg, dev: port_pred.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_init_predictor(
            jax.random.PRNGKey(0), RefPredictorConfig(**dataclasses.asdict(cfg)))[0]), cfg, dev))
    for o3 in (ref_o3, port_o3):
        orig_run = o3.O3Simulator.run

        def recorded(self, *a, _run=orig_run, **k):
            tr = _run(self, *a, **k)
            des.append(tr.total_cycles)
            return tr

        monkeypatch.setattr(o3.O3Simulator, "run", recorded)
    for mod in (ref_session, port_session):
        orig_many = mod.SimNet.simulate_many

        def recorded_many(self, *a, _many=orig_many, **k):
            res = _many(self, *a, **k)
            sims.append([w.total_cycles for w in res])
            return res

        monkeypatch.setattr(mod.SimNet, "simulate_many", recorded_many)

    def go(package, name, argv, artifact=None, **constants):
        cwd = tmp_path / package
        cwd.mkdir()
        if artifact is not None:
            shutil.copytree(artifact, cwd / ARTIFACT)
        monkeypatch.chdir(cwd)
        mod = _example(name if package == "ref" else f"{name}_torch")
        for k, v in constants.items():
            monkeypatch.setattr(mod, k, v)
        for seen in (des, sims, trained):
            seen.clear()
        capsys.readouterr()
        if package == "ref":
            monkeypatch.setattr(sys, "argv", [name, *argv])
            mod.main()
        else:
            mod.main([*argv, "--device", "cpu"])
        return capsys.readouterr().out, list(des), [list(s) for s in sims], list(trained)

    return go


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A c3 artifact the reference wrote (random weights from PRNGKey(5);
    narrow widths: the examples' kernels are not on this path)."""
    pcfg = RefPredictorConfig(kind="c3", ctx_len=16, channels=(8, 16, 16), hidden=32)
    params, _ = ref_init_predictor(jax.random.PRNGKey(5), pcfg)
    path = tmp_path_factory.mktemp("art")
    RefArtifact(params, pcfg, RefSimConfig(ctx_len=16), {"origin": "test"}).save(path)
    return path


def test_quickstart(run):
    """At this cut the predictor is barely trained (one epoch of ~6 steps),
    so the losses and prediction errors carry the comparison of the
    training half; the held-out CPI is compared too."""
    ref_out, ref_des, ref_sims, ref_trained = run("ref", "quickstart", [], **QUICKSTART)
    out, des, sims, trained = run("port", "quickstart", [], **QUICKSTART)
    assert des == ref_des and len(des) == 3  # two training traces, the held-out one
    assert len(trained) == len(ref_trained) == 1
    (got,), (want,) = trained, ref_trained
    assert got.n_train == want.n_train and got.epochs == want.epochs == EPOCHS
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=TRAINED_RTOL, err_msg=k)
    for k in ("fetch", "execution", "store"):
        np.testing.assert_allclose(got.pred_errors[k], want.pred_errors[k], rtol=TRAINED_RTOL, err_msg=k)
    assert len(sims) == len(ref_sims) == 1
    np.testing.assert_allclose(sims[0], ref_sims[0], rtol=TRAINED_RTOL)
    des_cpi = [float(x) for x in re.findall(r"DES CPI ([\d.]+)", out)]
    assert des_cpi == [float(x) for x in re.findall(r"DES CPI ([\d.]+)", ref_out)] and des_cpi
    assert "saved PredictorArtifact" in out and "(cpu)" in out


def test_simulate_workload(run, artifact):
    ref_out, ref_des, ref_sims, _ = run("ref", "simulate_workload", SIMULATE_ARGS, artifact=artifact)
    out, des, sims, _ = run("port", "simulate_workload", SIMULATE_ARGS, artifact=artifact)
    assert des == ref_des and len(des) == 1
    assert sims == ref_sims and len(sims) == 1

    def cycles(text):
        return re.findall(r"(?:SimNet|DES): (\d+) cycles", text)

    assert cycles(out) == cycles(ref_out) and len(cycles(out)) == 2


def test_design_space(run, artifact):
    ref_out, ref_des, ref_sims, _ = run("ref", "design_space", [], artifact=artifact, **DESIGN)
    out, des, sims, _ = run("port", "design_space", [], artifact=artifact, **DESIGN)
    assert des == ref_des and len(des) == 3  # one DES run an L2 size
    assert sims == ref_sims and len(sims[0]) == 3  # one packed call, three design points

    def table(text):
        return [ln.split() for ln in text.splitlines() if re.match(r"\s*\d+kB ", ln)]

    assert table(out) == table(ref_out) and len(table(out)) == 3


def test_serve_requests(run, artifact):
    ref_out, ref_des, _, _ = run("ref", "serve_requests", [], artifact=artifact, REQUESTS=REQUESTS)
    out, des, _, _ = run("port", "serve_requests", [], artifact=artifact, REQUESTS=REQUESTS)
    assert des == ref_des and len(des) == len(REQUESTS)

    def jobs(text):
        return sorted(re.findall(r"^\s+(\w+/\w+)\s+model=(\S+)\s+(\d+) cycles", text, re.M))

    assert jobs(out) == jobs(ref_out) and len(jobs(out)) == len(REQUESTS)
    assert re.search(r"6 jobs in \d+ shared batches", out)
