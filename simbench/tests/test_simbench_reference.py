"""The plain reference equals the port's CPU path on a tiny pack, and the
yardstick's counts equal the port's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from simbench import reference as R, traffic, work  # noqa: E402
from simbench.weights import make_weights  # noqa: E402

CFGS = {"c3": {"kind": "c3", "ctx_len": 64, "channels": [64, 128, 128], "hidden": 256,
               "n_classes": 10, "rb_blocks": 7},
        "rb7": {"kind": "rb7", "ctx_len": 64, "channels": [64, 128, 128], "hidden": 256,
                "n_classes": 10, "rb_blocks": 7}}
SIM = {"ctx_len": 64, "max_latency": 100000.0, "retire_width": 8}


@pytest.mark.parametrize("kind", ["c3", "rb7"])
def test_reference_equals_the_ports_cpu_engine(kind, tiny_pool):
    from repro_torch.core.predictor import PredictorConfig
    from repro_torch.core.simulator import SimConfig
    from repro_torch.serving.simnet_engine import SimNetEngine

    pool = traffic.load_pool(["sim_loop", "sim_chase", "sim_phased"], 4096, directory=tiny_pool)
    params = make_weights(CFGS[kind], 2**31 + 99, "cpu", SIM, pool)
    widths = (2, 8, 4)
    arrays = [{k: v[512:1536] for k, v in pool[n].items()} for n in pool]
    eng = SimNetEngine(params, PredictorConfig(kind=kind), SimConfig(), use_kernel=kind == "c3",
                       device="cpu")
    got = eng.simulate_many(arrays, n_lanes=8, chunk=128,
                            cfgs=[dataclasses.replace(SimConfig(), retire_width=w) for w in widths])
    ref = R.simulate([{"arrays": a, "retire_width": w, "lanes": 8} for a, w in zip(arrays, widths)],
                     params, CFGS[kind], SIM, "cpu")
    assert [r["cycles"] for r in ref] == got["workload_cycles"].tolist()
    assert [r["overflow"] for r in ref] == got["workload_overflow"].tolist()


def test_ragged_lanes_freeze(tiny_pool):
    """A block whose jobs' lanes have different lengths runs each lane for
    its own steps: the totals equal each job run alone."""
    rng = np.random.default_rng(0)
    params = make_weights(CFGS["c3"], 5, "cpu", SIM,
                          traffic.load_pool(["sim_loop"], 4096, directory=tiny_pool))

    def job(T, lanes):
        return {"arrays": {"feat": rng.random((T, 41), dtype=np.float32),
                           "addr": rng.integers(0, 9, (T, 5)).astype(np.int32),
                           "is_store": rng.random(T) < 0.3}, "retire_width": 4, "lanes": lanes}

    jobs = [job(96, 4), job(40, 4)]
    together = R.simulate(jobs, params, CFGS["c3"], SIM, "cpu")
    alone = [R.simulate([j], params, CFGS["c3"], SIM, "cpu")[0] for j in jobs]
    assert together == alone


def test_the_head_is_standardised_on_the_calibration_batch(tiny_pool, monkeypatch):
    """One round of the correction leaves each class logit with mean 0 and
    standard deviation 1 over the calibration batch, as the weights before
    it predicted it; the regression outputs are left as drawn; the same
    seed gives the same weights."""
    from simbench import weights

    pool = traffic.load_pool(["sim_loop", "sim_chase"], 4096, directory=tiny_pool)
    params = make_weights(CFGS["c3"], 11, "cpu", SIM, pool)
    again = make_weights(CFGS["c3"], 11, "cpu", SIM, pool)
    assert all(torch.equal(params[k][w], again[k][w]) for k in params for w in params[k])
    assert params["fc1"]["b"].view(3, 11)[:, 10].eq(0).all()
    monkeypatch.setitem(weights.CALIBRATION, "rounds", 0)
    drawn = make_weights(CFGS["c3"], 11, "cpu", SIM, pool)
    w0 = drawn["fc1"]["w"].view(-1, 3, 11).clone()
    before = weights.class_logits(drawn, CFGS["c3"], SIM, pool, "cpu")
    weights._standardise_classes(drawn, CFGS["c3"], SIM, pool, "cpu")
    mean, std = before.mean(0), before.std(0)
    w, b = drawn["fc1"]["w"].view(-1, 3, 11), drawn["fc1"]["b"].view(3, 11)
    assert torch.allclose(b[:, :10], -mean / std, rtol=1e-6, atol=0)
    assert torch.allclose(w[..., :10], w0[..., :10] / std, rtol=1e-6, atol=0)
    assert torch.equal(w[..., 10], w0[..., 10]) and b[:, 10].eq(0).all()


def test_tf32_rounds_operands_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10 + 2**-12, 1.0 + 2**-11 + 2**-13, -3.0])
    assert R._tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0]


@pytest.mark.parametrize("kind", ["c3", "rb7"])
def test_flops_per_instruction_is_twice_the_ports_table_count(kind):
    from repro_torch.core.predictor import PredictorConfig, inference_mflops

    assert work.flops_per_instruction(CFGS[kind]) == pytest.approx(
        2e6 * inference_mflops(PredictorConfig(kind=kind)), rel=1e-12)


def test_k1_work_matches_the_ports_trunk_count():
    """K1's FLOPs are the trunk's products as the port's opcount counts
    them; at 1,024 lanes its bound is the kernel table's 0.0251 ms."""
    from repro_torch.runtime.opcount import trunk_work

    L = 1024
    convs = [{"w": torch.empty(s["w"], device="meta"), "b": torch.empty(s["b"], device="meta")}
             for s in (R.param_shapes(CFGS["c3"])[f"conv{i}"] for i in range(3))]
    x = torch.empty((L, 65, 50), device="meta")
    w = work.k1_work(CFGS["c3"], L)
    assert w["flops"] == trunk_work(x, convs, 72)["flops"]
    bound, by = work.roofline_seconds(w["flops"], w["bytes"])
    assert by == "flops" and round(bound * 1e3, 4) == 0.0251
