"""The slice as a whole: the port's `SimNetEngine` (on the CPU) against the
reference `repro.serving.simnet_engine.SimNetEngine` on the same DES
traces and the same weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import features as F  # noqa: E402
from repro.core.predictor import PredictorConfig as RefPredictorConfig  # noqa: E402
from repro.core.predictor import init_predictor as ref_init_predictor  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro.des.workloads import get_benchmark  # noqa: E402
from repro.serving.compile_cache import CompileCache  # noqa: E402
from repro.serving.simnet_engine import SimNetEngine as RefEngine  # noqa: E402
from repro_torch.core.predictor import PredictorConfig, params_from_numpy  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.serving.simnet_engine import NumericError, SimNetEngine  # noqa: E402

CTX = 16
BENCHES = [("mlb_stream", 1300), ("sim_loop", 900)]


@pytest.fixture(scope="module")
def arrs():
    sim = O3Simulator(O3Config())
    return [F.trace_arrays(sim.run(get_benchmark(n, s))) for n, s in BENCHES]


@pytest.fixture(scope="module")
def weights():
    rcfg = RefPredictorConfig(kind="c3", ctx_len=CTX)
    rparams, _ = ref_init_predictor(jax.random.PRNGKey(4), rcfg)
    return rcfg, rparams, jax.tree_util.tree_map(np.asarray, rparams)


@pytest.fixture(scope="module")
def ref_predicted(arrs, weights):
    rcfg, rparams, _ = weights
    eng = RefEngine(rparams, rcfg, RefSimConfig(ctx_len=CTX), cache=CompileCache())
    return eng.simulate_many(arrs, n_lanes=4, chunk=128)


def _same_result(got, want):
    assert sorted(got) == sorted(want)
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k in ("workload_cycles", "workload_cpi", "workload_overflow", "n_instructions"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    for k in ("total_cycles", "total_instructions", "n_lanes", "n_live_lanes", "n_steps",
              "n_workloads"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("layout", ["ring", "roll"])
def test_teacher_forced_engine_bit_identical(arrs, layout):
    """Heterogeneous SimConfigs, ragged lengths, lane bucketing (5 live
    lanes run in a bucket of 8)."""
    kw = [dict(ctx_len=CTX, retire_width=2), dict(ctx_len=8, retire_width=4)]
    want = RefEngine(sim_cfg=RefSimConfig(ctx_len=CTX, layout=layout), cache=CompileCache()
                     ).simulate_many(arrs, n_lanes=[3, 2], chunk=128,
                                     cfgs=[RefSimConfig(layout=layout, **c) for c in kw])
    got = SimNetEngine(sim_cfg=SimConfig(ctx_len=CTX, layout=layout), device="cpu"
                       ).simulate_many(arrs, n_lanes=[3, 2], chunk=128,
                                       cfgs=[SimConfig(layout=layout, **c) for c in kw])
    assert got["n_lanes"] == 8 and got["n_live_lanes"] == 5
    _same_result(got, want)
    assert got["workload_overflow"].sum() > 0


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("layout", ["ring", "roll"])
def test_predicted_c3_engine_matches_reference(arrs, weights, ref_predicted, use_kernel, layout):
    """Predicted totals equal the reference's unfused engine, on the
    unfused path and on both kernel paths (plain versions on the CPU)."""
    _, _, tree = weights
    pcfg = PredictorConfig(kind="c3", ctx_len=CTX)
    eng = SimNetEngine(params_from_numpy(tree, pcfg, "cpu"), pcfg,
                       SimConfig(ctx_len=CTX, layout=layout), use_kernel=use_kernel, device="cpu")
    assert eng.fused == (use_kernel and layout == "ring")
    got = eng.simulate_many(arrs, n_lanes=4, chunk=128)
    _same_result(got, ref_predicted)


def test_simulate_single_workload_and_timeit(arrs, weights):
    rcfg, rparams, tree = weights
    want = RefEngine(rparams, rcfg, RefSimConfig(ctx_len=CTX), cache=CompileCache()
                     ).simulate(arrs[1], n_lanes=2, chunk=64)
    pcfg = PredictorConfig(kind="c3", ctx_len=CTX)
    eng = SimNetEngine(params_from_numpy(tree, pcfg, "cpu"), pcfg, use_kernel=True, device="cpu")
    got = eng.simulate(arrs[1], n_lanes=2, chunk=64, timeit=True)
    assert sorted(got) == sorted(want)
    for k in ("total_cycles", "cpi", "n_instructions", "overflow"):
        assert got[k] == want[k], k
    assert got["throughput_ips"] > 0 and got["seconds"] > 0


def test_kernel_gate_sends_bf16_state_to_the_trunk_kernel(weights):
    _, _, tree = weights
    pcfg = PredictorConfig(kind="c3", ctx_len=CTX)
    params = params_from_numpy(tree, pcfg, "cpu")

    def fused(**kw):
        return SimNetEngine(params, pcfg, SimConfig(ctx_len=CTX, **kw), use_kernel=True,
                            device="cpu").fused

    assert fused() and not fused(state_dtype="bfloat16") and not fused(layout="roll")
    assert not SimNetEngine(params, pcfg, SimConfig(ctx_len=CTX), device="cpu").fused


def test_nan_params_raise_numeric_error(arrs, weights):
    """Poison the overflow class and the regression output of every head:
    the decode then yields NaN latencies, the totals go NaN, and the
    guard raises instead of returning them."""
    _, _, tree = weights
    pcfg = PredictorConfig(kind="c3", ctx_len=CTX)
    params = params_from_numpy(tree, pcfg, "cpu")
    for h in range(3):
        params["fc1"]["b"][h * 11 + 9] = float("nan")
        params["fc1"]["b"][h * 11 + 10] = float("nan")
    eng = SimNetEngine(params, pcfg, SimConfig(ctx_len=CTX), device="cpu")
    with pytest.raises(NumericError) as e:
        eng.simulate_many(arrs, n_lanes=2, chunk=64)
    assert e.value.bad_workloads == [0, 1]
