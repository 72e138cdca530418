"""The slice as a whole: the port's `SimNetEngine` (on the CPU) against the
reference `repro.serving.simnet_engine.SimNetEngine` on the same DES
traces and the same weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

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
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.compile_cache import CompileCache as PortCache  # noqa: E402
from repro_torch.serving.compile_cache import global_cache  # noqa: E402
from repro_torch.serving.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.serving.graphs import ParamsBinding  # noqa: E402
from repro_torch.serving.simnet_engine import (  # noqa: E402
    ChunkProgram,
    NumericError,
    SimNetEngine,
)

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


# ------------------------------------------------------- the program cache


def test_same_kind_engines_share_one_program(arrs, weights):
    """Weights are not part of the key: a second engine of the same kind,
    with other weights, hits the first one's entry, and each reports its
    own cache delta; totals stay each engine's own."""
    _, _, tree = weights
    pcfg = PredictorConfig(kind="c3", ctx_len=CTX)
    cache = PortCache()
    a = SimNetEngine(params_from_numpy(tree, pcfg, "cpu"), pcfg, use_kernel=True,
                     device="cpu", cache=cache)
    other = params_from_numpy(tree, pcfg, "cpu")
    other["fc1"]["b"] += 0.5  # shifts the decoded latencies
    b = SimNetEngine(other, pcfg, use_kernel=True, device="cpu", cache=cache)
    assert a.executable_key(8, 64) == b.executable_key(8, 64)
    ra = a.simulate_many(arrs, n_lanes=4, chunk=64)
    rb = b.simulate_many(arrs, n_lanes=4, chunk=64)
    assert (ra["cache"]["misses"], ra["cache"]["hits"]) == (1, 0)
    assert (rb["cache"]["misses"], rb["cache"]["hits"]) == (0, 1)
    assert ra["cache"]["compile_seconds"] >= 0.0 and rb["cache"]["compile_seconds"] == 0.0
    st = cache.stats()
    assert (st["misses"], st["hits"], st["n_executables"]) == (1, 1, 1)
    assert list(st["executables"]) == ["c3/ctx16/ring/L8/T64/kernel"]
    assert not np.array_equal(ra["workload_cycles"], rb["workload_cycles"])
    fresh = SimNetEngine(other, pcfg, use_kernel=True, device="cpu", cache=PortCache())
    np.testing.assert_array_equal(rb["workload_cycles"],
                                  fresh.simulate_many(arrs, n_lanes=4, chunk=64)["workload_cycles"])


def test_engine_programs_and_keys(weights):
    _, _, tree = weights
    pcfg = PredictorConfig(kind="c3", ctx_len=CTX)
    cache = PortCache()
    eng = SimNetEngine(params_from_numpy(tree, pcfg, "cpu"), pcfg, SimConfig(ctx_len=CTX),
                       use_kernel=True, device="cpu", cache=cache)
    key = eng.executable_key(16, 128)
    assert (key.predictor, key.sim_cfg, key.n_lanes, key.chunk, key.mesh, key.use_kernel) == (
        pcfg, SimConfig(ctx_len=CTX), 16, 128, None, True)
    prog = eng.executable(16, 128)
    assert isinstance(prog, ChunkProgram) and prog.key == key and eng.executable(16, 128) is prog
    tf = SimNetEngine(sim_cfg=SimConfig(ctx_len=CTX), device="cpu", cache=cache)
    assert tf.executable_key(16, 128).predictor is None
    assert tf.executable(16, 128) is not prog
    assert SimNetEngine(device="cpu").cache is global_cache("cpu")


def test_batch_numeric_fault_raises_numeric_error(arrs):
    """The port's own `faults`: the "batch.numeric" corrupt trigger poisons
    the totals before the numeric guard, which raises; the next arrival is
    clean."""
    eng = SimNetEngine(sim_cfg=SimConfig(ctx_len=CTX), device="cpu", cache=PortCache())
    plan = FaultPlan(2, {"batch.numeric": FaultSpec(corrupt=1)})
    faults.install(plan)
    try:
        with pytest.raises(NumericError) as e:
            eng.simulate_many(arrs, n_lanes=2, chunk=64)
        assert len(e.value.bad_workloads) == 1
        ok = eng.simulate_many(arrs, n_lanes=2, chunk=64)
    finally:
        faults.clear()
    assert np.isfinite(ok["workload_cycles"]).all()
    assert plan.snapshot()["sites"]["batch.numeric"]["corruptions"] == 1


# ------------------------------------------------ rebinding the weights


def test_params_binding_tells_rebound_and_updated_weights_apart():
    """The check a resident graph makes before a pass: the same tensors
    (new containers do not matter), the same tensors updated in place, and
    other tensors at the same versions."""
    params = {"a": {"w": torch.ones(2, 2), "b": torch.zeros(2)}, "c": [torch.ones(3)]}
    bound = ParamsBinding(params)
    assert bound.same_tensors(params) and bound.unchanged(params)
    assert bound.unchanged({"a": dict(params["a"]), "c": list(params["c"])})
    with torch.no_grad():
        params["a"]["b"] += 1.0
    assert bound.same_tensors(params) and not bound.unchanged(params)
    bound = ParamsBinding(params)
    other = {"a": {k: v.clone() for k, v in params["a"].items()}, "c": [params["c"][0].clone()]}
    assert [t._version for t in other["a"].values()] == [0, 0]
    assert not bound.same_tensors(other) and not bound.unchanged(other)
    assert not bound.same_tensors({"a": params["a"]})  # fewer tensors
    params["c"][0] = torch.ones(3)  # the old tensor is freed: its weak reference dies
    assert not bound.same_tensors(params)


def test_rebound_params_take_effect_on_the_cpu(arrs, weights):
    _, _, tree = weights
    pcfg = PredictorConfig(kind="c3", ctx_len=CTX)
    eng = SimNetEngine(params_from_numpy(tree, pcfg, "cpu"), pcfg, use_kernel=True, device="cpu",
                       cache=PortCache())
    first = eng.simulate_many(arrs, n_lanes=2, chunk=64)["workload_cycles"]
    other = params_from_numpy(tree, pcfg, "cpu")
    other["fc1"]["b"] += 0.5
    eng.params = other
    got = eng.simulate_many(arrs, n_lanes=2, chunk=64)["workload_cycles"]
    fresh = SimNetEngine(other, pcfg, use_kernel=True, device="cpu", cache=PortCache())
    np.testing.assert_array_equal(got, fresh.simulate_many(arrs, n_lanes=2, chunk=64)["workload_cycles"])
    assert not np.array_equal(got, first)
