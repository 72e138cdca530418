"""The port's simulator against the reference `repro.core.simulator`:
teacher-forced totals and state planes are bit-identical on the same DES
traces — ragged packs, heterogeneous retire_width / lane_ctx, overflow,
bf16 state, ring and roll, dead lanes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import features as F  # noqa: E402
from repro.core import simulator as ref  # noqa: E402
from repro.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro.des.workloads import get_benchmark  # noqa: E402
from repro_torch.core import simulator as port  # noqa: E402
from repro_torch.core.features import trace_arrays as port_trace_arrays  # noqa: E402
from repro_torch.des.o3 import O3Config as PortO3Config  # noqa: E402
from repro_torch.des.o3 import O3Simulator as PortO3Simulator  # noqa: E402
from repro_torch.des.workloads import get_benchmark as port_get_benchmark  # noqa: E402

BENCHES = [("mlb_stream", 1200), ("sim_loop", 900), ("mlb_compute", 700)]  # ragged
LANES = [3, 2, 4]
CFG_KW = [dict(ctx_len=16, retire_width=2), dict(ctx_len=8, retire_width=8),
          dict(ctx_len=12, retire_width=4)]


@pytest.fixture(scope="module")
def arrs():
    sim = O3Simulator(O3Config())
    return [F.trace_arrays(sim.run(get_benchmark(n, s))) for n, s in BENCHES]


def _cfgs(mod, **kw):
    return [mod.SimConfig(**c, **kw) for c in CFG_KW]


def _eq(a, b, what):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a)
    b = np.asarray(jnp.asarray(b, jnp.float32) if getattr(b, "dtype", None) == jnp.bfloat16 else b)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("layout", ["ring", "roll"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_packed_teacher_forced_bit_identical(arrs, layout, state_dtype):
    kw = dict(layout=layout, state_dtype=state_dtype)
    want = ref.simulate_many(arrs, None, _cfgs(ref, **kw), n_lanes=LANES)
    got = port.simulate_many(arrs, None, _cfgs(port, **kw), n_lanes=LANES, device="cpu")
    for k in ("lane_cycles", "workload_cycles", "workload_overflow"):
        _eq(got[k].numpy(), want[k], k)
    assert int(got["workload_overflow"].sum()) > 0  # the ctx 8 job overflows
    for k in ("n_instructions", "workload_id", "n_lanes", "n_steps"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("layout", ["ring", "roll"])
def test_simulate_trace_and_model_inputs_bit_identical(arrs, layout):
    """Per-lane totals, overflow and every assembled model input."""
    a = {k: v[:400] for k, v in arrs[1].items()}
    want = ref.simulate_trace(a, None, ref.SimConfig(ctx_len=8, layout=layout), 2)
    got = port.simulate_trace(a, None, port.SimConfig(ctx_len=8, layout=layout), 2, device="cpu")
    _eq(got["lane_cycles"].numpy(), want["lane_cycles"], "lane_cycles")
    assert int(got["overflow"]) == int(want["overflow"])
    assert got["outs"]["x"].shape == (200, 2, 9, F.N_FEATURES)
    _eq(got["outs"]["x"].numpy(), want["outs"]["x"], "model inputs")


def _step_inputs(rng, L, T):
    is_store = rng.random((T, L)) < 0.3
    feat = (rng.random((T, L, F.STATIC_END)) * (rng.random((T, L, F.STATIC_END)) < 0.3)).astype(np.float32)
    feat[..., 7] = is_store
    active = np.ones((T, L), bool)
    active[T // 2:, 1] = False  # a ragged tail: lane 1 freezes halfway
    return {
        "feat": feat,
        "addr": rng.integers(0, 20, (T, L, F.N_ADDR_KEYS)).astype(np.int32),
        "is_store": is_store,
        "labels": np.stack([rng.integers(0, 3, (T, L)), rng.integers(1, 30, (T, L)),
                            rng.integers(1, 40, (T, L))], -1).astype(np.float32),
        "active": active,
    }


@pytest.mark.parametrize("layout", ["ring", "roll"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_state_planes_after_one_chunk(layout, state_dtype):
    """Every SimState plane (head included) after a chunk of steps with
    per-lane active masks, retire widths and context capacities."""
    L, Q, T = 4, 12, 40
    xs = _step_inputs(np.random.default_rng(7), L, T)
    rw = np.array([1, 8, 3, 2], np.int32)
    lc = np.array([12, 5, 8, 12], np.int32)
    kw = dict(ctx_len=Q, layout=layout, state_dtype=state_dtype)

    rcfg = ref.SimConfig(**kw)
    step = ref.make_sim_scan(None, rcfg, retire_width=jnp.asarray(rw),
                             lane_ctx=jnp.asarray(lc), emit_outputs=False)
    want, _ = jax.lax.scan(step, ref.init_state(L, rcfg), {k: jnp.asarray(v) for k, v in xs.items()})

    pcfg = port.SimConfig(**kw)
    step = port.make_sim_scan(None, pcfg, retire_width=torch.from_numpy(rw),
                              lane_ctx=torch.from_numpy(lc), emit_outputs=False)
    got, _ = port.run_steps(step, port.init_state(L, pcfg, "cpu"),
                            {k: torch.from_numpy(v) for k, v in xs.items()})
    assert int(got.valid.sum()) > 0 and int(got.overflow.sum()) > 0
    for name in port.SimState._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert tuple(g.shape) == tuple(w.shape), name
        _eq(g, w, name)
    assert got.feat.dtype == port.torch_dtype(state_dtype)


def test_dead_lanes_add_exactly_zero(arrs):
    packed = port.pack_workloads(arrs, LANES, _cfgs(port), pad_to=8)
    padded = port.pad_packed_lanes(packed, 16)
    assert padded.n_lanes == 16 and packed.n_lanes == 9

    def run(pk):
        step = port.make_sim_scan(None, pk.cfg, retire_width=torch.from_numpy(pk.retire_width),
                                  lane_ctx=torch.from_numpy(pk.lane_ctx), emit_outputs=False)
        state, _ = port.run_steps(step, port.init_state(pk.n_lanes, pk.cfg, "cpu"),
                                  port.packed_tensors(pk, torch.device("cpu")))
        return port.workload_totals(state, pk)

    lane0, cyc0, ov0 = run(packed)
    lane1, cyc1, ov1 = run(padded)
    assert torch.equal(lane1[9:], torch.zeros(7))
    assert torch.equal(cyc0, cyc1) and torch.equal(ov0, ov1)
    want = ref.simulate_many(arrs, None, _cfgs(ref), n_lanes=LANES)
    _eq(cyc1.numpy(), want["workload_cycles"], "workload_cycles")


def test_packing_helpers_match_reference(arrs):
    want = ref.pad_packed_lanes(ref.pack_workloads(arrs, LANES, _cfgs(ref), pad_to=64), 16)
    got = port.pad_packed_lanes(port.pack_workloads(arrs, LANES, _cfgs(port), pad_to=64), 16)
    for k in want.xs:
        np.testing.assert_array_equal(got.xs[k], want.xs[k], err_msg=k)
    for f in ("workload_id", "retire_width", "lane_ctx", "lane_steps", "n_instructions"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.uniform == want.uniform
    assert port.max_packed_steps(arrs, LANES) == ref.max_packed_steps(arrs, LANES)


@pytest.mark.parametrize("bench,n", [("mlb_mixed", 2000), ("sim_loop", 1500)])
def test_one_lane_totals_equal_trace_total_cycles(bench, n):
    """At n_lanes=1 teacher forcing replays the DES exactly (port DES)."""
    trace = PortO3Simulator(PortO3Config()).run(port_get_benchmark(bench, n))
    a = port_trace_arrays(trace)
    for layout in ("ring", "roll"):
        res = port.simulate_trace(a, None, port.SimConfig(layout=layout), 1, device="cpu")
        assert float(res["total_cycles"]) == float(trace.total_cycles), layout


def test_clip_lats_rounds_half_to_even():
    lats = np.array([[0.5, 0.5, 0.5], [1.5, 2.5, 3.5], [-0.5, -3.0, 2.5],
                     [2e6, 7.49, 0.4]], np.float32)
    is_store = np.array([True, True, False, True])
    cfg_r, cfg_p = ref.SimConfig(), port.SimConfig()
    want = ref._clip_lats({"is_store": jnp.asarray(is_store)}, jnp.asarray(lats), cfg_r)
    got = port._clip_lats({"is_store": torch.from_numpy(is_store)}, torch.from_numpy(lats), cfg_p)
    for g, w in zip(got, want):
        _eq(g.numpy(), w, "clipped latencies")
    assert got[0][1].item() == 2.0 and got[1][1].item() == 2.0  # half to even


def test_config_fields_match_reference():
    """The lint gate reads config fields by class name: keep them identical."""
    for a, b in ((ref.SimConfig, port.SimConfig),):
        fa = [(f.name, f.type, f.default) for f in dataclasses.fields(a)]
        fb = [(f.name, f.type, f.default) for f in dataclasses.fields(b)]
        assert fa == fb
    with pytest.raises(ValueError, match="layout"):
        port.SimConfig(layout="spiral")
