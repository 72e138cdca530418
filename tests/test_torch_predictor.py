"""The port's predictor against the reference `repro.core.predictor`:
JAX-initialised weights of every kind cross over through
`params_from_numpy` and give the same raw outputs (rtol=atol=2e-5) and the
same decoded latencies; a JAX-written artifact of every kind gives the
reference engine's totals through the port's CPU engine."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import PredictorArtifact as RefArtifact  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import predictor as ref  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro.des.workloads import get_benchmark  # noqa: E402
from repro.serving.compile_cache import CompileCache as RefCache  # noqa: E402
from repro.serving.simnet_engine import SimNetEngine as RefEngine  # noqa: E402
from repro_torch.checkpoint import PredictorArtifact  # noqa: E402
from repro_torch.core import predictor as port  # noqa: E402
from repro_torch.core import simulator as port_sim  # noqa: E402
from repro_torch.serving.compile_cache import CompileCache  # noqa: E402
from repro_torch.serving.simnet_engine import SimNetEngine  # noqa: E402

CTX = 16
KINDS = ["fc2", "fc3", "c1", "c3", "rb7", "lstm2", "ithemal_lstm2", "tx6"]


# the reference's forward, jitted: one compile a config instead of one a jnp op
ref_apply_raw = jax.jit(ref.apply_raw, static_argnums=(2,))


def _params(kind, seed=1):
    rcfg = ref.PredictorConfig(kind=kind, ctx_len=CTX)
    rparams, _ = ref.init_predictor(jax.random.PRNGKey(seed), rcfg)
    pcfg = port.PredictorConfig(kind=kind, ctx_len=CTX)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, rparams, pcfg, port.params_from_numpy(tree, pcfg, "cpu")


def _x(seed=0, batch=12):
    """Model inputs shaped like the simulator's: static features in [0, 1),
    scaled latencies, 0/1 flags, and a tail of invalid (zero) rows."""
    rng = np.random.default_rng(seed)
    x = rng.random((batch, CTX + 1, 50)).astype(np.float32)
    x[:, :, 44:50] = (x[:, :, 44:50] < 0.4)
    x[:, CTX - 3:] = 0.0
    return x


@pytest.mark.parametrize("kind", KINDS)
def test_crossed_weights_give_the_reference_outputs(kind):
    rcfg, rparams, pcfg, pparams = _params(kind)
    x = np.random.default_rng(0).random((12, CTX + 1, 50)).astype(np.float32)
    want = np.asarray(ref_apply_raw(rparams, jnp.asarray(x), rcfg))
    got = port.apply_raw(pparams, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # use_kernel reaches only c1/c3 (and c1's raises, below): the others ignore it
    if kind not in ("c1", "c3"):
        assert torch.equal(port.apply_raw(pparams, torch.from_numpy(x), pcfg, use_kernel=True), got)
    # decode the SAME raw outputs in both: identical latencies
    np.testing.assert_array_equal(
        port.decode_latency(torch.tensor(want), pcfg).numpy(),
        np.asarray(ref.decode_latency(jnp.asarray(want), rcfg)))
    np.testing.assert_array_equal(
        port.decode_latency(got, pcfg).numpy(),
        np.asarray(ref.decode_latency(jnp.asarray(want), rcfg)))


@pytest.mark.parametrize("kind", KINDS)
def test_decoded_latencies_match_on_simulator_like_inputs(kind):
    """Inputs with the simulator's flags and invalid rows: the class
    decisions are identical; where the overflow class hands over to the
    regression head, its latency (raw x 64) agrees at the raw outputs'
    tolerance, and the latency the simulator takes from it (rounded half
    to even) is identical."""
    rcfg, rparams, pcfg, pparams = _params(kind, seed=2)
    x = _x(seed=1, batch=64)
    raw = np.asarray(ref_apply_raw(rparams, jnp.asarray(x), rcfg))
    want = np.asarray(ref.decode_latency(jnp.asarray(raw), rcfg))
    got = port.decode_latency(port.apply_raw(pparams, torch.from_numpy(x), pcfg), pcfg).numpy()
    cls = want < rcfg.n_classes - 1
    np.testing.assert_array_equal(got[cls], want[cls])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 / ref.REG_SCALE)
    np.testing.assert_array_equal(np.rint(got), np.rint(want))


def test_decode_ties_overflow_and_regression_match_reference():
    rcfg, pcfg = ref.PredictorConfig(), port.PredictorConfig()
    raw = np.random.default_rng(3).standard_normal((64, 33)).astype(np.float32)
    raw[:8, :11] = 0.5  # ties: the first maximum wins
    raw[8:16, 9] = 10.0  # overflow class: regression fallback (clamped at 9)
    raw[16:24, 10] = 2.0
    for output in ("hybrid", "reg"):
        rc, pc = dataclasses.replace(rcfg, output=output), dataclasses.replace(pcfg, output=output)
        r = raw if output == "hybrid" else raw[:, :3]
        np.testing.assert_array_equal(port.decode_latency(torch.from_numpy(r), pc).numpy(),
                                      np.asarray(ref.decode_latency(jnp.asarray(r), rc)))


def test_fused_predict_equals_unfused():
    """make_fused_predict_fn(state) == make_predict_fn(model_input(state))."""
    _, _, pcfg, pparams = _params("c3", seed=2)
    rng = np.random.default_rng(0)
    L = 5
    cfg = port_sim.SimConfig(ctx_len=CTX, layout="ring")
    state = port_sim.init_state(L, cfg, "cpu")
    for _ in range(24):
        is_store = rng.random(L) < 0.3
        feat = (rng.random((L, 41)) * (rng.random((L, 41)) < 0.3)).astype(np.float32)
        feat[:, 7] = is_store
        cur = {"feat": torch.from_numpy(feat),
               "addr": torch.from_numpy(rng.integers(0, 20, (L, 5)).astype(np.int32)),
               "is_store": torch.from_numpy(is_store)}
        lats = torch.from_numpy(rng.integers(0, 12, (L, 3)).astype(np.float32))
        state = port_sim.sim_step(state, cur, lats, cfg)
    want = port.make_predict_fn(pparams, pcfg)(
        port_sim.model_input(state, cur["feat"], cur["addr"], cfg))
    got = port.make_fused_predict_fn(pparams, pcfg)(state, cur["feat"], cur["addr"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    kern = port.make_predict_fn(pparams, pcfg, use_kernel=True)(
        port_sim.model_input(state, cur["feat"], cur["addr"], cfg))
    np.testing.assert_allclose(kern.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_fused_path_is_c3_only():
    _, _, pcfg, pparams = _params("c1")
    with pytest.raises(ValueError, match="C3"):
        port.make_fused_predict_fn(pparams, pcfg)


def test_c1_with_the_trunk_kernel_raises_like_the_reference():
    rcfg, rparams, pcfg, pparams = _params("c1")
    x = np.zeros((2, CTX + 1, 50), np.float32)
    with pytest.raises(AssertionError, match="C3 depth"):
        ref.apply_raw(rparams, jnp.asarray(x), rcfg, use_kernel=True)
    with pytest.raises(ValueError, match="C3 depth"):
        port.apply_raw(pparams, torch.from_numpy(x), pcfg, use_kernel=True)


@pytest.mark.parametrize("kind", KINDS)
def test_init_predictor_layout_and_seed(kind):
    rcfg = ref.PredictorConfig(kind=kind)
    pcfg = port.PredictorConfig(kind=kind)
    rparams, _ = ref.init_predictor(jax.random.PRNGKey(0), rcfg)
    a = port.init_predictor(torch.Generator().manual_seed(5), pcfg, "cpu")
    b = port.init_predictor(torch.Generator().manual_seed(5), pcfg, "cpu")
    ra = dict(jax.tree_util.tree_flatten_with_path(rparams)[0])
    pa = jax.tree_util.tree_flatten_with_path(a)[0]
    pb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in pa] == list(ra)  # the reference's tree, leaf for leaf
    for (path, t), (_, u) in zip(pa, pb):
        name = path[-1].key
        assert tuple(t.shape) == tuple(ra[path].shape) and torch.equal(t, u), path
        if name == "b":
            assert not t.any()
        elif name.endswith("_g"):  # RMS-norm gains start at one
            assert bool((t == 1).all())
        else:
            std = 1.0 / np.sqrt(t.shape[0])
            assert float(t.abs().max()) <= 2 * std + 1e-6  # 2-sigma truncation
            assert abs(float(t.std()) / std - 0.88) < 0.1  # std of a 2-sigma truncated normal


@pytest.mark.parametrize("kind", KINDS)
def test_inference_mflops_matches_reference(kind):
    assert port.inference_mflops(port.PredictorConfig(kind=kind)) == \
        ref.inference_mflops(ref.PredictorConfig(kind=kind))


@pytest.mark.parametrize("kind", ["c2", "lstm3", "tx", "mlp"])
def test_unknown_kind_raises_value_error(kind):
    """As the reference's init and apply do (`ValueError(kind)`)."""
    pcfg = port.PredictorConfig(kind=kind, ctx_len=CTX)
    with pytest.raises(ValueError, match=kind):
        ref.init_predictor(jax.random.PRNGKey(0), ref.PredictorConfig(kind=kind, ctx_len=CTX))
    with pytest.raises(ValueError, match=kind):
        port.init_predictor(torch.Generator().manual_seed(0), pcfg, "cpu")
    with pytest.raises(ValueError, match=kind):
        port.param_shapes(pcfg)
    with pytest.raises(ValueError, match=kind):
        port.params_from_numpy({}, pcfg, "cpu")
    with pytest.raises(ValueError, match=kind):
        port.apply_raw({}, torch.zeros((1, CTX + 1, 50)), pcfg)


@pytest.mark.parametrize("kind", KINDS)
def test_param_shapes_are_the_reference_tree(kind):
    rparams, _ = ref.init_predictor(jax.random.PRNGKey(0), ref.PredictorConfig(kind=kind))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), rparams)
    assert port.param_shapes(port.PredictorConfig(kind=kind)) == want


@pytest.mark.parametrize("kind", ["lstm2", "ithemal_lstm2"])
def test_lstm_stack_equals_the_step_by_step_cells(kind):
    """The fused ``torch.lstm`` call (cuDNN on the card) against the
    reference's cell written out step by step, at rtol=atol=2e-5."""
    _, _, pcfg, pparams = _params(kind, seed=3)
    x = torch.from_numpy(_x(seed=4))
    np.testing.assert_allclose(port.lstm_stack(pparams, x, pcfg).numpy(),
                               port.lstm_cells(pparams, x, pcfg).numpy(), rtol=2e-5, atol=2e-5)


def test_bf16_compute_rounds_the_lstm_input_like_the_reference():
    """Every non-c kind rounds its input through ``compute_dtype`` and then
    computes in f32: bf16 outputs differ from f32 ones, in both packages
    alike."""
    rcfg, rparams, pcfg, pparams = _params("lstm2", seed=5)
    rcfg = dataclasses.replace(rcfg, compute_dtype="bfloat16")
    pcfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    x = _x(seed=6)
    want = np.asarray(ref_apply_raw(rparams, jnp.asarray(x), rcfg))
    got = port.apply_raw(pparams, torch.from_numpy(x), pcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    f32 = port.apply_raw(pparams, torch.from_numpy(x), dataclasses.replace(pcfg, compute_dtype="float32"))
    assert not torch.equal(got, f32)


@pytest.fixture(scope="module")
def small_pack():
    sim = O3Simulator(O3Config())
    return [ref_features.trace_arrays(sim.run(get_benchmark(n, s)))
            for n, s in (("mlb_mixed", 500), ("sim_loop", 400))]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_written_artifact_gives_the_reference_engines_totals(kind, small_pack, tmp_path):
    """An artifact the JAX package writes loads in the port (every leaf
    bit for bit, three levels deep for rb7 and tx6), and the port's CPU
    engine gives the JAX engine's totals on it."""
    rcfg, rparams, _, _ = _params(kind, seed=7)
    RefArtifact(rparams, rcfg, RefSimConfig(ctx_len=CTX)).save(tmp_path)
    art = PredictorArtifact.load(tmp_path, device="cpu")
    assert art.pcfg == port.PredictorConfig(kind=kind, ctx_len=CTX)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]}

    def get(path):
        node = art.params
        for k in path.split("/"):
            node = node[k]
        return node.numpy()

    for path, leaf in flat.items():
        assert get(path).tobytes() == leaf.tobytes(), path
    want = RefEngine(rparams, rcfg, RefSimConfig(ctx_len=CTX), cache=RefCache()).simulate_many(
        small_pack, n_lanes=2, chunk=64)
    got = SimNetEngine(art.params, art.pcfg, art.sim_cfg, device="cpu", cache=CompileCache()
                       ).simulate_many(small_pack, n_lanes=2, chunk=64)
    for k in ("workload_cycles", "workload_overflow", "n_instructions"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_params_from_numpy_checks_shapes():
    _, rparams, pcfg, _ = _params("c3")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    tree["conv1"]["w"] = tree["conv1"]["w"][:-1]
    with pytest.raises(ValueError, match="conv1.w"):
        port.params_from_numpy(tree, pcfg, "cpu")
    del tree["fc1"]
    tree["conv1"]["w"] = np.zeros((128, 128), np.float32)
    with pytest.raises(ValueError, match="fc1"):
        port.params_from_numpy(tree, pcfg, "cpu")
    _, rparams, pcfg, _ = _params("rb7")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    tree["rb2"]["mix"]["w"] = tree["rb2"]["mix"]["w"][:, :-1]
    with pytest.raises(ValueError, match=r"rb2\.mix\.w"):
        port.params_from_numpy(tree, pcfg, "cpu")


def test_config_fields_and_properties_match_reference():
    fa = [(f.name, f.type, f.default) for f in dataclasses.fields(ref.PredictorConfig)]
    fb = [(f.name, f.type, f.default) for f in dataclasses.fields(port.PredictorConfig)]
    assert fa == fb
    for kind in ("c1", "c3", "rb7", "fc2"):
        for ctx in (8, 16, 64):
            r, p = ref.PredictorConfig(kind=kind, ctx_len=ctx), port.PredictorConfig(kind=kind, ctx_len=ctx)
            for prop in ("seq_in", "n_stride2", "seq_padded", "out_dim"):
                assert getattr(r, prop) == getattr(p, prop), (kind, ctx, prop)
