"""The port's predictor against the reference `repro.core.predictor`:
JAX-initialised weights cross over through `params_from_numpy` and give
the same raw outputs (rtol=atol=2e-5) and the same decoded latencies."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import predictor as ref  # noqa: E402
from repro_torch.core import predictor as port  # noqa: E402
from repro_torch.core import simulator as port_sim  # noqa: E402

CTX = 16


def _params(kind, seed=1):
    rcfg = ref.PredictorConfig(kind=kind, ctx_len=CTX)
    rparams, _ = ref.init_predictor(jax.random.PRNGKey(seed), rcfg)
    pcfg = port.PredictorConfig(kind=kind, ctx_len=CTX)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, rparams, pcfg, port.params_from_numpy(tree, pcfg, "cpu")


@pytest.mark.parametrize("kind", ["c1", "c3"])
def test_crossed_weights_give_the_reference_outputs(kind):
    rcfg, rparams, pcfg, pparams = _params(kind)
    x = np.random.default_rng(0).random((12, CTX + 1, 50)).astype(np.float32)
    want = np.asarray(ref.apply_raw(rparams, jnp.asarray(x), rcfg))
    got = port.apply_raw(pparams, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # decode the SAME raw outputs in both: identical latencies
    np.testing.assert_array_equal(
        port.decode_latency(torch.tensor(want), pcfg).numpy(),
        np.asarray(ref.decode_latency(jnp.asarray(want), rcfg)))
    np.testing.assert_array_equal(
        port.decode_latency(got, pcfg).numpy(),
        np.asarray(ref.decode_latency(jnp.asarray(want), rcfg)))


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


@pytest.mark.parametrize("kind", ["c1", "c3"])
def test_init_predictor_layout_and_seed(kind):
    rcfg = ref.PredictorConfig(kind=kind)
    pcfg = port.PredictorConfig(kind=kind)
    rparams, _ = ref.init_predictor(jax.random.PRNGKey(0), rcfg)
    a = port.init_predictor(torch.Generator().manual_seed(5), pcfg, "cpu")
    b = port.init_predictor(torch.Generator().manual_seed(5), pcfg, "cpu")
    assert sorted(a) == sorted(rparams)
    for name in a:
        for k in ("w", "b"):
            assert tuple(a[name][k].shape) == tuple(rparams[name][k].shape), (name, k)
            assert torch.equal(a[name][k], b[name][k])
        w = a[name]["w"]
        std = 1.0 / np.sqrt(w.shape[0])
        assert float(w.abs().max()) <= 2 * std + 1e-6  # 2-sigma truncation
        assert abs(float(w.std()) / std - 0.88) < 0.1  # std of a 2-sigma truncated normal
        assert not a[name]["b"].any()


@pytest.mark.parametrize("kind", ["fc2", "fc3", "c1", "c3", "rb7", "lstm2",
                                  "ithemal_lstm2", "tx6"])
def test_inference_mflops_matches_reference(kind):
    assert port.inference_mflops(port.PredictorConfig(kind=kind)) == \
        ref.inference_mflops(ref.PredictorConfig(kind=kind))


@pytest.mark.parametrize("kind", ["fc2", "rb7", "lstm2", "ithemal_lstm2", "tx6"])
def test_unported_kinds_raise(kind):
    pcfg = port.PredictorConfig(kind=kind, ctx_len=CTX)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.init_predictor(torch.Generator().manual_seed(0), pcfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.apply_raw({}, torch.zeros((1, CTX + 1, 50)), pcfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.params_from_numpy({}, pcfg, "cpu")


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


def test_config_fields_and_properties_match_reference():
    fa = [(f.name, f.type, f.default) for f in dataclasses.fields(ref.PredictorConfig)]
    fb = [(f.name, f.type, f.default) for f in dataclasses.fields(port.PredictorConfig)]
    assert fa == fb
    for kind in ("c1", "c3", "rb7", "fc2"):
        for ctx in (8, 16, 64):
            r, p = ref.PredictorConfig(kind=kind, ctx_len=ctx), port.PredictorConfig(kind=kind, ctx_len=ctx)
            for prop in ("seq_in", "n_stride2", "seq_padded", "out_dim"):
                assert getattr(r, prop) == getattr(p, prop), (kind, ctx, prop)
