"""The port's training path against the reference's: the hybrid loss and
its gradients (`repro_torch.core.session` vs `repro.core.session` and
``jax.grad``), Adam (`repro_torch.training.optimizer` vs
`repro.training.optimizer`), `train_loop` from the same weights in the same
batch order, and `prediction_errors`.

Tolerances: one forward or backward pass sums in another order than XLA's
(f32 outputs agree to ~1e-6 relative). Adam divides each update by
sqrt(v): on a weight whose gradient is near zero, a last-bit difference
moves the update by up to lr, so training runs drift apart step by step
(~2e-7 relative in the loss over the first 20 steps of the case here,
~7e-4 after 126; measured on the CPU). The per-step bounds below are
stated from that."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import predictor as ref_pred  # noqa: E402
from repro.core import session as ref_session  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.core import predictor as port_pred  # noqa: E402
from repro_torch.core import session as port_session  # noqa: E402
from repro_torch.core.dataset import build_dataset  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro_torch.des.workloads import get_benchmark  # noqa: E402
from repro_torch.training import optimizer as port_opt  # noqa: E402

CTX = 16
FIRST_STEPS, FIRST_RTOL = 20, 1e-5  # per-step loss, the first 20 steps
ALL_RTOL = 1e-2  # per-step loss, every step of 3 epochs
EPOCH_RTOL = 1e-3  # per-epoch train and validation loss


def _crossed(kind, seed=0):
    rcfg = ref_pred.PredictorConfig(kind=kind, ctx_len=CTX)
    pcfg = port_pred.PredictorConfig(kind=kind, ctx_len=CTX)
    rparams, _ = ref_pred.init_predictor(jax.random.PRNGKey(seed), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, rparams, pcfg, tree


@pytest.fixture(scope="module")
def data():
    sim = O3Simulator(O3Config())
    traces = [sim.run(get_benchmark(n, 3000)) for n in ("mlb_mixed", "sim_loop")]
    return build_dataset(traces, SimConfig(ctx_len=CTX), device="cpu")


def _flat(tree):
    """{path: numpy array} of a params tree of either package (JAX orders
    dict keys, the port keeps the reference's insertion order)."""
    return {jax.tree_util.keystr(path): np.asarray(leaf.detach().float() if isinstance(leaf, torch.Tensor)
                                                   else leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _labels(rng, n):
    """Latency labels with zeros, every class and overflow (>= 9)."""
    return rng.choice([0, 1, 2, 5, 8, 9, 10, 37], size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("output", ["hybrid", "reg"])
def test_hybrid_loss_matches_reference(output):
    rng = np.random.default_rng(0)
    pcfg = port_pred.PredictorConfig(output=output)
    rcfg = ref_pred.PredictorConfig(output=output)
    raw = rng.standard_normal((64, pcfg.out_dim)).astype(np.float32) * 3
    y = _labels(rng, 64)
    want = float(ref_session._hybrid_loss(jnp.asarray(raw), jnp.asarray(y), rcfg))
    got = float(port_session._hybrid_loss(torch.from_numpy(raw), torch.from_numpy(y), pcfg))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["fc2", "c3", "rb7", "lstm2", "tx6"])
def test_step0_gradients_match_jax_grad(kind, data):
    rcfg, rparams, pcfg, tree = _crossed(kind)
    x, y = data["train_x"][:128].astype(np.float32), data["train_y"][:128]
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_session._hybrid_loss(ref_pred.apply_raw(p, jnp.asarray(x), rcfg),
                                           jnp.asarray(y), rcfg)))(rparams)
    params = port_pred.params_from_numpy(tree, pcfg, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = port_session._hybrid_loss(port_pred.apply_raw(params, torch.from_numpy(x), pcfg),
                                     torch.from_numpy(y), pcfg)
    grads = iter(torch.autograd.grad(loss, leaves))
    got = _flat(tree_map(lambda _: next(grads), params))
    want = _flat(rgrads)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    assert sorted(got) == sorted(want)
    for path, rg in want.items():
        np.testing.assert_allclose(got[path], rg, rtol=1e-4, atol=1e-5 * float(np.abs(rg).max()),
                                   err_msg=path)


ADAM_CASES = {
    "default": dict(acfg=dict(), keep_master=False, dtype=np.float32),
    "no-clip": dict(acfg=dict(clip_norm=0.0), keep_master=False, dtype=np.float32),
    "warmup-cosine-decay": dict(acfg=dict(lr=3e-3, warmup_steps=2, decay_steps=6, weight_decay=0.01,
                                          clip_norm=0.5), keep_master=False, dtype=np.float32),
    "bf16-master": dict(acfg=dict(weight_decay=0.1, warmup_steps=3), keep_master=True,
                        dtype=jnp.bfloat16),
}


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_update_matches_reference(case):
    """Eight updates with random gradients (norms above and below the
    clip): params, m, v, step, master and the metrics agree."""
    c = ADAM_CASES[case]
    rng = np.random.default_rng(1)
    shapes = {"a": {"w": (6, 4), "b": (4,)}, "c": (5,)}
    init = jax.tree_util.tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                                  is_leaf=lambda s: isinstance(s, tuple))
    rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, c["dtype"]), init)
    tdtype = torch.bfloat16 if c["dtype"] is jnp.bfloat16 else torch.float32
    pp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(tdtype), init)
    racfg, pacfg = ref_opt.AdamConfig(**c["acfg"]), port_opt.AdamConfig(**c["acfg"])
    rs = ref_opt.adam_init(rp, keep_master=c["keep_master"])
    ps = port_opt.adam_init(pp, keep_master=c["keep_master"])
    for i in range(8):
        scale = 0.05 if i % 2 else 3.0
        g = jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), init)
        rp, rs, rm = ref_opt.adam_update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp, racfg)
        pp, ps, pm = port_opt.adam_update(jax.tree_util.tree_map(torch.from_numpy, g), ps, pp, pacfg)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6, err_msg=k)
        for name in ("m", "v") + (("master",) if c["keep_master"] else ()):
            for a, b in zip(tree_leaves(ps[name]), jax.tree_util.tree_leaves(rs[name])):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7, err_msg=name)
        for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(rp)):
            assert a.dtype == tdtype
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=1e-5,
                                       atol=1e-7)


def test_schedule_lr_matches_reference():
    acfg = dict(lr=2e-3, warmup_steps=10, decay_steps=50, min_lr_ratio=0.2)
    for step in (0, 1, 5, 10, 11, 30, 50, 80):
        want = float(ref_opt.schedule_lr(ref_opt.AdamConfig(**acfg), jnp.asarray(step, jnp.int32)))
        got = float(port_opt.schedule_lr(port_opt.AdamConfig(**acfg), torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


def _reference_step_losses(data, rcfg, params, epochs, batch_size, seed, lr):
    """The reference's per-step losses: its train_loop's step, in its batch
    order (its train_loop keeps only the per-epoch means)."""
    acfg = ref_opt.AdamConfig(lr=lr, clip_norm=1.0)
    opt = ref_opt.adam_init(params)

    @jax.jit
    def step(p, opt, x, y):
        loss, grads = jax.value_and_grad(lambda p: ref_session._hybrid_loss(
            ref_pred.apply_raw(p, x, rcfg), y, rcfg))(p)
        p, opt, _ = ref_opt.adam_update(grads, opt, p, acfg)
        return p, opt, loss

    rng, out = np.random.default_rng(seed), []
    X, Y = data["train_x"], data["train_y"]
    for _ in range(epochs):
        perm = rng.permutation(len(X))
        for lo in range(0, len(X) - batch_size + 1, batch_size):
            idx = perm[lo : lo + batch_size]
            params, opt, loss = step(params, opt, jnp.asarray(X[idx], jnp.float32), jnp.asarray(Y[idx]))
            out.append(float(loss))
    return np.asarray(out)


def test_train_loop_follows_the_reference(data, monkeypatch):
    """From the same weights (the port's init patched to return the JAX
    ones) and the same batch order: per-step losses, per-epoch losses and
    the best-validation snapshot."""
    rcfg, rparams, pcfg, tree = _crossed("c3")
    monkeypatch.setattr(ref_session, "init_predictor", lambda key, cfg: (rparams, None))
    monkeypatch.setattr(port_session, "init_predictor",
                        lambda gen, cfg, dev: port_pred.params_from_numpy(tree, cfg, dev))
    kw = dict(epochs=3, batch_size=128, seed=0)
    rbest, rh = ref_session.train_loop(data, rcfg, **kw)
    pbest, ph = port_session.train_loop(data, pcfg, device="cpu", **kw)
    steps = _reference_step_losses(data, rcfg, rparams, lr=1e-3, **kw)
    got = np.asarray(ph["step_loss"])
    assert len(got) == len(steps) == 3 * (len(data["train_x"]) // 128)
    np.testing.assert_allclose(got[:FIRST_STEPS], steps[:FIRST_STEPS], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got, steps, rtol=ALL_RTOL)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(ph[k], rh[k], rtol=EPOCH_RTOL, err_msg=k)
    assert int(np.argmin(ph["val_loss"])) == int(np.argmin(rh["val_loss"]))
    assert len(ph["step_seconds"]) == 3 and min(ph["step_seconds"]) > 0
    # the returned params are the best epoch's snapshot: they give its
    # validation loss again
    assert not any(t.requires_grad for t in tree_leaves(pbest))
    bs = kw["batch_size"]
    vl = [float(port_session._loss(pbest, torch.from_numpy(data["val_x"][lo : lo + bs].astype(np.float32)),
                                   torch.from_numpy(data["val_y"][lo : lo + bs]), pcfg))
          for lo in range(0, len(data["val_x"]) - bs + 1, bs)]
    np.testing.assert_allclose(np.mean(vl), min(ph["val_loss"]), rtol=1e-6)


def test_train_loop_without_validation_batches_returns_the_final_params(data, monkeypatch):
    _, _, pcfg, tree = _crossed("c1")
    monkeypatch.setattr(port_session, "init_predictor",
                        lambda gen, cfg, dev: port_pred.params_from_numpy(tree, cfg, dev))
    small = dict(data, val_x=data["val_x"][:10], val_y=data["val_y"][:10])
    params, h = port_session.train_loop(small, pcfg, epochs=1, batch_size=256, device="cpu")
    assert np.isnan(h["val_loss"]).all() and len(h["step_loss"]) == len(data["train_x"]) // 256
    init = port_pred.params_from_numpy(tree, pcfg, "cpu")
    assert not torch.equal(params["fc1"]["w"], init["fc1"]["w"])


@pytest.mark.parametrize("kind", ["c3", "lstm2"])
def test_prediction_errors_match_reference(kind, data):
    rcfg, rparams, pcfg, tree = _crossed(kind, seed=2)
    X, Y = data["test_x"], data["test_y"]
    want = ref_session.prediction_errors(rparams, rcfg, X, Y, batch_size=100)
    got = port_session.prediction_errors(port_pred.params_from_numpy(tree, pcfg, "cpu"), pcfg, X, Y,
                                         batch_size=100)
    assert sorted(got) == sorted(want) == ["execution", "fetch", "store"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_train_loop_default_device_is_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error path cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_session.train_loop(data, port_pred.PredictorConfig(ctx_len=CTX), epochs=1)


def test_adam_config_fields_match_reference():
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(port_opt.AdamConfig) == fields(ref_opt.AdamConfig)
