"""LM training in the port against the JAX package, on the CPU: the losses
(`repro_torch.training.losses` vs `repro.training.losses`), the loss and
every gradient leaf of each family's `make_loss_fn` (autograd vs
``jax.value_and_grad`` of the reference's own `make_loss_fn`), remat on
against off, and the microbatch split.

Weights are the reference's ``init`` at reduced width in f32, crossed over
as numpy arrays into f32 masters (``params_from_numpy(..., masters=True)``);
the reference's stacked layers meet the port's per-layer lists through
`repro_torch.models.lm.layer_list`. Inputs come from numpy seeds.

Tolerances, f32: one forward and backward pass sums in another order than
XLA's, so a loss agrees to ~1e-7 relative and a gradient leaf to ~1e-6 of
its largest entry (measured here); the gates are a loss within 1e-5
relative and each leaf within 1e-4 x max|g_leaf| + 1e-7 absolute. Remat
recomputes the same operations on the same inputs, so on the CPU it is
held bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.models.registry import build_model as ref_build_model  # noqa: E402
from repro.training import losses as ref_losses  # noqa: E402
from repro.training import train_loop as ref_train_loop  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.training import losses, train_loop  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
# one arch a family, and gemma3-4b for its local/global layers (6 layers:
# layer 5 is global)
GRAD_ARCHS = {"tinyllama-1.1b": {}, "gemma3-4b": {"n_layers": 6}, "mixtral-8x7b": {},
              "qwen2-vl-72b": {}, "recurrentgemma-2b": {}, "whisper-large-v3": {},
              "rwkv6-1.6b": {}}
B, T = 2, 16
N_PATCHES = 4


def _noop(x, _axes):
    return x


def configs(name, **kw):
    kw = dict(GRAD_ARCHS.get(name, {}), dtype="float32", **kw)
    return ref_reduced(REF_ARCHS[name], **kw), reduced(ARCHS[name], **kw)


def lm_batch(cfg, seed, batch=B, seq=T):
    """numpy inputs: tokens, a loss mask with zeros, and frames (whisper)
    or leading patches + M-RoPE positions (qwen2-vl)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
           "loss_mask": (rng.random((batch, seq)) < 0.8).astype(np.float32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.standard_normal((batch, N_PATCHES, cfg.frontend_dim)).astype(np.float32)
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (3, batch, seq))
        out["mrope_positions"] = (pos + np.arange(3, dtype=np.int32)[:, None, None]).copy()
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaf_pairs(port, ref, path=""):
    """(path, port leaf, reference leaf as a tensor) over two trees of the
    port's structure."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            yield from leaf_pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from leaf_pairs(a, b, f"{path}#{i}")
    else:
        yield path, port, ref


def assert_grads_close(port_grads, ref_grads_np, model):
    """Each of the port's gradient leaves against the reference's (crossed
    into the port's structure by ``params_from_numpy``)."""
    ref = model.params_from_numpy(ref_grads_np, "cpu", masters=True)
    n = 0
    for path, g, r in leaf_pairs(port_grads, ref):
        assert g.dtype == torch.float32, path
        tol = GRAD_RTOL * float(r.abs().max()) + GRAD_ATOL
        d = float((g - r).abs().max())
        assert d <= tol, f"{path}: max |diff| {d:.3e} > {tol:.3e}"
        n += 1
    return n


@pytest.mark.parametrize("masked", [False, True])
def test_next_token_ce_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal((3, 12, 97))).astype(np.float32)
    tokens = rng.integers(0, 97, (3, 12)).astype(np.int32)
    mask = (rng.random((3, 12)) < 0.6).astype(np.float32) if masked else None
    want = float(ref_losses.next_token_ce(jnp.asarray(logits), jnp.asarray(tokens),
                                          None if mask is None else jnp.asarray(mask)))
    got = losses.next_token_ce(torch.from_numpy(logits), torch.from_numpy(tokens),
                               None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if masked:  # an all-zero mask divides by max(sum, 1): zero, not NaN
        zero = losses.next_token_ce(torch.from_numpy(logits), torch.from_numpy(tokens),
                                    torch.zeros(3, 12))
        assert float(zero) == 0.0


def test_bf16_logits_are_taken_in_f32():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((2, 9, 33)).astype(np.float32)).to(torch.bfloat16)
    tokens = torch.from_numpy(rng.integers(0, 33, (2, 9)).astype(np.int32))
    want = float(ref_losses.next_token_ce(jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16),
                                          jnp.asarray(tokens.numpy())))
    np.testing.assert_allclose(float(losses.next_token_ce(logits, tokens)), want, rtol=1e-6)


def test_hybrid_latency_loss_and_mse_match_reference():
    rng = np.random.default_rng(5)
    n_classes = 10
    cls_logits = rng.standard_normal((64, n_classes)).astype(np.float32)
    reg = (5 * rng.standard_normal(64)).astype(np.float32)
    # below zero, inside the classes, and past the overflow class
    targets = rng.uniform(-2, 14, 64).astype(np.float32)
    want = float(ref_losses.hybrid_latency_loss(jnp.asarray(cls_logits), jnp.asarray(reg),
                                                jnp.asarray(targets), n_classes))
    got = losses.hybrid_latency_loss(torch.from_numpy(cls_logits), torch.from_numpy(reg),
                                     torch.from_numpy(targets), n_classes)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    want = float(ref_losses.mse(jnp.asarray(reg), jnp.asarray(targets)))
    np.testing.assert_allclose(float(losses.mse(torch.from_numpy(reg), torch.from_numpy(targets))),
                               want, rtol=1e-6)


@pytest.mark.parametrize("arch", sorted(GRAD_ARCHS))
def test_loss_and_every_gradient_leaf_match_reference(arch):
    rcfg, cfg = configs(arch)
    rm, model = ref_build_model(rcfg), build_model(cfg)
    rparams, _ = rm.init(jax.random.PRNGKey(len(arch)))
    batch = lm_batch(cfg, seed=len(arch))
    ref_fn = jax.jit(jax.value_and_grad(ref_train_loop.make_loss_fn(rm, _noop), has_aux=True))
    (ref_loss, ref_metrics), ref_grads = ref_fn(rparams, {k: jnp.asarray(v) for k, v in batch.items()})

    params = model.params_from_numpy(np_tree(rparams), "cpu", masters=True)
    assert all(t.dtype == torch.float32 for t in tree_leaves(params))
    loss, metrics, grads = train_loop.loss_and_grads(train_loop.make_loss_fn(model), params,
                                                     to_torch(batch))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(ref_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=LOSS_RTOL, err_msg=k)
    n = assert_grads_close(grads, np_tree(ref_grads), model)
    assert n == sum(1 for _ in tree_leaves(params))


def _counted_checkpoint(monkeypatch):
    calls = []
    real = lm.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(lm, "checkpoint", counted)
    return calls


def _n_remat_layers(cfg):
    return cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)


@pytest.mark.parametrize("arch", sorted(GRAD_ARCHS))
def test_remat_on_equals_remat_off_bit_for_bit(arch, monkeypatch):
    """``remat="full"`` checkpoints every layer (each encoder and decoder
    layer for whisper) while autograd records, and its logits and grads
    equal ``remat="none"``'s bit for bit; serving (no grad) checkpoints
    nothing."""
    _, cfg = configs(arch)
    model_on = build_model(dataclasses.replace(cfg, remat="full"))
    model_off = build_model(dataclasses.replace(cfg, remat="none"))
    params = model_on.init(torch.Generator().manual_seed(7), device="cpu", masters=True)
    batch = to_torch(lm_batch(cfg, seed=8))
    calls = _counted_checkpoint(monkeypatch)
    out = {}
    for name, model in (("on", model_on), ("off", model_off)):
        n0 = len(calls)
        out[name] = train_loop.loss_and_grads(train_loop.make_loss_fn(model), params, batch)
        out[name + "_calls"] = len(calls) - n0
        with torch.no_grad():
            out[name + "_logits"] = model.forward(params, batch)[0]
    assert out["on_calls"] == _n_remat_layers(cfg) and out["off_calls"] == 0
    assert torch.equal(out["on_logits"], out["off_logits"])
    assert torch.equal(out["on"][0], out["off"][0])
    for path, a, b in leaf_pairs(out["on"][2], out["off"][2]):
        assert torch.equal(a, b), path
    # serving: params that need no grad, or no grad recorded, run plainly
    n0 = len(calls)
    with torch.no_grad():
        model_on.forward(params, batch)
    model_on.prefill(model_on.to_storage(params), {k: v for k, v in batch.items() if k != "loss_mask"})
    assert len(calls) == n0


def test_masters_are_the_reference_init_and_storage_is_the_serving_cast():
    """``masters=True`` keeps every leaf f32 (the reference's masters bit
    for bit); `to_storage` casts them to what ``masters=False`` loads, and
    the result needs no grad."""
    rcfg = ref_reduced(REF_ARCHS["mixtral-8x7b"])  # bf16 compute, f32 router
    model = build_model(reduced(ARCHS["mixtral-8x7b"]))
    tree = np_tree(ref_build_model(rcfg).init(jax.random.PRNGKey(0))[0])
    masters = model.params_from_numpy(tree, "cpu", masters=True)
    served = model.params_from_numpy(tree, "cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(masters))
    np.testing.assert_array_equal(masters["embed"]["w"].numpy(), tree["embed"]["w"])
    np.testing.assert_array_equal(masters["blocks"][1]["moe"]["wi_up"].numpy(),
                                  tree["blocks"]["moe"]["wi_up"][1])
    trained = {k: v for k, v in masters.items()}
    trained["blocks"] = [tree_map(lambda t: t.requires_grad_(True), lp) for lp in masters["blocks"]]
    for path, s, want in leaf_pairs(model.to_storage(trained), served):
        assert s.dtype == want.dtype and torch.equal(s, want) and not s.requires_grad, path
    assert served["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert served["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16


def test_split_microbatches_matches_reference_layout():
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, 50, (4, 6)).astype(np.int32),
             "frames": rng.standard_normal((4, 3, 5)).astype(np.float32),
             "mrope_positions": rng.integers(0, 6, (3, 4, 6)).astype(np.int32)}
    want = ref_train_loop._split_microbatches({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = train_loop._split_microbatches(to_torch(batch), 2)
    assert got["mrope_positions"].shape == (2, 3, 2, 6)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # microbatch i of M-RoPE positions is the (3, B/2, S) of its rows
    np.testing.assert_array_equal(got["mrope_positions"][1].numpy(), batch["mrope_positions"][:, 2:])


def test_split_microbatches_picks_mrope_positions_by_key():
    """At a batch of 3 in 3 microbatches, frames (3, F, d) split on their
    batch axis in the port; the reference, which picks M-RoPE positions by
    shape, splits them on their second axis (its quirk, ROADMAP.md Queue 3)."""
    rng = np.random.default_rng(10)
    batch = {"tokens": rng.integers(0, 50, (3, 6)).astype(np.int32),
             "frames": rng.standard_normal((3, 6, 5)).astype(np.float32),
             "mrope_positions": rng.integers(0, 6, (3, 3, 6)).astype(np.int32)}
    got = train_loop._split_microbatches(to_torch(batch), 3)
    want = ref_train_loop._split_microbatches({k: jnp.asarray(v) for k, v in batch.items()}, 3)
    assert got["frames"].shape == (3, 1, 6, 5)
    for i in range(3):
        np.testing.assert_array_equal(got["frames"][i].numpy(), batch["frames"][i:i + 1])
        np.testing.assert_array_equal(got["mrope_positions"][i].numpy(),
                                      batch["mrope_positions"][:, i:i + 1])
    for k in ("tokens", "mrope_positions"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert np.asarray(want["frames"]).shape == (3, 3, 2, 5)  # the reference's quirk
