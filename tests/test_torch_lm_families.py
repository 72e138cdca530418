"""The port's other LM families (MoE with the SWA ring cache, VLM with
M-RoPE and the vision stub, the RG-LRU hybrid, Whisper, RWKV6) against
the JAX package, on the CPU.

Weights are made by the reference's ``init`` and cross over as numpy
arrays through ``Model.params_from_numpy``; prompts, frames and patches
come from numpy seeds. The reference runs jitted (``forward``,
``prefill``, ``decode_step``), re-homed as ``examples/serve_lm.py`` does;
the port decodes through ``DecodeEngine.generate`` (eager on the CPU)
with ``use_kernel=True`` (the kernel's plain version for CPU tensors).

Configs are ``reduced()`` with these changes, each to reach a path:
- mixtral: ``local_window`` 8 and ``capacity_factor`` 0.5, a 6-token
  prompt and 10 steps: the ring of 8 positions wraps, and the prefill
  drops tokens at capacity;
- recurrentgemma: a 40-token prompt past its window of 32, so the prefill
  rolls its attention tail into the ring;
- qwen2-vl: 4 image patches in the leading positions and M-RoPE positions
  of a 2 x 2 patch grid, then text.

Tolerances, f32: rtol = atol = 1e-4 (sums taken in another order; the
RG-LRU prefill scan is associated in another order too). bf16 as stated
at its test.
"""
import dataclasses
import os
import runpy
import subprocess
import sys
from pathlib import Path

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
from repro.nn import layers as ref_layers  # noqa: E402
from repro.nn import moe as ref_moe  # noqa: E402
from repro.nn import rope as ref_rope  # noqa: E402
from repro.nn import ssm as ref_ssm  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.nn import layers, moe, rope, ssm  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, _program_key, lm_decoder  # noqa: E402

FAMILIES = sorted(n for n, c in REF_ARCHS.items() if c.family != "dense")
B = 2
TOL = 1e-4
# arch -> (reduced() overrides, prompt tokens, decode steps)
SETUP = {
    "mixtral-8x7b": (dict(local_window=8, capacity_factor=0.5), 6, 10),
    "phi3.5-moe-42b-a6.6b": ({}, 12, 8),
    "qwen2-vl-72b": ({}, 12, 8),
    "recurrentgemma-2b": ({}, 40, 8),
    "whisper-large-v3": ({}, 8, 8),
    "rwkv6-1.6b": ({}, 12, 8),
}
N_PATCHES = 4  # qwen2-vl: a 2 x 2 grid of image patches
REPO = Path(__file__).resolve().parents[1]


def test_every_non_dense_arch_is_covered():
    assert FAMILIES == sorted(SETUP)
    for name in sorted(ARCHS):  # and every arch builds
        assert build_model(ARCHS[name]).cfg is ARCHS[name]


def _configs(name, **kw):
    kw = dict(SETUP[name][0], **kw)
    return ref_reduced(REF_ARCHS[name], **kw), reduced(ARCHS[name], **kw)


def _batch(cfg, T, seed):
    """numpy inputs: tokens, and frames (whisper) or patches + M-RoPE
    positions (qwen2-vl)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.standard_normal((B, N_PATCHES, cfg.frontend_dim)).astype(np.float32)
        t = np.arange(T)
        thw = np.stack([np.where(t < N_PATCHES, 0, t), np.where(t < N_PATCHES, t // 2, t),
                        np.where(t < N_PATCHES, t % 2, t)])
        batch["mrope_positions"] = np.broadcast_to(thw[:, None], (3, B, T)).astype(np.int32).copy()
    return batch


def _rehome_ref(rm, state, seq):
    """examples/serve_lm.py's re-homing, on the reference's state."""
    full = rm.init_decode_state(B, seq)
    for k in state:
        if k == "pos":
            full["pos"] = state["pos"]
        elif k in full and hasattr(full[k], "shape") and full[k].shape != state[k].shape:
            full[k] = full[k].at[tuple(slice(0, s) for s in state[k].shape)].set(state[k])
        else:
            full[k] = state[k]
    return full


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _reference_run(name, dtype):
    rcfg, cfg = _configs(name, dtype=dtype)
    _, T, steps = SETUP[name]
    rm = ref_build_model(rcfg)
    rparams, _ = rm.init(jax.random.PRNGKey(len(name)))
    batch = _batch(cfg, T, seed=len(name))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, state = jax.jit(rm.prefill)(rparams, jb)
    first = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
    step = jax.jit(rm.decode_step)
    st, tok, toks, step_logits = _rehome_ref(rm, state, T + steps), first, [], []
    for _ in range(steps):
        lg, st = step(rparams, st, tok)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        step_logits.append(np.asarray(lg, np.float32))
    return dict(cfg=cfg, rm=rm, rparams=rparams, params=_np(rparams), batch=batch,
                logits=np.asarray(logits, np.float32), state=_np(state), first=np.array(first),
                gen=np.stack(toks), step_logits=step_logits, final=_np(st), jb=jb)


@pytest.fixture(scope="module")
def runs():
    """Per arch, the reference's f32 run, made once for the module."""
    return {name: _reference_run(name, "float32") for name in FAMILIES}


def _port(run):
    model = build_model(run["cfg"])
    return model, model.params_from_numpy(run["params"], "cpu")


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol, atol=tol, err_msg=what)


# ------------------------------------------------------------- families


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(runs, name):
    run = runs[name]
    model, params = _port(run)
    want, waux = jax.jit(run["rm"].forward)(run["rparams"], run["jb"])
    got, aux = model.forward(params, _t(run["batch"]))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), f"{name} forward logits")
    if model.cfg.family == "moe":
        _close(aux["moe_loss"].numpy(), np.asarray(waux["moe_loss"]), "moe_loss")


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_reference(runs, name):
    """Last-token logits and every leaf of the decode state."""
    run = runs[name]
    model, params = _port(run)
    logits, state = model.prefill(params, _t(run["batch"]))
    _close(logits.numpy(), run["logits"], f"{name} prefill logits")
    got = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), state))
    want = jax.tree_util.tree_leaves_with_path(run["state"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        _close(g, w, f"{name} state {jax.tree_util.keystr(path)}")
    if name == "mixtral-8x7b":  # capacity_factor 0.5: the prefill drops tokens
        _, aux = model.forward(params, _t(run["batch"]))
        assert 0 < float(aux["moe_dropped"]) < 1


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_engine_matches_reference(runs, name):
    """The port's DecodeEngine (use_kernel=True) from the re-homed prefill
    state is token-identical to the reference's greedy steps, each step's
    logits within 1e-4, the final state too."""
    run = runs[name]
    model, params = _port(run)
    _, T, steps = SETUP[name]
    _, state = model.prefill(params, _t(run["batch"]))
    full = model.rehome_state(state, T + steps)
    first = torch.from_numpy(run["first"])
    ops.reset_launches()
    tokens, final, tps = DecodeEngine(lm_decoder(model, use_kernel=True), params).generate(
        full, first, steps)
    assert tokens.dtype == torch.int32 and tokens.shape == (steps, B) and tps > 0
    np.testing.assert_array_equal(tokens.numpy(), run["gen"])
    assert ops.launches["decode_attn"] == 0  # CPU tensors take the plain version
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), final)),
            jax.tree_util.tree_leaves_with_path(run["final"])):
        _close(g, w, f"{name} final state {jax.tree_util.keystr(path)}")
    st, tok = full, first
    for i in range(steps):
        lg, st = model.decode_step(params, st, tok)
        _close(lg.numpy(), run["step_logits"][i], f"{name} step {i}")
        tok = tokens[i]


@pytest.mark.parametrize("name", ["mixtral-8x7b", "recurrentgemma-2b", "whisper-large-v3",
                                  "rwkv6-1.6b"])
def test_bf16_prefill_and_step_match_reference(name):
    """The working dtype. XLA fuses elementwise chains and rounds to bf16
    at other points than eager PyTorch, which rounds after every op, so a
    logit differs by a few units in the last place of bf16 (8 significant
    bits). Tolerance: 8 units in the last place at the largest logit,
    absolute, for the prefill and the first decode step."""
    run = _reference_run(name, "bfloat16")
    model, params = _port(run)
    assert model.cfg.dtype == "bfloat16"
    logits, state = model.prefill(params, _t(run["batch"]))
    _, T, steps = SETUP[name]
    assert logits.dtype == torch.bfloat16
    lg, _ = model.decode_step(params, model.rehome_state(state, T + steps),
                              torch.from_numpy(run["first"]))
    for what, got, want in (("prefill", logits, run["logits"]), ("step", lg, run["step_logits"][0])):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=8 * ulp, err_msg=what)


# ------------------------------------------------------- caches and state


def test_swa_ring_wraps_like_the_reference(runs):
    """mixtral at window 8: 6 prompt tokens + 10 steps in a ring of 8, so
    positions 8..15 overwrite slots 0..7; the ring's contents after the
    wrap are the reference's."""
    run = runs["mixtral-8x7b"]
    model, params = _port(run)
    _, state = model.prefill(params, _t(run["batch"]))
    full = model.rehome_state(state, 16)
    assert full["k"].shape[2] == 8 == lm.cache_size(model.cfg, 16)
    _, final, _ = DecodeEngine(lm_decoder(model), params).generate(
        full, torch.from_numpy(run["first"]), 10)
    assert int(final["pos"]) == 16
    _close(final["k"].numpy(), run["final"]["k"], "ring k after the wrap")
    _close(final["v"].numpy(), run["final"]["v"], "ring v after the wrap")


def test_prompt_longer_than_the_swa_window_cannot_be_rehomed(runs):
    """The reference cannot re-home a 12-token prefill cache into a ring of
    8 (serve_lm.py's slice-set fails); the port raises."""
    run = runs["mixtral-8x7b"]
    model, params = _port(run)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (B, 12)).astype(np.int32))
    _, state = model.prefill(params, {"tokens": tokens})
    with pytest.raises(ValueError, match="re-home"):
        model.rehome_state(state, 20)


def test_hybrid_short_prompt_keeps_its_prefill_ring(runs):
    """A quirk of the reference kept as it is: serve_lm.py does not
    re-home the hybrid's per-layer dicts, so after a prompt shorter than
    the window the ring is the prompt's length; decoding then wraps that
    ring, in both packages alike."""
    run = runs["recurrentgemma-2b"]
    model, params = _port(run)
    T, steps = 10, 6
    tokens = np.random.default_rng(3).integers(0, model.cfg.vocab, (B, T)).astype(np.int32)
    rm = run["rm"]
    rl, rstate = jax.jit(rm.prefill)(run["rparams"], {"tokens": jnp.asarray(tokens)})
    rfull = _rehome_ref(rm, rstate, T + steps)
    logits, state = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    full = model.rehome_state(state, T + steps)
    assert full["layer_2"]["k"].shape[1] == T == rfull["layer_2"]["k"].shape[1] < model.cfg.local_window
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    tokens_out, _, _ = DecodeEngine(lm_decoder(model), params).generate(full, first, steps)
    step = jax.jit(rm.decode_step)
    st, tok, want = rfull, jnp.asarray(first.numpy()), []
    for _ in range(steps):
        lg, st = step(run["rparams"], st, tok)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(tokens_out.numpy(), np.stack(want))


def test_nested_state_keys_a_step_graph():
    """The hybrid's state is a dict of per-layer dicts: the step graph's
    key walks it (same shapes, same key; a ring of another length, a
    dtype or a batch gives another key)."""
    _, cfg = _configs("recurrentgemma-2b", dtype="float32")
    model = build_model(cfg)
    tok = torch.zeros(B, dtype=torch.int32)
    a = model.init_decode_state(B, 24, device="cpu")
    assert isinstance(a["layer_0"], dict) and set(a["layer_2"]) == {"k", "v"}
    assert _program_key(a, tok) == _program_key(model.init_decode_state(B, 24, device="cpu"), tok)
    other_ring = model.init_decode_state(B, 16, device="cpu")
    bf16 = dict(a, layer_0={"h": a["layer_0"]["h"], "conv": a["layer_0"]["conv"].bfloat16()})
    for other, t in ((other_ring, tok), (bf16, tok), (model.init_decode_state(3, 24, device="cpu"),
                                                      torch.zeros(3, dtype=torch.int32))):
        assert _program_key(other, t) != _program_key(a, tok)


def test_storage_dtypes_follow_each_use_site():
    """Matrices in the compute dtype, but the leaves each family's use
    sites compute in f32 stay f32: the MoE router, the RG-LRU gate blocks
    and RWKV6's decay LoRA; every 1-D leaf f32."""
    g = torch.Generator().manual_seed(0)
    moe_p = build_model(reduced(ARCHS["mixtral-8x7b"])).init(g, device="cpu")
    blk = moe_p["blocks"][0]
    assert blk["moe"]["router"].dtype == torch.float32
    assert blk["moe"]["wi_gate"].dtype == blk["attn"]["wq"].dtype == torch.bfloat16
    assert blk["moe"]["wi_gate"].shape == (4, 128, 256)  # (E, D, F)
    vlm = build_model(reduced(ARCHS["qwen2-vl-72b"])).init(g, device="cpu")
    assert vlm["frontend"]["w"].dtype == torch.bfloat16
    hyb = build_model(reduced(ARCHS["recurrentgemma-2b"])).init(g, device="cpu")
    rec = hyb["blocks"][0]["rec"]
    assert rec["rglru"]["w_input_gate"].dtype == rec["rglru"]["w_rec_gate"].dtype == torch.float32
    assert rec["rglru"]["w_input_gate"].ndim == 3 and rec["rglru"]["lam"].dtype == torch.float32
    assert rec["wx"].dtype == rec["conv"]["w"].dtype == torch.bfloat16
    assert rec["conv"]["b"].dtype == torch.float32
    rw = build_model(reduced(ARCHS["rwkv6-1.6b"])).init(g, device="cpu")
    tm = rw["blocks"][0]["tm"]
    assert tm["decay_lora"]["a"].dtype == tm["decay_lora"]["b"].dtype == torch.float32
    assert tm["wr"].dtype == rw["blocks"][0]["cm"]["wk"].dtype == torch.bfloat16
    wh = build_model(reduced(ARCHS["whisper-large-v3"])).init(g, device="cpu")
    assert wh["decoder"][0]["mlp"]["wi"]["w"].dtype == torch.bfloat16
    assert wh["decoder"][0]["mlp"]["wi"]["b"].dtype == torch.float32
    for p in (moe_p, vlm, hyb, rw, wh):
        for t in jax.tree_util.tree_leaves(p):
            assert t.ndim >= 2 or t.dtype == torch.float32


def test_converted_weights_are_the_references_in_storage_dtype():
    """What each use site sees is the reference's weight cast at the use,
    bit for bit: bf16 leaves equal the f32 masters rounded to bf16, f32
    leaves equal them exactly."""
    rcfg, cfg = _configs("recurrentgemma-2b")
    rparams, _ = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    params = build_model(cfg).params_from_numpy(_np(rparams), "cpu")
    rec, rrec = params["blocks"][0]["rec"], rparams["blocks"]["layer_0"]["rec"]
    np.testing.assert_array_equal(rec["rglru"]["w_rec_gate"].numpy(), np.asarray(rrec["rglru"]["w_rec_gate"]))
    np.testing.assert_array_equal(rec["wx"].float().numpy(),
                                  np.asarray(rrec["wx"].astype(jnp.bfloat16).astype(jnp.float32)))


# ------------------------------------------------------------ the pieces


def test_moe_apply_with_drops_and_loss_match_reference():
    """GShard dispatch at capacity factor 0.5 over 4 groups of 8 tokens:
    output, router logits and the load-balancing loss; some choices drop."""
    rng = np.random.default_rng(7)
    D, F, E = 32, 48, 4
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    params = {"router": rng.standard_normal((D, E)).astype(np.float32),
              "wi_gate": rng.standard_normal((E, D, F)).astype(np.float32) / 6,
              "wi_up": rng.standard_normal((E, D, F)).astype(np.float32) / 6,
              "wo": rng.standard_normal((E, F, D)).astype(np.float32) / 7}
    kw = dict(n_experts=E, top_k=2, capacity_factor=0.5, group_size=8)
    want, wlog = jax.jit(lambda p, x: ref_moe.moe_apply(p, x, dtype=jnp.float32, **kw))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    got, glog = moe.moe_apply({k: torch.from_numpy(v) for k, v in params.items()},
                              torch.from_numpy(x), dtype=torch.float32, **kw)
    _close(got.numpy(), np.asarray(want), "moe output", 1e-5)
    _close(glog.numpy(), np.asarray(wlog), "router logits", 1e-5)
    share = float(moe.dropped_share(glog, n_experts=E, top_k=2, capacity_factor=0.5))
    assert 0 < share < 1
    _close(moe.load_balancing_loss(glog, n_experts=E).numpy(),
           np.asarray(ref_moe.load_balancing_loss(wlog, n_experts=E)), "loss", 1e-6)
    with pytest.raises(ValueError, match="must divide"):
        moe.moe_apply({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x[:, :12]), dtype=torch.float32, **dict(kw, group_size=7))


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = moe._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_mrope_and_text_positions_match_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 5)).astype(np.int32)
    for sections in ((4, 6, 6), (16, 0, 0), (2, 7, 7)):
        want = ref_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
        got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, 1e6)
        _close(got.numpy(), np.asarray(want), f"mrope {sections}", 1e-5)
    text = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_array_equal(rope.text_mrope_positions(torch.from_numpy(text)).numpy(),
                                  np.asarray(ref_rope.text_mrope_positions(jnp.asarray(text))))
    # on text positions M-RoPE is plain RoPE
    tp = rope.text_mrope_positions(torch.from_numpy(text))
    _close(rope.apply_mrope(torch.from_numpy(x), tp, (4, 6, 6)).numpy(),
           rope.apply_rope(torch.from_numpy(x), torch.from_numpy(text)).numpy(), "text mrope", 1e-6)
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 4, 4))


def test_sinusoid_table_matches_reference():
    """Computed in f64 and rounded once to f32 on both sides; the f64 sin
    and exp of two libraries may differ in the last f64 place, which
    moves an f32 value by at most one unit (6e-8 at 1)."""
    for length, dim in ((1500, 1280), (16, 128), (7, 6)):
        want = np.asarray(ref_rope.sinusoid_table(length, dim))
        got = rope.sinusoid_table(length, dim).numpy()
        assert got.dtype == np.float32 and got.shape == (length, dim)
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    rows = rope.sinusoid_rows(torch.tensor([0, 9, 3]), 128).numpy()
    np.testing.assert_array_equal(rows, rope.sinusoid_table(10, 128).numpy()[[0, 9, 3]])


def test_causal_conv1d_and_its_step_match_reference():
    rng = np.random.default_rng(9)
    p = {"w": rng.standard_normal((4, 16)).astype(np.float32),
         "b": rng.standard_normal(16).astype(np.float32)}
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = ref_layers.causal_conv1d({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                    dtype=jnp.float32)
    got = layers.causal_conv1d(tp, torch.from_numpy(x), dtype=torch.float32)
    _close(got.numpy(), np.asarray(want), "conv", 1e-6)
    state = torch.zeros(2, 3, 16)
    for t in range(7):  # step by step from a zero lookback = the sequence form
        y, state = layers.causal_conv1d_step(tp, torch.from_numpy(x[:, t]), state, dtype=torch.float32)
        _close(y.numpy(), got[:, t].numpy(), f"conv step {t}", 1e-6)
    np.testing.assert_array_equal(state.numpy(), x[:, 4:])


def test_rglru_sequence_equals_its_steps_and_the_reference():
    """The doubling scan over T = 37 (not a power of two) against the
    reference's associative scan and the port's own step loop, f32 at
    1e-5, with and without an initial state."""
    g = torch.Generator().manual_seed(3)
    p = ssm.rglru_params(g, 32, 4)
    p["lam"] = p["lam"] + torch.linspace(-2, 2, 32)  # decays spread over (0, 1)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 37, 32)).astype(np.float32)
    h0 = rng.standard_normal((2, 32)).astype(np.float32)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    for init in (None, h0):
        want, wlast = jax.jit(lambda p, x, h: ref_ssm.rglru(p, x, h, n_heads=4, dtype=jnp.float32))(
            jp, jnp.asarray(x), None if init is None else jnp.asarray(init))
        got, glast = ssm.rglru(p, torch.from_numpy(x), None if init is None else torch.from_numpy(init),
                               n_heads=4, dtype=torch.float32)
        _close(got.numpy(), np.asarray(want), "rglru", 1e-5)
        _close(glast.numpy(), np.asarray(wlast), "rglru last", 1e-5)
        h = torch.zeros(2, 32) if init is None else torch.from_numpy(init)
        for t in range(37):
            y, h = ssm.rglru_step(p, torch.from_numpy(x[:, t]), h, n_heads=4, dtype=torch.float32)
            _close(y.numpy(), got[:, t].numpy(), f"rglru step {t}", 1e-5)


def test_rwkv_timemix_sequence_equals_its_steps_and_the_reference():
    """RWKV6 time-mix: the time loop against the reference's scan, and
    against the port's step form token by token; the f32 wkv state too."""
    g = torch.Generator().manual_seed(4)
    p = ssm.rwkv_timemix_params(g, 64, 4)
    p["u"] = p["u"] + 0.3
    p["w0"] = p["w0"] + 5.0  # decays away from 1
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    x_last = rng.standard_normal((2, 64)).astype(np.float32)
    s0 = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    want, wx, ws = ref_ssm.rwkv_timemix(jp, jnp.asarray(x), jnp.asarray(x_last), jnp.asarray(s0),
                                        n_heads=4, dtype=jnp.float32)
    got, gx, gs = ssm.rwkv_timemix(p, torch.from_numpy(x), torch.from_numpy(x_last),
                                   torch.from_numpy(s0), n_heads=4, dtype=torch.float32)
    _close(got.numpy(), np.asarray(want), "timemix", 1e-5)
    _close(gs.numpy(), np.asarray(ws), "wkv state", 1e-5)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    xl, s = torch.from_numpy(x_last), torch.from_numpy(s0)
    for t in range(9):
        y, xl, s = ssm.rwkv_timemix_step(p, torch.from_numpy(x[:, t]), xl, s, n_heads=4,
                                         dtype=torch.float32)
        _close(y.numpy(), got[:, t].numpy(), f"timemix step {t}", 1e-5)
    assert s.dtype == torch.float32
    _close(s.numpy(), gs.numpy(), "wkv state after the steps", 1e-5)


def test_rwkv_timemix_gradients_equal_the_references():
    """The wkv loop's backward (each input split along T once, its
    gradient stacked once): the gradients of a seeded weighting of the
    time-mix output and last state, in x, x_last, the state and every
    param, against ``jax.grad`` through the reference's ``lax.scan``, f32
    at 1e-4."""
    g = torch.Generator().manual_seed(6)
    p = ssm.rwkv_timemix_params(g, 32, 2)
    p["u"] = p["u"] + 0.3
    p["w0"] = p["w0"] + 5.0
    rng = np.random.default_rng(13)
    x, x_last = (rng.standard_normal(s).astype(np.float32) for s in ((2, 11, 32), (2, 32)))
    s0 = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    cy, cs = (rng.standard_normal(s).astype(np.float32) for s in ((2, 11, 32), (2, 2, 16, 16)))

    def ref_loss(jp, x, xl, s):
        y, _, last = ref_ssm.rwkv_timemix(jp, x, xl, s, n_heads=2, dtype=jnp.float32)
        return jnp.sum(y * cy) + jnp.sum(last * cs)

    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2, 3)))(jp, jnp.asarray(x), jnp.asarray(x_last),
                                                   jnp.asarray(s0))
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), p)
    tx, txl, ts = (torch.from_numpy(a).requires_grad_(True) for a in (x, x_last, s0))
    y, _, last = ssm.rwkv_timemix(tp, tx, txl, ts, n_heads=2, dtype=torch.float32)
    leaves = jax.tree_util.tree_leaves(tp)
    got = torch.autograd.grad((y * torch.from_numpy(cy)).sum() + (last * torch.from_numpy(cs)).sum(),
                              leaves + [tx, txl, ts])
    for name, gt, wt in zip([jax.tree_util.keystr(k) for k, _ in
                             jax.tree_util.tree_flatten_with_path(tp)[0]] + ["x", "x_last", "state"],
                            got, jax.tree_util.tree_leaves(want[0]) + list(want[1:])):
        _close(gt.numpy(), np.asarray(wt), f"d loss / d {name}", 1e-4)


def test_rwkv_channelmix_matches_reference():
    g = torch.Generator().manual_seed(5)
    p = ssm.rwkv_channelmix_params(g, 64, 96)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    xl = rng.standard_normal((2, 64)).astype(np.float32)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    want, _ = ref_ssm.rwkv_channelmix(jp, jnp.asarray(x), jnp.asarray(xl), dtype=jnp.float32)
    got, gx = ssm.rwkv_channelmix(p, torch.from_numpy(x), torch.from_numpy(xl), dtype=torch.float32)
    _close(got.numpy(), np.asarray(want), "channelmix", 1e-5)
    step, _ = ssm.rwkv_channelmix_step(p, torch.from_numpy(x[:, 0]), torch.from_numpy(xl),
                                       dtype=torch.float32)
    _close(step.numpy(), got[:, 0].numpy(), "channelmix step", 1e-6)


def test_converter_checks_the_layer_count():
    rcfg, cfg = _configs("rwkv6-1.6b")
    rparams, _ = ref_build_model(rcfg).init(jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match="layers"):
        build_model(dataclasses.replace(cfg, n_layers=3)).params_from_numpy(_np(rparams), "cpu")


def test_serve_lm_example_runs_a_hybrid_on_the_cpu(capsys):
    """``examples/serve_lm_torch.py`` as a child process (one intra-op
    thread) on a reduced hybrid, through the kernel path's plain version:
    it prefills, decodes, and prints the same greedy stream as the same
    ``main`` in this process; without ``--device cpu`` it needs a GPU."""
    script = REPO / "examples" / "serve_lm_torch.py"
    argv = ["--arch", "recurrentgemma-2b", "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--use-kernel"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), *argv, "--device", "cpu"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "generated 4 tokens × 2 requests" in proc.stdout
    runpy.run_path(str(script))["main"](argv + ["--device", "cpu"])
    here = capsys.readouterr().out
    first = [line for line in proc.stdout.splitlines() if line.startswith("first request:")]
    assert len(first) == 1 and first[0] in here.splitlines()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            runpy.run_path(str(script))["main"](argv)
