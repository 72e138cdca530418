"""The port's LM decode path (`repro_torch.models`, `repro_torch.nn`,
`repro_torch.serving.engine`) against the JAX package, on the CPU.

Weights are made by the reference's ``init_lm`` and cross over as numpy
arrays through `params_from_numpy`; prompts come from numpy seeds. The
configs are the reduced dense ones, gemma3-4b at 6 layers so that layer 5
is global (``reduced()`` keeps 2 layers, both local). The reference runs
where it can: the plain path through its jitted `DecodeEngine` with
``scan_layers=True``, the kernel path (`decode_step(use_kernel=True)`)
eagerly with ``scan_layers=False`` — under scan or jit its
``int(window)`` meets a tracer. Tolerances: 1e-4 in f32 (sums taken in
another order); bf16 as stated at its test.
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
from repro.models import lm as ref_lm  # noqa: E402
from repro.models.registry import build_model as ref_build_model  # noqa: E402
from repro.nn import attention as ref_attn  # noqa: E402
from repro.serving.engine import DecodeEngine as RefDecodeEngine  # noqa: E402
from repro.serving.engine import lm_decoder as ref_lm_decoder  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import layers  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, lm_decoder  # noqa: E402

DENSE = ("tinyllama-1.1b", "qwen3-4b", "gemma3-4b")
B, PROMPT, STEPS = 2, 40, 8  # prompt longer than the reduced window (32)
CACHE = PROMPT + STEPS
TOL = 1e-4


def _overrides(name, **kw):
    return dict(kw, n_layers=6) if name == "gemma3-4b" else kw


def _configs(name, **kw):
    kw = _overrides(name, **kw)
    return ref_reduced(REF_ARCHS[name], **kw), reduced(ARCHS[name], **kw)


def _prompts(cfg, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)


def _rehome_ref(rm, state, batch, seq):
    full = rm.init_decode_state(batch, seq)
    T = state["k"].shape[2]
    return {"k": full["k"].at[:, :, :T].set(state["k"]),
            "v": full["v"].at[:, :, :T].set(state["v"]), "pos": state["pos"]}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_config_copy_equals_reference(name):
    assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(REF_ARCHS[name])
    assert dataclasses.asdict(reduced(ARCHS[name])) == dataclasses.asdict(ref_reduced(REF_ARCHS[name]))
    port, ref = reduced(ARCHS[name], n_layers=6, dtype="float32"), ref_reduced(REF_ARCHS[name], n_layers=6, dtype="float32")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [port.layer_window(i) for i in range(6)] == [ref.layer_window(i) for i in range(6)]


def test_config_registry_mirrors_reference():
    assert list_archs() == sorted(REF_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


# ------------------------------------------------------ plain path, vs JAX


@pytest.fixture(scope="module")
def runs():
    """Per dense config: the reference's f32 run (scan_layers=True) and its
    weights as numpy arrays, made once for the module."""
    out = {}
    for name in DENSE:
        rcfg, cfg = _configs(name, dtype="float32", scan_layers=True)
        rm = ref_build_model(rcfg)
        rparams, _ = rm.init(jax.random.PRNGKey(len(name)))
        tokens = _prompts(cfg, seed=len(name))
        logits, state = rm.prefill(rparams, {"tokens": jnp.asarray(tokens)})
        first = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
        full = _rehome_ref(rm, state, B, CACHE)
        gen, _, _ = RefDecodeEngine(ref_lm_decoder(rm), rparams).generate(full, first, STEPS)
        # the same greedy stream, step by step, for the per-step logits
        step = jax.jit(rm.decode_step)
        st, tok, step_logits = full, first, []
        for i in range(STEPS):
            lg, st = step(rparams, st, tok)
            step_logits.append(np.asarray(lg))
            tok = jnp.asarray(gen[i])
        out[name] = dict(cfg=cfg, rcfg=rcfg, rparams=rparams, params=_np(rparams), tokens=tokens,
                         logits=np.asarray(logits), k=np.asarray(state["k"]),
                         v=np.asarray(state["v"]), first=np.array(first),
                         gen=np.asarray(gen), step_logits=step_logits)
    return out


def _port(run):
    model = build_model(run["cfg"])
    return model, lm.params_from_numpy(run["params"], run["cfg"], "cpu")


@pytest.mark.parametrize("name", DENSE)
def test_prefill_matches_reference(runs, name):
    run = runs[name]
    model, params = _port(run)
    logits, state = model.prefill(params, {"tokens": torch.from_numpy(run["tokens"])})
    assert logits.shape == (B, 1, run["cfg"].vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), run["logits"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state["k"].numpy(), run["k"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state["v"].numpy(), run["v"], rtol=TOL, atol=TOL)
    assert state["pos"].dtype == torch.int32 and int(state["pos"]) == PROMPT


@pytest.mark.parametrize("name", DENSE)
def test_decode_engine_matches_reference(runs, name):
    """8 greedy steps of the port's DecodeEngine are token-identical to the
    JAX DecodeEngine, and each step's logits agree within 1e-4."""
    run = runs[name]
    model, params = _port(run)
    _, state = model.prefill(params, {"tokens": torch.from_numpy(run["tokens"])})
    full = lm.rehome_state(model.cfg, state, CACHE)
    first = torch.from_numpy(run["first"])
    tokens, final, tps = DecodeEngine(lm_decoder(model), params).generate(full, first, STEPS)
    assert tokens.dtype == torch.int32 and tokens.shape == (STEPS, B) and tps > 0
    np.testing.assert_array_equal(tokens.numpy(), run["gen"])
    assert int(final["pos"]) == PROMPT + STEPS
    st, tok = full, first
    for i in range(STEPS):
        lg, st = model.decode_step(params, st, tok)
        np.testing.assert_allclose(lg.numpy(), run["step_logits"][i], rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")
        tok = tokens[i]


# ----------------------------------------------------- kernel path, vs JAX


@pytest.mark.parametrize("name", DENSE)
def test_kernel_path_matches_reference_eager(runs, name):
    """decode_step(use_kernel=True): the port (the kernel's plain version,
    on the CPU) against the reference's kernel in interpret mode, which
    runs only eagerly and unscanned."""
    run = runs[name]
    rcfg = dataclasses.replace(run["rcfg"], scan_layers=False)
    stacked = run["rparams"]["blocks"]
    rparams = dict(run["rparams"], blocks={
        f"layer_{i}": jax.tree_util.tree_map(lambda a: a[i], stacked) for i in range(rcfg.n_layers)})
    rm = ref_build_model(rcfg)
    _, rstate = ref_build_model(run["rcfg"]).prefill(run["rparams"], {"tokens": jnp.asarray(run["tokens"])})
    rstate = _rehome_ref(rm, rstate, B, CACHE)
    model, params = _port(run)
    _, state = model.prefill(params, {"tokens": torch.from_numpy(run["tokens"])})
    state = lm.rehome_state(model.cfg, state, CACHE)
    plain = lm.rehome_state(model.cfg, state, CACHE)
    ops.reset_launches()
    tok = run["first"]
    for i in range(2):
        want, rstate = ref_lm.decode_step(rparams, rcfg, rstate, jnp.asarray(tok), use_kernel=True)
        got, state = model.decode_step(params, state, torch.from_numpy(tok), use_kernel=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=f"step {i}")
        lg, plain = model.decode_step(params, plain, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), lg.numpy(), rtol=TOL, atol=TOL)
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    assert ops.launches["decode_attn"] == 0  # CPU tensors take the plain version


# ---------------------------------------------------------------- bf16


def test_bf16_prefill_and_step_match_reference():
    """gemma3-4b (6 layers) in bf16, its working dtype. XLA fuses
    elementwise chains and rounds to bf16 at other points than eager
    PyTorch, which rounds after every op, so single logits differ by a few
    units in the last place of bf16 (8 significant bits). Tolerance: 4
    units in the last place at the largest logit (0.125 for logits up to
    8), absolute."""
    rcfg, cfg = _configs("gemma3-4b")
    assert cfg.dtype == "bfloat16"
    rm, model = ref_build_model(rcfg), build_model(cfg)
    rparams, _ = rm.init(jax.random.PRNGKey(3))
    params = lm.params_from_numpy(_np(rparams), cfg, "cpu")
    tokens = _prompts(cfg, seed=3)
    want, rstate = rm.prefill(rparams, {"tokens": jnp.asarray(tokens)})
    got, state = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16 and state["k"].dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=4 * ulp)
    tok = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
    want1, _ = rm.decode_step(rparams, _rehome_ref(rm, rstate, B, CACHE), jnp.asarray(tok))
    got1, _ = model.decode_step(params, lm.rehome_state(model.cfg, state, CACHE), torch.from_numpy(tok))
    want1 = np.asarray(want1, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want1).max())) - 7)
    np.testing.assert_allclose(got1.float().numpy(), want1, rtol=0, atol=4 * ulp)


def test_storage_dtypes():
    """Matrices and the embedding table are stored in the compute dtype,
    norm scales in f32 — what each use site casts them to."""
    _, cfg = _configs("gemma3-4b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"]["w"].dtype == torch.bfloat16
    blk = params["blocks"][0]
    assert blk["attn"]["wq"].dtype == blk["mlp"]["wo"].dtype == torch.bfloat16
    assert blk["attn"]["wq"].shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)  # (in, out)
    for norm in (blk["ln1"], blk["ln1_post"], blk["ln2"], blk["attn"]["q_norm"], params["final_norm"]):
        assert norm["g"].dtype == torch.float32
    assert len(params["blocks"]) == cfg.n_layers


# ------------------------------------------------------------- converter


def test_converter_takes_stacked_and_per_layer_trees():
    rcfg, cfg = _configs("gemma3-4b", dtype="float32", scan_layers=True)
    stacked, _ = ref_lm.init_lm(jax.random.PRNGKey(5), rcfg)
    per_layer, _ = ref_lm.init_lm(jax.random.PRNGKey(5), dataclasses.replace(rcfg, scan_layers=False))
    assert "layer_0" in per_layer["blocks"] and "layer_0" not in stacked["blocks"]
    a = lm.params_from_numpy(_np(stacked), cfg, "cpu")
    b = lm.params_from_numpy(_np(per_layer), cfg, "cpu")
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, x), (_, y) in zip(flat_a, flat_b):
        assert torch.equal(x, y), path
    np.testing.assert_array_equal(a["blocks"][5]["attn"]["wk"].numpy(),
                                  np.asarray(stacked["blocks"]["attn"]["wk"][5]))
    with pytest.raises(ValueError, match="layers"):
        lm.params_from_numpy(_np(stacked), dataclasses.replace(cfg, n_layers=5), "cpu")


# -------------------------------------------------------------- re-homing


def test_rehome_state_copies_the_prompt_cache():
    _, cfg = _configs("tinyllama-1.1b", dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    _, state = model.prefill(params, {"tokens": torch.from_numpy(_prompts(cfg, seed=4))})
    full = lm.rehome_state(cfg, state, CACHE)
    assert full["k"].shape == (cfg.n_layers, B, CACHE, cfg.n_kv_heads, cfg.head_dim)
    assert torch.equal(full["k"][:, :, :PROMPT], state["k"]) and torch.equal(full["v"][:, :, :PROMPT], state["v"])
    assert not full["k"][:, :, PROMPT:].any() and int(full["pos"]) == PROMPT
    full["pos"] += 1
    assert int(state["pos"]) == PROMPT  # a copy, not a view


def test_entry_points_default_to_cuda():
    """Every family's entry points: init, decode state and the weight
    converter run on cuda unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error path cannot be exercised")
    for name in sorted(ARCHS):
        model = build_model(reduced(ARCHS[name]))
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_decode_state(1, 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            model.params_from_numpy({"blocks": {}})


# ------------------------------------------------------------ the pieces


def test_decode_attention_plain_path_matches_reference():
    """The model's own plain path (compute-dtype q.k, f32 softmax, NEG_INF)
    against the reference's, f32 and bf16, with and without a window."""
    rng = np.random.default_rng(11)
    Bq, H, KV, hd, S = 2, 8, 2, 32, 96
    q = rng.standard_normal((Bq, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, S, KV, hd)).astype(np.float32)
    for window, cache_len in ((0, 70), (24, 70), (24, 10)):
        for dt, jdt, tol in ((torch.float32, jnp.float32, 2e-5), (torch.bfloat16, jnp.bfloat16, 3e-2)):
            want = ref_attn.decode_attention(
                jnp.asarray(q, jdt), ref_attn.KVCache(jnp.asarray(k, jdt), jnp.asarray(v, jdt)),
                jnp.asarray(cache_len, jnp.int32), dtype=jdt, window=window)
            got = attn.decode_attention(
                torch.from_numpy(q).to(dt), attn.KVCache(torch.from_numpy(k).to(dt), torch.from_numpy(v).to(dt)),
                torch.tensor(cache_len, dtype=torch.int32), dtype=dt, window=window)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=tol, atol=tol, err_msg=f"{dt} window={window}")


def test_cache_update_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(12)
    k = rng.standard_normal((2, 6, 2, 4)).astype(np.float32)
    k1 = rng.standard_normal((2, 2, 4)).astype(np.float32)
    for index in (0, 3, 5, 6, 9):
        want = ref_attn.cache_update(ref_attn.KVCache(jnp.asarray(k), jnp.asarray(k)),
                                     jnp.asarray(k1), jnp.asarray(k1), jnp.asarray(index, jnp.int32))
        cache = attn.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(k.copy()))
        got = attn.cache_update(cache, torch.from_numpy(k1), torch.from_numpy(k1),
                                torch.tensor(index, dtype=torch.int32))
        assert got.k is cache.k  # written in place
        np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k), err_msg=f"index {index}")


def test_gelu_and_gemma_embedding_scale_follow_the_reference():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    for name in ("gelu", "gelu_tanh"):  # jax.nn.gelu is the tanh form by default
        np.testing.assert_allclose(layers._act(name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    _, cfg = _configs("gemma3-4b", d_model=2560)
    params = {"embed": {"w": torch.ones((4, 2560), dtype=torch.bfloat16)}}
    x = lm.embed_tokens(params, cfg, torch.tensor([[1]]))
    assert float(x[0, 0, 0]) == 50.5  # sqrt(2560) = 50.596 rounded to bf16 first


def test_generate_leaves_the_callers_state_alone():
    """Decode steps write the cache in place; generate decodes from copies,
    so the warm-up and the timed pass start from the same state and the
    caller's state is unchanged."""
    _, cfg = _configs("tinyllama-1.1b", dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.from_numpy(_prompts(cfg, seed=2))
    logits, state = model.prefill(params, {"tokens": tokens})
    full = lm.rehome_state(model.cfg, state, CACHE)
    before = {k: v.clone() for k, v in full.items()}
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    engine = DecodeEngine(lm_decoder(model), params, mesh=None, donate=True)
    tok1, fin, _ = engine.generate(full, first, 4)
    for k in full:
        assert torch.equal(full[k], before[k]), k
    tok2, _, _ = engine.generate(full, first, 4)
    assert torch.equal(tok1, tok2)
    assert int(fin["pos"]) == PROMPT + 4 and not torch.equal(fin["k"], before["k"])


def test_step_graphs_are_keyed_by_shape_and_dtype():
    """One decode-step graph per (state shapes and dtypes, token shape)."""
    from repro_torch.serving.engine import _program_key

    _, cfg = _configs("tinyllama-1.1b", dtype="float32")
    model = build_model(cfg)
    a = model.init_decode_state(2, 48, device="cpu")
    tok = torch.zeros(2, dtype=torch.int32)
    assert _program_key(a, tok) == _program_key(model.init_decode_state(2, 48, device="cpu"), tok)
    for other in (model.init_decode_state(2, 64, device="cpu"),
                  model.init_decode_state(3, 48, device="cpu"),
                  {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in a.items()}):
        assert _program_key(other, tok) != _program_key(a, tok)
