"""The port's kernel wrappers (`repro_torch.kernels.ops`).

On the CPU each wrapper computes its plain version; these are held against
the reference's Pallas kernels, run in interpret mode exactly as
tests/test_kernels.py runs them, at rtol=atol=2e-5. The CUDA kernels
themselves are held against the plain versions on the card (marked
``cuda``; they skip without a GPU). JAX is imported only by the tests that
compare with the reference, so the ``cuda`` tests run where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from repro_torch.core import features as F  # noqa: E402
from repro_torch.core import simulator as port_sim  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CHANS = [50, 64, 128, 128]


def _layers(seed, chans=CHANS):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((2 * chans[i], chans[i + 1])) * 0.1).astype(np.float32),
             "b": (rng.standard_normal(chans[i + 1]) * 0.05).astype(np.float32)}
            for i in range(3)]


def _torch_layers(layers, device="cpu"):
    return [{k: torch.from_numpy(v).to(device) for k, v in lp.items()} for lp in layers]


def _step_inputs(L, n_steps, seed):
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        is_store = rng.random(L) < 0.3
        feat = (rng.random((L, F.STATIC_END)) * (rng.random((L, F.STATIC_END)) < 0.3)).astype(np.float32)
        feat[:, 7] = is_store
        steps.append({"feat": feat,
                      "addr": rng.integers(0, 20, (L, F.N_ADDR_KEYS)).astype(np.int32),
                      "is_store": is_store,
                      "lats": rng.integers(0, 12, (L, 3)).astype(np.float32)})
    return steps


def _port_state(L, ctx, steps, device="cpu", state_dtype="float32"):
    cfg = port_sim.SimConfig(ctx_len=ctx, state_dtype=state_dtype)
    state = port_sim.init_state(L, cfg, device)
    for s in steps:
        cur = {k: torch.from_numpy(s[k]).to(device) for k in ("feat", "addr", "is_store")}
        state = port_sim.sim_step(state, cur, torch.from_numpy(s["lats"]).to(device), cfg)
    return state, cur


def _ref_state(L, ctx, steps):
    import jax.numpy as jnp

    from repro.core import simulator as ref_sim

    cfg = ref_sim.SimConfig(ctx_len=ctx)
    state = ref_sim.init_state(L, cfg)
    for s in steps:
        cur = {k: jnp.asarray(s[k]) for k in ("feat", "addr", "is_store")}
        state = ref_sim.sim_step(state, cur, jnp.asarray(s["lats"]), cfg)
    return state, cur


def _decode_inputs(B, H, KV, hd, S, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for shape in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.fixture(scope="module")
def ref_ops():
    pytest.importorskip("jax")
    from repro.kernels import ops as reference_ops

    return reference_ops


# ---------------------------------------------------------------- plain vs JAX


@pytest.mark.parametrize("B", [64, 70])  # 70: the reference pads lanes to its tile
def test_plain_cnn_trunk_matches_reference(ref_ops, B):
    import jax.numpy as jnp

    x = np.random.default_rng(B).standard_normal((B, 72, CHANS[0])).astype(np.float32)
    layers = _layers(B)
    want = ref_ops.cnn_trunk([{k: jnp.asarray(v) for k, v in lp.items()} for lp in layers],
                             jnp.asarray(x))
    got = ops.cnn_trunk(_torch_layers(layers), torch.from_numpy(x))
    assert got.shape == (B, 9, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("L,ctx", [(4, 16), (70, 8)])  # 70: lane padding in the reference
def test_plain_fused_step_matches_reference(ref_ops, L, ctx):
    import jax.numpy as jnp

    steps = _step_inputs(L, 24, seed=L + ctx)
    layers = _layers(ctx)
    seq_padded = ((ctx + 1 + 7) // 8) * 8
    rstate, rcur = _ref_state(L, ctx, steps)
    want = ref_ops.fused_step([{k: jnp.asarray(v) for k, v in lp.items()} for lp in layers],
                              rstate, rcur["feat"], rcur["addr"], seq_padded=seq_padded)
    pstate, pcur = _port_state(L, ctx, steps)
    got = ops.fused_step(_torch_layers(layers), pstate, pcur["feat"], pcur["addr"],
                         seq_padded=seq_padded)
    assert got.shape == (L, seq_padded // 8, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,N,C,Co", [(64, 112, 50, 64), (7, 8, 16, 32), (70, 56, 64, 128),
                                     # the three C3 layers, and a lane longer than
                                     # shared memory (1024 x 64 floats)
                                     (3, 72, 50, 64), (3, 36, 64, 128), (3, 18, 128, 128),
                                     (2, 1024, 64, 64)])
def test_plain_conv2s_matches_reference(ref_ops, B, N, C, Co):
    import jax.numpy as jnp

    rng = np.random.default_rng(B + N)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    w = (rng.standard_normal((2 * C, Co)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(Co) * 0.1).astype(np.float32)
    want = ref_ops.conv2s({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = ops.conv2s({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    assert got.shape == (B, N // 2, Co) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_conv2s_bf16_inputs_match_reference(ref_ops):
    """Both wrappers cast bf16 inputs to f32 and return f32."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 32, 24)).astype(np.float32)
    w = (rng.standard_normal((48, 32)) * 0.1).astype(np.float32)
    b = np.zeros(32, np.float32)
    want = ref_ops.conv2s({"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b, jnp.bfloat16)},
                          jnp.asarray(x, jnp.bfloat16))
    got = ops.conv2s({"w": torch.from_numpy(w).bfloat16(), "b": torch.from_numpy(b).bfloat16()},
                     torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("B,H,KV,hd,S,cache_len,window,dtype", [
    (1, 4, 4, 32, 64, 64, 0, "float32"),      # MHA, full cache
    (2, 8, 2, 32, 300, 150, 0, "float32"),    # GQA, S not a block multiple, cache half full
    (3, 10, 1, 64, 700, 700, 256, "float32"),  # MQA, window
    (2, 8, 4, 256, 130, 100, 64, "float32"),  # gemma3's head_dim and group, window
    (1, 4, 2, 32, 64, 80, 0, "float32"),      # cache_len past S: clamped
    (2, 4, 4, 32, 128, 128, 0, "bfloat16"),
    (2, 8, 4, 64, 200, 150, 48, "bfloat16"),
])
def test_plain_decode_attn_matches_reference(ref_ops, B, H, KV, hd, S, cache_len, window, dtype):
    """Against the Pallas kernel in interpret mode: rtol=atol=2e-5 in f32,
    3e-2 in bf16 (the output is rounded to bf16, as the reference's)."""
    import jax.numpy as jnp

    q, k, v = _decode_inputs(B, H, KV, hd, S, seed=S + H, dtype=getattr(torch, dtype))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), getattr(jnp, dtype)) for t in (q, k, v))
    want = ref_ops.decode_attn(jq, jk, jv, jnp.asarray(cache_len, jnp.int32), window=window)
    got = ops.decode_attn(q, k, v, torch.tensor(cache_len, dtype=torch.int32), window=window)
    assert got.shape == (B, H, hd) and got.dtype == q.dtype
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------- K4's shard mode (kvseq)

# (B, H, KV, hd, S, window, cache_len, shard boundaries): gemma3-4b's local
# layers at 2112 positions over two ranks (cache_len 2100: rank 0 reads
# nothing of the window of 1024), a window across the boundary, a global
# layer, a cache not yet past rank 1's offset, and four shards (the first
# outside the window, the last past the cache)
_SHARD_CASES = [
    (2, 8, 4, 256, 2112, 1024, 2100, (0, 1056)),
    (2, 8, 4, 256, 2112, 1024, 1500, (0, 1056)),
    (2, 8, 4, 256, 2112, 0, 2100, (0, 1056)),
    (3, 8, 2, 64, 96, 0, 40, (0, 48)),
    (1, 4, 4, 32, 80, 32, 70, (0, 20, 40, 60)),
]


def _unsharded_plain(q, k, v, cache_len, window):
    """decode_attn_ref as it stood before its shard mode: -1e30 fill, then
    the softmax over every position."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.to(torch.float32))
    logits = logits / float(np.sqrt(np.float32(hd)))
    pos = torch.arange(S, dtype=torch.int32)
    valid = pos < cache_len
    if window > 0:
        valid = valid & (pos >= cache_len - window)
    probs = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", probs, v.to(torch.float32)).reshape(B, H, hd)


def _shards(k, v, bounds):
    S = k.shape[1]
    ends = list(bounds[1:]) + [S]
    return [(lo, k[:, lo:hi], v[:, lo:hi]) for lo, hi in zip(bounds, ends)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,S,window,cache_len,bounds", _SHARD_CASES)
def test_plain_decode_attn_shards_merge_to_the_whole(B, H, KV, hd, S, window, cache_len, bounds,
                                                    dtype):
    """Each shard's (out, lse) at its offset, merged by log-sum-exp
    (`nn.attention.merge_rows`), is the unsharded call within 1e-5 (f32
    sums in another order); a shard with no live position gives 0 and
    -inf."""
    from repro_torch.nn.attention import merge_rows

    q, k, v = _decode_inputs(B, H, KV, hd, S, seed=S + window, dtype=getattr(torch, dtype))
    cl = torch.tensor(cache_len, dtype=torch.int32)
    outs, lses = [], []
    for lo, ks, vs in _shards(k, v, bounds):
        out, lse = ops.decode_attn(q, ks, vs, cl, window=window, offset=lo, return_lse=True)
        assert out.dtype == torch.float32 and lse.shape == (B, H)
        live = min(cache_len, lo + ks.shape[1]) - max(cache_len - window if window else 0, lo)
        if live <= 0:
            assert torch.equal(out, torch.zeros_like(out))
            assert bool(torch.isneginf(lse).all())
        outs.append(out)
        lses.append(lse)
    whole = ref.decode_attn_ref(q, k, v, cl, window=window)
    np.testing.assert_allclose(merge_rows(torch.stack(outs), torch.stack(lses)).numpy(),
                               whole.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,KV,hd,S,window,cache_len,bounds", _SHARD_CASES)
def test_plain_decode_attn_unsharded_is_unchanged(B, H, KV, hd, S, window, cache_len, bounds):
    """The unsharded call gives what it gave before the shard mode, bit for
    bit, as does the shard mode over the whole cache (offset 0); an empty
    range now gives 0 where the old formula averaged every v row."""
    q, k, v = _decode_inputs(B, H, KV, hd, S, seed=S + window)
    cl = torch.tensor(cache_len, dtype=torch.int32)
    want = _unsharded_plain(q, k, v, cl, window)
    assert torch.equal(ops.decode_attn(q, k, v, cl, window=window), want)
    out, lse = ops.decode_attn(q, k, v, cl, window=window, offset=0, return_lse=True)
    assert torch.equal(out, want) and bool(torch.isfinite(lse).all())
    for empty in (0, -2):
        got = ops.decode_attn(q, k, v, torch.tensor(empty, dtype=torch.int32), window=window)
        assert torch.equal(got, torch.zeros_like(got))


# ------------------------------------------------- K4's plan and arithmetic

# every family's K4 shape at LM_BATCH = 8 (chip_smoke.py): q (B, H, hd),
# k/v (B, S, KV, hd); whisper's decoder cache is 128 slots, recurrentgemma's
# ring 2048, the others' 2112 (2048 prompt + 64 steps)
_H100_SMS, _LM_BATCH = 132, 8


def _family_shapes():
    from repro_torch.configs.registry import get_config, list_archs

    shapes = []
    for arch in list_archs():
        cfg = get_config(arch)
        S = 128 if cfg.family == "encdec" else 2048 if cfg.family == "hybrid" else 2112
        shapes.append((arch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, S))
    return shapes


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_decode_plan_at_every_arch(elem_bytes):
    """K4's launch plan at each arch's full width: within the shared memory
    a block may take, ceil(G / 16) row tiles, at least one block an SM
    wherever B x KV, S and the merge's room allow it, and one split at
    whisper's short cache."""
    for arch, H, KV, hd, S in _family_shapes():
        plan = ops.decode_plan(_LM_BATCH, S, H, KV, hd, elem_bytes, _H100_SMS)
        G = H // KV
        assert plan.smem_bytes <= ops.DECODE_SMEM_OPTIN, arch
        assert plan.row_tiles == -(-G // 16) and plan.rt * plan.row_groups >= plan.row_tiles, arch
        assert 3 <= plan.stages <= 8 and plan.threads == 32 * (plan.tile // 16 + 1), arch
        assert plan.blocks == plan.splits * _LM_BATCH * KV * plan.row_groups, arch
        most = max(ops.decode_plan(_LM_BATCH, S, H, KV, hd, elem_bytes, 10 ** 6).splits, 1)
        assert plan.blocks >= _H100_SMS or plan.splits == most, (arch, plan)
        assert plan.blocks_per_sm >= 1 and 1 <= plan.splits <= 64, arch
        if arch == "whisper-large-v3":
            assert plan.splits == 1, plan
    # the bf16 plans the decode paths run (PERF.md): two 110 KB blocks an SM
    want = {"gemma3-4b": (8, 3, 256), "qwen2-vl-72b": (4, 3, 256), "mixtral-8x7b": (4, 3, 256),
            "recurrentgemma-2b": (8, 3, 64), "whisper-large-v3": (1, 6, 160)}
    if elem_bytes == 2:
        for arch, H, KV, hd, S in _family_shapes():
            if arch in want:
                plan = ops.decode_plan(_LM_BATCH, S, H, KV, hd, 2, _H100_SMS)
                assert (plan.splits, plan.stages, plan.blocks) == want[arch], (arch, plan)
                assert plan.blocks_per_sm == 2, (arch, plan)


def test_decode_plan_groups_wider_than_the_accumulators():
    """Row tiles past what a block's accumulators hold (two at hd <= 128,
    one at hd 256) go to more blocks of the same kv head; hd outside
    32/64/128/256 is refused."""
    plan = ops.decode_plan(2, 300, 48, 2, 128, 2, _H100_SMS)  # G = 24: two tiles, one block
    assert (plan.row_tiles, plan.rt, plan.row_groups) == (2, 2, 1)
    plan = ops.decode_plan(1, 4000, 64, 1, 64, 2, _H100_SMS)  # G = 64: four tiles, two blocks
    assert (plan.row_tiles, plan.rt, plan.row_groups) == (4, 2, 2)
    plan = ops.decode_plan(1, 4000, 32, 1, 256, 2, _H100_SMS)  # hd 256: one tile a block
    assert (plan.row_tiles, plan.rt, plan.row_groups) == (2, 1, 2)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_plan(1, 64, 8, 2, 96, 2, _H100_SMS)


def _k4_emulation(q, k, v, cache_len, window):
    """K4's arithmetic in plain torch, as csrc/decode_attn.cu orders it:
    the live range cut into `decode_plan`'s splits (a multiple of 16
    positions each); in each split, consumer warp w takes positions
    [16 w, 16 w + 16) of every stage of ``tile`` positions and keeps its
    own online softmax, one step per 16 positions: exact bf16 products
    summed in f32, logits / sqrt(hd), P split into bf16 hi + lo for P V; the
    warps merge, then the splits (the last block's merge), each weighted by
    exp(m - max m), and the result is acc / max(l, 1e-30) in the inputs'
    dtype."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    plan = ops.decode_plan(B, S, H, KV, hd, q.element_size(), _H100_SMS)
    hi = min(cache_len, S)
    lo = max(hi - window, 0) if window > 0 else 0
    live = max(hi - lo, 0)
    chunk = -(-(-(-live // plan.splits)) // 16) * 16
    qf = q.float().reshape(B, KV, G, hd)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # (B, KV, S, hd)
    sqrt_hd = torch.sqrt(torch.tensor(float(hd)))
    neg = torch.tensor(float("-inf"))

    def merge(parts):
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        acc, L = torch.zeros_like(parts[0][2]), torch.zeros_like(parts[0][1])
        for m, l, a in parts:
            wt = torch.where(m == neg, 0.0, torch.exp(m - M))
            acc, L = acc + wt[..., None] * a, L + wt * l
        return M, L, acc

    splits = []
    for split in range(plan.splits):
        s0 = lo + split * chunk
        s1 = min(s0 + chunk, hi)
        warps = []
        for w in range(plan.tile // 16):
            m = torch.full((B, KV, G), float("-inf"))
            l, acc = torch.zeros((B, KV, G)), torch.zeros((B, KV, G, hd))
            for t0 in range(s0, s1, plan.tile):
                p0 = t0 + 16 * w
                if p0 >= s1:
                    continue
                n = min(16, s1 - p0)
                x = torch.einsum("bkgh,bksh->bkgs", qf, kf[:, :, p0:p0 + n]) / sqrt_hd
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(x - m_new[..., None])
                l = l * alpha + p.sum(-1)
                p_hi = p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16 else p
                p_lo = (p - p_hi).to(torch.bfloat16).float()
                pv = torch.einsum("bkgs,bksh->bkgh", p_hi, vf[:, :, p0:p0 + n])
                if q.dtype == torch.bfloat16:
                    pv = pv + torch.einsum("bkgs,bksh->bkgh", p_lo, vf[:, :, p0:p0 + n])
                acc = acc * alpha[..., None] + pv
                m = m_new
            warps.append((m, l, acc))
        splits.append(merge(warps))
    _, L, acc = merge(splits)
    return (acc / torch.clamp(L, min=1e-30)[..., None]).reshape(B, H, hd).to(q.dtype)


# (B, H, KV, hd) of each family's decode, at a reduced S = 640
_FAMILY_K4 = {"gemma3-4b": (8, 8, 4, 256), "mixtral-8x7b": (8, 32, 8, 128),
              "qwen2-vl-72b": (8, 64, 8, 128), "recurrentgemma-2b": (8, 10, 1, 256),
              "whisper-large-v3": (8, 20, 20, 64)}


@pytest.mark.parametrize("cache_len,window", [(640, 0), (1, 0), (513, 200), (700, 0)])
@pytest.mark.parametrize("family", list(_FAMILY_K4))
def test_k4_arithmetic_emulation_matches_reference(ref_ops, family, cache_len, window):
    """The bf16 hi + lo split of P, the 16-position online softmax steps and
    the warp and split merges, emulated on the CPU, against the Pallas
    kernel (interpret mode) at the bf16 tolerance the card holds K4 to
    (chip_smoke.py's DECODE_TOL: rtol 2**-7, atol 1e-4). 700 > S: clamped."""
    import jax.numpy as jnp

    B, H, KV, hd = _FAMILY_K4[family]
    S = 640
    q, k, v = _decode_inputs(B, H, KV, hd, S, seed=hd + H, dtype=torch.bfloat16)
    got = _k4_emulation(q, k, v, cache_len, window)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    want = ref_ops.decode_attn(jq, jk, jv, jnp.asarray(cache_len, jnp.int32), window=window)
    assert got.shape == (B, H, hd) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-4)


def test_k4_emulation_splits_as_the_plan_says():
    """The emulation runs the plan's splits: gemma3-4b's shape at S = 640
    takes several, whisper's at its 128-slot cache one; with several splits
    the merge matches the one-split plain version in f32 (P not split)
    within f32 rounding."""
    assert ops.decode_plan(8, 640, 8, 4, 256, 2, _H100_SMS).splits > 1
    assert ops.decode_plan(8, 128, 20, 20, 64, 2, _H100_SMS).splits == 1
    q, k, v = _decode_inputs(8, 8, 4, 256, 640, seed=3)
    got = _k4_emulation(q, k, v, 600, 0)
    want = ref.decode_attn_ref(q, k, v, torch.tensor(600), window=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- CPU dispatch


def test_cpu_tensors_take_the_plain_version():
    ops.reset_launches()
    layers = _torch_layers(_layers(1))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 72, 50)).astype(np.float32))
    wb = [(lp["w"], lp["b"]) for lp in layers]
    assert torch.equal(ops.cnn_trunk(layers, x), ref.cnn_trunk_ref(wb, x))
    state, cur = _port_state(3, 16, _step_inputs(3, 20, seed=3))
    assert torch.equal(ops.fused_step(layers, state, cur["feat"], cur["addr"], seq_padded=24),
                       ref.fused_step_ref(wb, state, cur["feat"], cur["addr"], seq_padded=24))
    assert torch.equal(ops.conv2s(layers[0], x), ref.conv2s_ref(x, *wb[0]))
    q, k, v = _decode_inputs(2, 4, 2, 32, 40, seed=8)
    assert torch.equal(ops.decode_attn(q, k, v, torch.tensor(30, dtype=torch.int32), window=16),
                       ref.decode_attn_ref(q, k, v, torch.tensor(30), window=16))
    g = torch.Generator().manual_seed(4)
    wkv_in = [torch.randn(2, 5, 2, 32, generator=g) for _ in range(4)]
    wkv_in += [torch.randn(2, 32, generator=g), torch.randn(2, 2, 32, 32, generator=g)]
    for got, want in zip(ops.wkv(*wkv_in), ref.wkv_ref(*wkv_in)):
        assert torch.equal(got, want)
    assert ops.launches == {"fused_step": 0, "cnn_trunk": 0, "conv2s": 0, "decode_attn": 0,
                            "wkv_fwd": 0, "wkv_bwd": 0}


def test_fused_step_ref_is_the_plain_composition():
    """recency_view -> build_model_input -> pad -> trunk, spelled out."""
    state, cur = _port_state(6, 8, _step_inputs(6, 30, seed=4))
    layers = _torch_layers(_layers(5))
    x = port_sim.model_input(state, cur["feat"], cur["addr"], port_sim.SimConfig(ctx_len=8))
    x = torch.nn.functional.pad(x, (0, 0, 0, 16 - x.shape[1]))
    for lp in layers:
        B, N, C = x.shape
        x = torch.relu(x.reshape(B, N // 2, 2 * C) @ lp["w"] + lp["b"])
    got = ref.fused_step_ref([(lp["w"], lp["b"]) for lp in layers], state, cur["feat"],
                             cur["addr"], seq_padded=16)
    np.testing.assert_allclose(got.numpy(), x.numpy(), rtol=1e-6, atol=1e-6)


def test_trunk_kernels_need_the_c3_depth():
    layers = _torch_layers(_layers(6))
    x = torch.zeros((2, 72, 50))
    with pytest.raises(ValueError, match="C3 depth"):
        ops.cnn_trunk(layers[:1], x)
    state, cur = _port_state(2, 8, _step_inputs(2, 3, seed=6))
    with pytest.raises(ValueError, match="C3 depth"):
        ops.fused_step(layers[:2], state, cur["feat"], cur["addr"], seq_padded=16)


def test_trunk_kernels_take_the_c3_widths():
    """K1/K2 are compiled for the C3 widths: on the card the wrappers refuse
    other widths before launching, while the plain version takes any."""
    def wb(chans):
        return [(lp["w"], lp["b"]) for lp in _torch_layers(_layers(8, chans))]

    assert ops._check_trunk_shapes(wb(CHANS), 50, 72) == ops.TRUNK_WIDTHS == (64, 128, 128)
    with pytest.raises(ValueError, match="C3 widths"):
        ops._check_trunk_shapes(wb([50, 32, 64, 64]), 50, 72)
    with pytest.raises(ValueError, match="seq % 8"):
        ops._check_trunk_shapes(wb(CHANS), 50, 68)
    x = torch.zeros((2, 72, 50))
    assert ops.cnn_trunk(_torch_layers(_layers(8, [50, 32, 64, 64])), x).shape == (2, 9, 64)


def test_conv2s_kernel_width_limit():
    """K3 holds, in the 232,448 bytes of shared memory a block may take, W
    (Co padded to 64/128/256) or, where Co % 4 == 0, a 32 KB ring of it,
    beside one input row for each of its 8/4/2 warp groups: C <= 3108 at
    Co = 64, C <= 402 at Co = 30; Co is at most 256. The wrappers check
    this before launching; N (the sequence) and B are not limited."""
    for c, co in ((3108, 64), (6208, 128), (12384, 256), (402, 30), (218, 126), (110, 130),
                  (50, 64), (2, 2)):
        ops._check_conv2s_widths(c, co)
    for c, co, what in ((3110, 64, "ring"), (6210, 128, "ring"), (12386, 256, "ring"),
                        (404, 30, "W"), (220, 126, "W"), (112, 130, "W"), (50, 258, "Co <= 256")):
        with pytest.raises(ValueError, match=what):
            ops._check_conv2s_widths(c, co)


def test_wrappers_reject_tensors_on_other_devices():
    layers = _torch_layers(_layers(7), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.cnn_trunk(layers, torch.zeros((2, 72, 50), device="meta"))
    assert ops.launches["cnn_trunk"] == 0


# ------------------------------------------------------ the kernels, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assembled_input(state, cur, seq_padded):
    """The (L, seq_padded, 50) input that K1 assembles on chip, built by the
    plain code: planes in f32, recency view, model input, zero rows."""
    f32 = state._replace(feat=state.feat.float(), resid=state.resid.float(),
                         exec_lat=state.exec_lat.float(), store_lat=state.store_lat.float())
    x = port_sim.build_model_input(port_sim.recency_view(f32), cur["feat"].float(), cur["addr"])
    return torch.nn.functional.pad(x, (0, 0, 0, seq_padded - x.shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1024, 72), (7, 72), (5, 24),  # full, ragged lanes, short seq
                                 (1, 72), (1000, 72)])  # fewer units than SMs; 9000 units
def test_cnn_trunk_kernel_matches_plain(cuda, B, N):
    layers = _torch_layers(_layers(B + N), device=cuda)
    x = torch.from_numpy(np.random.default_rng(B).standard_normal((B, N, 50)).astype(np.float32)).to(cuda)
    before = ops.launches["cnn_trunk"]
    got = ops.cnn_trunk(layers, x)
    torch.cuda.synchronize()
    assert ops.launches["cnn_trunk"] == before + 1
    want = ref.cnn_trunk_ref([(lp["w"], lp["b"]) for lp in layers], x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("L,ctx,state_dtype", [(1024, 64, "float32"), (7, 64, "float32"),
                                               (9, 16, "float32"), (6, 16, "bfloat16"),
                                               (1, 64, "float32"), (1000, 64, "float32")])
def test_fused_step_kernel_matches_plain(cuda, L, ctx, state_dtype):
    layers = _torch_layers(_layers(L + ctx), device=cuda)
    seq_padded = ((ctx + 1 + 7) // 8) * 8
    state, cur = _port_state(L, ctx, _step_inputs(L, 2 * ctx + 5, seed=L), cuda, state_dtype)
    before = ops.launches["fused_step"]
    got = ops.fused_step(layers, state, cur["feat"], cur["addr"], seq_padded=seq_padded)
    torch.cuda.synchronize()
    assert ops.launches["fused_step"] == before + 1
    want = ref.fused_step_ref([(lp["w"], lp["b"]) for lp in layers], state, cur["feat"],
                              cur["addr"], seq_padded=seq_padded)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("L,ctx,n_steps,state_dtype", [
    (1024, 64, 133, "float32"),  # the main path's shape; head 5: unit 0 wraps at row 6
    (1000, 64, 67, "float32"),   # 9000 units, not a whole number of tiles; head 3
    (7, 64, 64, "float32"),      # head 0: no unit wraps
    (1, 64, 70, "float32"),      # one lane: 9 units, fewer than the SMs
    (9, 16, 37, "float32"),      # short sequence (seq_padded 24), head 5
    (6, 16, 40, "bfloat16"),     # bf16 state planes, head 8
])
def test_fused_step_kernel_equals_cnn_trunk_bit_for_bit(cuda, L, ctx, n_steps, state_dtype):
    """K1 on a ring state and K2 on the input it assembles keep each output's
    sum in one thread (0, then k ascending with fmaf, then the bias, then
    ReLU), so they give the same bits whatever order a library would use."""
    layers = _torch_layers(_layers(L + 3), device=cuda)
    seq_padded = ((ctx + 1 + 7) // 8) * 8
    state, cur = _port_state(L, ctx, _step_inputs(L, n_steps, seed=L + 1), cuda, state_dtype)
    assert int(state.head) == n_steps % ctx
    got = ops.fused_step(layers, state, cur["feat"], cur["addr"], seq_padded=seq_padded)
    want = ops.cnn_trunk(layers, _assembled_input(state, cur, seq_padded))
    torch.cuda.synchronize()
    assert got.shape == (L, seq_padded // 8, 128) and torch.equal(got, want)


@pytest.mark.cuda
def test_trunk_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """K1 copies each lane's planes in 16-byte units (ctx_len % 4 == 0);
    both are compiled for the C3 widths. The wrappers raise before any
    launch."""
    layers = _torch_layers(_layers(13), device=cuda)
    state, cur = _port_state(3, 6, _step_inputs(3, 9, seed=13), cuda)
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.fused_step(layers, state, cur["feat"], cur["addr"], seq_padded=8)
    narrow = _torch_layers(_layers(13, [50, 32, 64, 64]), device=cuda)
    with pytest.raises(ValueError, match="C3 widths"):
        ops.cnn_trunk(narrow, torch.zeros((2, 72, 50), device=cuda))
    assert ops.launches == before


@pytest.mark.cuda
def test_cnn_trunk_kernel_takes_a_bf16_state(cuda):
    """The engine's bf16-state path: the model input of a bf16 ring state
    goes to K2, whose wrapper casts it to f32 (as the reference's does)."""
    L, ctx = 70, 64
    layers = _torch_layers(_layers(11), device=cuda)
    state, cur = _port_state(L, ctx, _step_inputs(L, 90, seed=12), cuda, "bfloat16")
    x = port_sim.model_input(state, cur["feat"], cur["addr"], port_sim.SimConfig(ctx_len=ctx))
    x = torch.nn.functional.pad(x, (0, 0, 0, 72 - x.shape[1]))
    assert x.dtype == torch.bfloat16
    got = ops.cnn_trunk(layers, x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, ops.cnn_trunk(layers, x.float()))
    torch.testing.assert_close(got, ref.cnn_trunk_ref([(lp["w"], lp["b"]) for lp in layers], x.float()),
                               rtol=1e-4, atol=1e-4)


def _conv2s_inputs(B, N, C, Co, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(device)
    p = {"w": torch.from_numpy((rng.standard_normal((2 * C, Co)) * 0.1).astype(np.float32)).to(device),
         "b": torch.from_numpy((rng.standard_normal(Co) * 0.1).astype(np.float32)).to(device)}
    return x, p


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,Co", [
    (1024, 72, 50, 64), (7, 72, 50, 64),      # the three C3 layers at L = 1024 and 7
    (1024, 36, 64, 128), (7, 36, 64, 128),
    (1024, 18, 128, 128), (7, 18, 128, 128),
    (5, 8, 16, 30), (3, 24, 64, 128),         # W padded to 64 columns; few rows
    (2, 1024, 64, 64),                        # a lane of 256 KB: past one block's shared memory
    (10240, 72, 50, 64),                      # 10 tiles a warp: its 2 slots are reused
    (4, 6, 100, 200), (3, 8, 60, 130),        # Co padded to 256: W by row copies; W loaded
    (3, 10, 444, 64), (2, 6, 300, 200),       # W streamed through its ring; by row copies
    (4096, 18, 200, 128),                     # W streamed, 3 rounds of tiles a block
])
def test_conv2s_kernel_matches_plain(cuda, B, N, C, Co):
    """f32 on both sides (TF32 off), sums in another order: rtol=atol=2e-5."""
    x, p = _conv2s_inputs(B, N, C, Co, B + Co, cuda)
    before = ops.launches["conv2s"]
    got = ops.conv2s(p, x)
    torch.cuda.synchronize()
    assert ops.launches["conv2s"] == before + 1
    torch.testing.assert_close(got, ref.conv2s_ref(x, p["w"], p["b"]), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1024, 128])
def test_conv2s_chain_equals_cnn_trunk_bit_for_bit(cuda, L):
    """K3 over the three C3 layers and K2 keep each output's sum in one
    thread (0, k ascending with fmaf, bias, ReLU): the same bits."""
    layers = _torch_layers(_layers(L + 1), device=cuda)
    x = torch.from_numpy(np.random.default_rng(L).standard_normal((L, 72, 50)).astype(np.float32)).to(cuda)
    h = x
    for lp in layers:
        h = ops.conv2s(lp, h)
    want = ops.cnn_trunk(layers, x)
    torch.cuda.synchronize()
    assert h.shape == (L, 9, 128) and torch.equal(h, want)


@pytest.mark.cuda
def test_conv2s_kernel_refuses_widths_past_its_limit(cuda):
    """W past shared memory, or Co > 256, raise ValueError before any launch."""
    before = ops.launches["conv2s"]
    for C, Co in ((3110, 64), (404, 30), (50, 258)):
        x, p = _conv2s_inputs(2, 4, C, Co, C, cuda)
        with pytest.raises(ValueError, match="conv2s kernel"):
            ops.conv2s(p, x)
    assert ops.launches["conv2s"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,KV,hd,S,window,cache_lens", [
    (8, 8, 4, 256, 2112, 1024, (1, 1500, 2112)),  # gemma3-4b's decode, local layers
    (8, 8, 4, 256, 2112, 0, (1, 1500, 2112)),     # ... and global layers
    (2, 4, 2, 32, 48, 32, (1, 33, 48, 60)),       # reduced configs; 60 > S is clamped
    (3, 32, 4, 64, 500, 0, (7, 500)),             # tinyllama's group of 8
    (2, 32, 8, 128, 300, 100, (299,)),            # qwen3's head_dim
    (3, 10, 1, 64, 256, 0, (200,)),               # a group of 10: head tiles of 2
    (8, 10, 1, 256, 2048, 0, (1, 1500, 2048)),    # recurrentgemma-2b's MQA ring, full width
    (8, 20, 20, 64, 128, 0, (1, 65, 128)),        # whisper-large-v3's decoder self-attention
    (8, 32, 8, 128, 2112, 0, (2049, 2112)),       # mixtral-8x7b's ring (window 0)
    (8, 64, 8, 128, 2112, 0, (2049, 2112)),       # qwen2-vl-72b
    (2, 16, 2, 32, 300, 0, (1, 200, 300)),        # hd 32 with a group of 8
    (2, 32, 2, 128, 700, 0, (1, 640, 700)),       # a group of 16: one full row tile
    (2, 48, 2, 128, 700, 0, (1, 640, 700)),       # a group of 24: two row tiles in a block
    (1, 64, 1, 64, 900, 0, (1, 900)),             # a group of 64: two blocks a kv head
    (1, 8, 2, 64, 500, 64, (1, 64, 65, 500)),     # B = 1; a window of exactly one stage
])
def test_decode_attn_kernel_matches_plain(cuda, dtype, B, H, KV, hd, S, window, cache_lens):
    """Both sides compute in f32 from the same inputs (the kernel's bf16 P is
    split into hi + lo, within 2**-16 of P), so they differ only in
    summation order. f32 at rtol=atol=1e-5. In bf16 the outputs are
    rounded to bf16 (8 significant bits), and a sum order can move a value
    across a rounding boundary: one bf16 step, at most 2**-7 of the value,
    hence rtol=2**-7 with atol=1e-4 for values near zero."""
    dt = getattr(torch, dtype)
    q, k, v = _decode_inputs(B, H, KV, hd, S, seed=S + hd, dtype=dt, device=cuda)
    rtol, atol = (2 ** -7, 1e-4) if dtype == "bfloat16" else (1e-5, 1e-5)
    for cache_len in cache_lens:
        cl = torch.tensor(cache_len, dtype=torch.int32, device=cuda)
        before = ops.launches["decode_attn"]
        got = ops.decode_attn(q, k, v, cl, window=window)
        torch.cuda.synchronize()
        assert ops.launches["decode_attn"] == before + 1 and got.dtype == dt
        want = ref.decode_attn_ref(q, k, v, torch.clamp(cl, max=S), window=window).to(dt)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=f"cache_len {cache_len}")


@pytest.mark.cuda
def test_decode_attn_is_one_device_kernel_a_call(cuda):
    """A call with several splits (qwen2-vl-72b's shape) runs one device
    kernel, the merge included, and counts one launch."""
    from torch.profiler import ProfilerActivity, profile

    B, H, KV, hd, S = 8, 64, 8, 128, 2112
    q, k, v = _decode_inputs(B, H, KV, hd, S, seed=9, dtype=torch.bfloat16, device=cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert ops.decode_plan(B, S, H, KV, hd, 2, props.multi_processor_count).splits > 1
    cl = torch.tensor(2049, dtype=torch.int32, device=cuda)
    ops.decode_attn(q, k, v, cl)
    torch.cuda.synchronize()
    before = ops.launches["decode_attn"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.decode_attn(q, k, v, cl)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "decode_attn" in e.name]
    assert ops.launches["decode_attn"] == before + 3
    assert len(kernels) == 3 and all("decode_attn_kernel" in e.name for e in kernels), \
        [e.name for e in kernels]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,hd,S", [(8, 64, 8, 128, 2112),   # several splits: the merge
                                         (2, 4, 2, 64, 100)])      # one split
def test_decode_attn_kernel_without_live_positions_gives_zeros(cuda, B, H, KV, hd, S):
    """A cache_len of 0 or below leaves no live position: the kernel writes
    zeros, as its wrapper states."""
    q, k, v = _decode_inputs(B, H, KV, hd, S, seed=4, dtype=torch.bfloat16, device=cuda)
    for cache_len in (0, -3):
        got = ops.decode_attn(q, k, v, torch.tensor(cache_len, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, torch.zeros_like(got)), cache_len


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,KV,hd,S,window,cache_len,bounds", _SHARD_CASES)
def test_decode_attn_kernel_shard_mode_matches_plain(cuda, dtype, B, H, KV, hd, S, window,
                                                     cache_len, bounds):
    """K4 at each shard's offset, returning (out, lse) in f32, against its
    plain version (f32: 1e-5, sums in another order; bf16: 1e-4, P also
    split into bf16 hi + lo, an error under 2**-16 of P times |v|), an
    empty shard's 0 and -inf exactly, and the shards merged against the
    unsharded K4 (the merge in f32; the bf16 rounding of the unsharded
    output)."""
    from repro_torch.nn.attention import merge_rows

    dt = getattr(torch, dtype)
    q, k, v = _decode_inputs(B, H, KV, hd, S, seed=S + window, dtype=dt, device=cuda)
    cl = torch.tensor(cache_len, dtype=torch.int32, device=cuda)
    outs, lses = [], []
    for lo, ks, vs in _shards(k, v, bounds):
        ks, vs = ks.contiguous(), vs.contiguous()
        before = ops.launches["decode_attn"]
        out, lse = ops.decode_attn(q, ks, vs, cl, window=window, offset=lo, return_lse=True)
        torch.cuda.synchronize()
        assert ops.launches["decode_attn"] == before + 1 and out.dtype == torch.float32
        w_out, w_lse = ref.decode_attn_ref(q, ks, vs, cl, window=window, offset=lo,
                                           return_lse=True)
        tol = 1e-4 if dtype == "bfloat16" else 1e-5
        torch.testing.assert_close(out, w_out, rtol=tol, atol=tol)
        torch.testing.assert_close(lse, w_lse, rtol=tol, atol=tol)
        live = min(cache_len, lo + ks.shape[1]) - max(cache_len - window if window else 0, lo)
        if live <= 0:
            assert bool((out == 0).all()) and bool(torch.isneginf(lse).all())
        outs.append(out)
        lses.append(lse)
    merged = merge_rows(torch.stack(outs), torch.stack(lses)).to(dt)
    whole = ops.decode_attn(q, k, v, cl, window=window)
    rtol, atol = (2 ** -7, 1e-4) if dtype == "bfloat16" else (1e-5, 1e-5)
    torch.testing.assert_close(merged.float(), whole.float(), rtol=rtol, atol=atol)
