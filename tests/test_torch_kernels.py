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
    assert ops.launches == {"fused_step": 0, "cnn_trunk": 0, "conv2s": 0, "decode_attn": 0}


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
])
def test_decode_attn_kernel_matches_plain(cuda, dtype, B, H, KV, hd, S, window, cache_lens):
    """Both sides compute in f32 from the same inputs, so they differ only
    in summation order. f32 at rtol=atol=1e-5. In bf16 the outputs are
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
