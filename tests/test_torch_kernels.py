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
    assert ops.launches == {"fused_step": 0, "cnn_trunk": 0}


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1024, 72), (7, 72), (5, 24)])  # full, ragged lanes, short seq
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
                                               (9, 16, "float32"), (6, 16, "bfloat16")])
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
