"""rwkv6's wkv recurrence as one op (`repro_torch.kernels.ops.wkv`).

On CPU tensors the op runs the plain loop (`kernels.ref.wkv_ref`) and its
gradient is the loop's own autograd; both are held against the
reference's ``jax.lax.scan`` of the same step, forward and ``jax.grad``
in r, k, v, w, u and S0, f32, within 1e-5 of each output's largest
value (the sums run in another order). Through the reference's whole
``rwkv_timemix`` too. On fake tensors the op is one dispatch whatever T
is, and its ``"wkv"`` region counts the FLOPs the plain loop counts. The
CUDA kernels are held against the plain loop on the card (marked
``cuda``; they skip without a GPU). JAX is imported only by the tests that
compare with the reference, so the ``cuda`` test runs where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.kernels import _build, breakdown, ops, ref  # noqa: E402
from repro_torch.nn import ssm  # noqa: E402
from repro_torch.runtime.opcount import analyze  # noqa: E402

B, H, HD = 2, 2, 32
TOL = 1e-5  # of each output's largest |value|: f32 sums in another order than XLA's


def _inputs(T, hd=HD, seed=0, b=B, h=H):
    """r, k, v, w (b, T, h, hd), u (h, hd), a nonzero S0 (b, h, hd, hd) and
    the cotangents of y and the last state, as numpy f32."""
    rng = np.random.default_rng(seed + T)
    seq = (b, T, h, hd)
    arrays = [rng.standard_normal(seq) for _ in range(3)]
    arrays.append(np.exp(-np.exp(rng.normal(-1.0, 1.0, seq))))  # decays in (0, 1)
    arrays += [rng.normal(0.0, 0.5, (h, hd)), rng.standard_normal((b, h, hd, hd)),
               rng.standard_normal(seq), rng.standard_normal((b, h, hd, hd))]
    return [a.astype(np.float32) for a in arrays]


def _reference_scan(r, k, v, w, u, s0):
    """The reference's wkv ``lax.scan`` (src/repro/nn/ssm.py, rwkv_timemix's
    step over the inputs moved to time-major)."""
    import jax
    import jax.numpy as jnp

    def step(S, inputs):
        r_t, k_t, v_t, w_t = inputs
        kv = jnp.einsum("bhi,bhj->bhij", k_t, v_t)
        y_t = jnp.einsum("bhi,bhij->bhj", r_t, S + u[None, :, :, None] * kv)
        return w_t[..., None] * S + kv, y_t

    state, ys = jax.lax.scan(step, s0, tuple(jnp.moveaxis(t, 1, 0) for t in (r, k, v, w)))
    return jnp.moveaxis(ys, 0, 1), state


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max |diff| {err:.3e} > {TOL} x max |want| {scale:.3e}"


@pytest.mark.parametrize("T", [1, 17, 64])
def test_the_op_equals_the_references_scan_and_its_gradient(T):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    *ins, gy, gs = _inputs(T)
    jins = [jnp.asarray(a) for a in ins]
    want_y, want_s = jax.jit(_reference_scan)(*jins)

    def loss(*a):
        y, s = _reference_scan(*a)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want_g = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*jins)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, s = ops.wkv(*leaves)
    got_g = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum(),
                                leaves)
    _close(y.detach().numpy(), np.asarray(want_y), f"y at T={T}")
    _close(s.detach().numpy(), np.asarray(want_s), f"last state at T={T}")
    for name, g, wg in zip(("r", "k", "v", "w", "u", "S0"), got_g, want_g):
        _close(g.numpy(), np.asarray(wg), f"d loss / d {name} at T={T}")


@pytest.mark.parametrize("T", [1, 17, 64])
def test_timemix_through_the_op_equals_the_reference(T):
    """The port's ``rwkv_timemix`` (its scan now the op) against the
    reference's, hd 32: output, last state and the gradients of a seeded
    weighting of both in x, x_last, the state and every param."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.nn import ssm as ref_ssm

    g = torch.Generator().manual_seed(T)
    p = ssm.rwkv_timemix_params(g, H * HD, H)
    p["u"] = p["u"] + 0.3
    p["w0"] = p["w0"] + 5.0  # decays away from 1
    rng = np.random.default_rng(T)
    x, x_last = (rng.standard_normal(sh).astype(np.float32) for sh in ((B, T, H * HD), (B, H * HD)))
    s0 = rng.standard_normal((B, H, HD, HD)).astype(np.float32)
    cy, cs = (rng.standard_normal(sh).astype(np.float32) for sh in ((B, T, H * HD), (B, H, HD, HD)))

    def ref_loss(jp, x, xl, s):
        y, _, last = ref_ssm.rwkv_timemix(jp, x, xl, s, n_heads=H, dtype=jnp.float32)
        return jnp.sum(y * cy) + jnp.sum(last * cs)

    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    args = (jp, jnp.asarray(x), jnp.asarray(x_last), jnp.asarray(s0))
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2, 3)))(*args)
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), p)
    tx, txl, ts = (torch.from_numpy(a).requires_grad_(True) for a in (x, x_last, s0))
    y, _, last = ssm.rwkv_timemix(tp, tx, txl, ts, n_heads=H, dtype=torch.float32)
    wy, _, wlast = ref_ssm.rwkv_timemix(*args, n_heads=H, dtype=jnp.float32)
    _close(y.detach().numpy(), np.asarray(wy), "timemix")
    _close(last.detach().numpy(), np.asarray(wlast), "last state")
    leaves = jax.tree_util.tree_leaves(tp)
    got = torch.autograd.grad((y * torch.from_numpy(cy)).sum() + (last * torch.from_numpy(cs)).sum(),
                              leaves + [tx, txl, ts])
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(tp)[0]]
    for name, gt, wt in zip(names + ["x", "x_last", "state"], got,
                            jax.tree_util.tree_leaves(want[0]) + list(want[1:])):
        # the params' gradients sum over B and T: 1e-4, as the families' test
        scale, err = float(np.abs(wt).max()), float(np.abs(gt.numpy() - np.asarray(wt)).max())
        assert err <= 1e-4 * max(scale, 1e-6), f"d loss / d {name}: {err:.3e} of {scale:.3e}"


def test_the_cpu_gradient_is_the_plain_loops_own():
    """On CPU tensors the op's forward is the loop's, and its gradient the
    loop's autograd, bit for bit."""
    *ins, gy, gs = _inputs(9)
    a = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    b = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    outs_a, outs_b = ops.wkv(*a), ref.wkv_ref(*b)
    cot = (torch.from_numpy(gy), torch.from_numpy(gs))
    for x, z in zip(outs_a, outs_b):
        assert torch.equal(x, z)
    for x, z in zip(torch.autograd.grad(outs_a, a, cot), torch.autograd.grad(outs_b, b, cot)):
        assert torch.equal(x, z)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace != "prim":  # metadata (``.device``)
            self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("T", [16, 4096])
def test_fake_tensors_trace_one_op_whatever_T(T):
    """Under FakeTensorMode the forward dispatches ``repro_torch.wkv`` alone
    and the backward ``repro_torch.wkv_bwd``, once each at any T."""
    mode = FakeTensorMode()
    with mode:
        ins = [torch.empty(B, T, H, 64, requires_grad=True) for _ in range(4)]
        ins += [torch.empty(H, 64, requires_grad=True), torch.empty(B, H, 64, 64, requires_grad=True)]
        with _Ops() as fwd:
            y, s = ops.wkv(*ins)
        gy, gs = torch.empty_like(y), torch.empty_like(s)
        with _Ops() as bwd:
            torch.autograd.grad((y, s), ins, (gy, gs))
    assert fwd.names == ["repro_torch.wkv.default"]
    assert bwd.names == ["repro_torch.wkv_bwd.default"]
    assert y.shape == (B, T, H, 64) and s.shape == (B, H, 64, 64)


def test_the_region_counts_the_plain_loops_flops():
    """`runtime.opcount`: the op's ``"wkv"`` regions (forward, backward)
    count the FLOPs the plain loop's ops count, forward alone and with the
    backward, on real and on fake tensors."""
    T = 12

    def run(fn, backward):
        def call(*a):
            y, s = fn(*a)
            if backward:
                torch.autograd.grad(y.sum() + s.sum(), a)
        return call

    *ins, _, _ = _inputs(T, hd=8)
    for backward in (False, True):
        real = [torch.from_numpy(a).requires_grad_(backward) for a in ins]
        plain = analyze(run(ref.wkv_ref, backward), *real)
        region = analyze(run(ops.wkv, backward), *real)
        mode = FakeTensorMode()
        with mode:
            fake = [torch.empty(a.shape, requires_grad=backward) for a in ins]
            faked = analyze(run(ops.wkv, backward), *fake, fake_mode=mode)
        assert plain["flops"] == region["flops"] == faked["flops"] > 0
        assert region["regions"] == faked["regions"] == {"wkv": 2 if backward else 1}
        assert "wkv" not in plain["regions"]


def test_the_wrapper_raises_on_what_the_kernels_do_not_take():
    *ins, _, _ = _inputs(4)
    t = [torch.from_numpy(a) for a in ins]
    with pytest.raises(ValueError, match="f32 contiguous"):
        ops.wkv(t[0].double(), *t[1:])
    with pytest.raises(ValueError, match="not contiguous"):
        ops.wkv(t[0].transpose(0, 1).contiguous().transpose(0, 1), *t[1:])
    with pytest.raises(ValueError, match="f32 contiguous"):
        ops.wkv(*t[:4], t[4][:1], t[5])
    assert ops.wkv_checkpoints_shape(4, 1024, 32, 64) == (4, 32, 64, 64, 64)
    assert 4 * np.prod(ops.wkv_checkpoints_shape(4, 1024, 32, 64)) == 134_217_728


@pytest.mark.parametrize("variant", sorted(breakdown.VARIANTS["wkv.cu"][0]))
def test_the_breakdown_cuts_lines_the_source_holds(variant):
    """Each cut-down copy of csrc/wkv.cu that ``python -m
    repro_torch.kernels.breakdown wkv`` builds on the card edits text the
    source holds, once each (the tool raises on the card otherwise)."""
    source = (_build.CSRC / "wkv.cu").read_text()
    for old, _ in breakdown.VARIANTS["wkv.cu"][0][variant]:
        assert source.count(old) == 1, old


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bh", [(B, H), (1, 3)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 16, 37, 64, 65, 200])
def test_the_kernels_equal_the_plain_loop(cuda, hd, T, bh):
    """The forward and backward kernels against the plain loop and its
    autograd on the card, f32, within 1e-5 of each output's largest value,
    for a loss on y and S and for one on y alone (no g(S_T), as training
    asks); each wrapper counts one launch a call. T straddles a chunk of
    16 steps (the saved-state interval and a stage of the load ring) and
    the backward's history of 8; B x H 1 x 3 puts three heads of one row
    side by side (an odd number of backward clusters, one a (b, h))."""
    *ins, gy, gs = (torch.from_numpy(a).to(cuda)
                    for a in _inputs(T, hd=hd, seed=hd, b=bh[0], h=bh[1]))
    before = dict(ops.launches)
    a = [t.clone().requires_grad_(True) for t in ins]
    y, s = ops.wkv(*a)
    got = torch.autograd.grad((y, s), a, (gy, gs))
    torch.cuda.synchronize()
    assert ops.launches["wkv_fwd"] == before["wkv_fwd"] + 1
    assert ops.launches["wkv_bwd"] == before["wkv_bwd"] + 1
    b = [t.clone().requires_grad_(True) for t in ins]
    wy, ws = ref.wkv_ref(*b)
    want = torch.autograd.grad((wy, ws), b, (gy, gs), retain_graph=True)
    for name, x, z in zip(("y", "S", "gr", "gk", "gv", "gw", "gu", "gS0"), (y, s, *got), (wy, ws, *want)):
        _close(x.detach().cpu().numpy(), z.detach().cpu().numpy(), f"{name} hd={hd} T={T}")
    got_y = torch.autograd.grad(ops.wkv(*a)[0], a, gy)
    # at T = 1, y does not depend on w: its gradient there is zeros
    want_y = torch.autograd.grad(wy, b, gy, materialize_grads=True)
    assert ops.launches["wkv_bwd"] == before["wkv_bwd"] + 2
    for name, x, z in zip(("gr", "gk", "gv", "gw", "gu", "gS0"), got_y, want_y):
        _close(x.cpu().numpy(), z.cpu().numpy(), f"{name} of y alone hd={hd} T={T}")
    with pytest.raises(ValueError, match="head_dim"):
        ops.wkv(*(t[..., :16].contiguous() for t in ins[:4]), ins[4][:, :16].contiguous(),
                ins[5][..., :16, :16].contiguous())
