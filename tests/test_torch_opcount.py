"""The port's op counter (`repro_torch.runtime.opcount`), the counterpart
of ``repro.runtime.hlo``: the reference's analyzer tests
(tests/test_runtime.py::TestHloAnalyzer) with its scans as Python loops,
the two traps of counting DTensor programs at a fake (16, 16) mesh (a
rank's FLOPs are its local work, and the same on the first call as on
the second, whatever DTensor's propagation cache holds), the ring factors
of each collective, and the kernel regions: K1, K2 and K4 count the same
work as their plain paths."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores
torch.set_num_threads(1)
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.core import predictor as pred  # noqa: E402
from repro_torch.core.predictor import PredictorConfig, init_predictor  # noqa: E402
from repro_torch.core.simulator import SimConfig, init_state, model_input  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.runtime import opcount  # noqa: E402
from repro_torch.runtime.opcount import analyze  # noqa: E402


def test_loop_trip_count_flops():
    """A Python loop is its own trip count: 5 matmuls of 8x64 @ 64x64."""
    def f(w, x):
        c = x
        for wi in w:
            c = torch.tanh(c @ wi)
        return c.sum()

    res = analyze(f, torch.randn(5, 64, 64), torch.randn(8, 64))
    assert res["flops"] == pytest.approx(5 * 2 * 8 * 64 * 64, rel=0.01)
    assert res["op_histogram"]["dot"] == 5
    assert res["dot_flops_by_shape"] == {"8x64": 5 * 2 * 8 * 64 * 64}


def test_nested_loops_multiply():
    def f(w, x):
        c = x
        for _ in range(3):
            for wi in w:
                c = torch.tanh(c @ wi)
        return c.sum()

    res = analyze(f, torch.randn(4, 32, 32), torch.randn(8, 32))
    assert res["flops"] == pytest.approx(3 * 4 * 2 * 8 * 32 * 32, rel=0.01)


@pytest.mark.parametrize("how", ["index_copy_", "setitem"])
def test_slot_writes_do_not_count_the_full_buffer(how):
    """In-place slot writes move the slot, not the carried buffer: the
    whole buffer counted at each write would be >= 4 x 2 x 1000 x 64 x 4
    = 2 MB."""
    def f(x):
        buf = torch.zeros(1000, 64)
        for i in range(4):
            if how == "index_copy_":
                buf.index_copy_(0, torch.tensor([i]), x[None] * 1.0)
            else:
                buf[i] = x * 1.0
        return buf.sum()

    res = analyze(f, torch.randn(64))
    assert res["bytes_accessed"] < 1.5e6
    assert res["memory_analysis"]["temp_bytes"] >= 1000 * 64 * 4


def test_views_and_broadcasts_move_nothing_extra():
    x = torch.randn(256, 256)
    res = analyze(lambda t: t.reshape(-1)[:10].view(2, 5).t(), x)
    assert res["bytes_accessed"] == 0.0 and res["flops"] == 0.0
    row = torch.randn(1, 256)
    res = analyze(lambda a, b: a + b.expand(256, 256), x, row)
    assert res["bytes_accessed"] == 4 * (2 * 256 * 256 + 256)


def test_a_region_is_a_no_op_without_a_counter():
    called = []
    ctx = opcount.region("k", lambda: called.append(1) or {"flops": 1.0, "bytes": 1.0})
    with ctx:
        pass
    assert called == [] and ctx is opcount.region("k", None)  # one shared no-op


def test_a_region_counts_its_work_once_and_mutes_its_ops():
    def f(a, b):
        with opcount.region("outer", lambda: {"flops": 7.0, "bytes": 3.0}):
            with opcount.region("inner", lambda: {"flops": 100.0, "bytes": 100.0}):
                a = a @ b
        return a @ b

    res = analyze(f, torch.randn(4, 8), torch.randn(8, 8))
    assert res["flops"] == 7.0 + 2 * 4 * 8 * 8
    assert res["regions"] == {"outer": 1} and res["op_histogram"]["fusion"] == 1


# -- DTensors at a fake (16, 16) mesh ---------------------------------------

@pytest.fixture(scope="module")
def fake_mesh():
    """Rank 0 of a "fake" group of 256 ranks (collectives move nothing)
    and a (data 16, model 16) mesh; the group ends with the module."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        yield init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _fake_dtensor(mode, mesh, shape, placements, dtype=torch.float32):
    from repro_torch.runtime.sharding import local_shape_and_offset

    local, _ = local_shape_and_offset(shape, mesh, placements)
    with mode:
        t = torch.empty(local, dtype=dtype)
    return DTensor.from_local(t, mesh, placements, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride(), run_check=False)


@pytest.mark.parametrize("fake", [True, False], ids=["fake", "real"])
def test_a_rank_counts_its_local_work_on_the_first_call_and_the_second(fake_mesh, fake):
    """x (M, 4096) split on data @ w (4096, N) split on model: each rank
    multiplies (M/16, 4096) @ (4096, N/16), 1/256 of the product, and
    DTensor's propagation at the global shape (run once per op, shapes
    and placements) counts nothing. A shape of each case's own keeps the
    first call a first."""
    M, K, N = (2048, 4096, 11008) if fake else (512, 256, 1024)
    mode = FakeTensorMode() if fake else None
    if fake:
        x = _fake_dtensor(mode, fake_mesh, (M, K), [Shard(0), Replicate()])
        w = _fake_dtensor(mode, fake_mesh, (K, N), [Replicate(), Shard(1)])
    else:
        x = DTensor.from_local(torch.randn(M // 16, K), fake_mesh, [Shard(0), Replicate()])
        w = DTensor.from_local(torch.randn(K, N // 16), fake_mesh, [Replicate(), Shard(1)])
    want = 2.0 * M * K * N / 256
    got = [analyze(torch.matmul, x, w, fake_mode=mode) for _ in range(2)]
    for res in got:
        assert res["flops"] == want
        assert res["dot_flops_by_shape"] == {f"{M // 16}x{N // 16}": want}
        assert res["collectives"]["total_count"] == 0


@pytest.mark.parametrize("kind, op", [
    ("all-gather", "all_gather_into_tensor"), ("reduce-scatter", "reduce_scatter_tensor"),
    ("all-reduce", "all_reduce"), ("all-to-all", "all_to_all_single")])
def test_ring_factors_by_kind(fake_mesh, kind, op):
    """Each functional collective's wire bytes: its result's bytes times
    the reference's ring factor at the group's size (16)."""
    group = fake_mesh["model"].get_group().group_name
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(64, 32)
    c10d = torch.ops._c10d_functional
    call = {
        "all_gather_into_tensor": lambda: c10d.all_gather_into_tensor(x, 16, group),
        "reduce_scatter_tensor": lambda: c10d.reduce_scatter_tensor(x, "sum", 16, group),
        "all_reduce": lambda: c10d.all_reduce(x, "sum", group),
        "all_to_all_single": lambda: c10d.all_to_all_single(x, [4] * 16, [4] * 16, group),
    }[op]
    result = {"all-gather": 16 * 64 * 32 * 4, "reduce-scatter": 4 * 32 * 4}.get(kind, 64 * 32 * 4)
    factor = {"all-gather": 15 / 16, "reduce-scatter": 15.0, "all-reduce": 2 * 15 / 16,
              "all-to-all": 15 / 16}[kind]
    with mode:
        res = analyze(call, fake_mode=mode)
    coll = res["collectives"]
    assert coll["count_by_op"] == {kind: 1}
    assert coll["bytes_by_op"][kind] == pytest.approx(result * factor)
    assert coll["total_bytes"] == pytest.approx(result * factor)


def test_k4_shard_mode_region_on_a_kvseq_split_cache(fake_mesh):
    """Decode attention against a cache split along its sequence over
    "model": one region a call, each rank's shard (S / 16 positions;
    fake lengths stand for a full cache), the same with K4 and plain."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    B, S, H, KV, hd = 16, 4096, 8, 4, 64
    cache = attn.KVCache(*(_fake_dtensor(mode, fake_mesh, (B, S, KV, hd),
                                         [Replicate(), Shard(1)]) for _ in range(2)))
    with mode:
        q = torch.empty(B, H, hd)
        n = torch.empty((), dtype=torch.int32)
    got = [analyze(attn.decode_attention, q, cache, n, dtype=torch.float32, use_kernel=uk,
                   fake_mode=mode) for uk in (False, True)]
    want = 4.0 * B * H * (S // 16) * hd
    for res in got:
        assert res["regions"] == {"decode_attn": 1}
        assert res["dot_flops_by_shape"]["decode_attn"] == want
    assert got[0]["flops"] == got[1]["flops"]
    assert got[0]["bytes_accessed"] == got[1]["bytes_accessed"]
    assert got[0]["collectives"] == got[1]["collectives"]


@pytest.mark.parametrize("shard", ["first", "last"])
def test_k4_window_on_a_kvseq_split_fake_cache(fake_mesh, shard):
    """A windowed layer on a fake cache split along its sequence: the fake
    length stands for a full cache of the global length, so the window's
    positions lie on the last shard. Rank 0 holds the first shard on the
    (16, 16) mesh and the last one on a mesh of the same ranks in reverse
    order: 0 live positions, then min(window, S / 16)."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = fake_mesh if shard == "first" else DeviceMesh(
        "cpu", torch.arange(255, -1, -1).reshape(16, 16), mesh_dim_names=("data", "model"))
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    B, S, H, KV, hd, window = 16, 4096, 8, 4, 64, 200
    cache = attn.KVCache(*(_fake_dtensor(mode, mesh, (B, S, KV, hd), [Replicate(), Shard(1)])
                           for _ in range(2)))
    with mode:
        q = torch.empty(B, H, hd)
        n = torch.empty((), dtype=torch.int32)
    got = [analyze(attn.decode_attention, q, cache, n, dtype=torch.float32, window=window,
                   use_kernel=uk, fake_mode=mode) for uk in (False, True)]
    live = 0 if shard == "first" else min(window, S // 16)
    for res in got:
        assert res["regions"] == {"decode_attn": 1}
        assert res["dot_flops_by_shape"]["decode_attn"] == 4.0 * B * H * live * hd
    assert got[0]["bytes_accessed"] == got[1]["bytes_accessed"]


# -- the kernel regions on the CPU -------------------------------------------

def _c3():
    pcfg = PredictorConfig(kind="c3", ctx_len=16)
    return pcfg, init_predictor(torch.Generator().manual_seed(0), pcfg, device="cpu")


def _gemm_flops(params, x, pcfg):
    """The plain conv stack's GEMM FLOPs, counted op by op (no region)."""
    def chain(h):
        h = pred._pad_seq(h, pcfg)
        for i in range(3):
            h = pred.conv2s(params[f"conv{i}"], h)
        return h

    return analyze(chain, x)["flops"]


@pytest.mark.parametrize("layout", ["ring", "roll"])
def test_k2_region_counts_the_plain_trunks_gemms(layout):
    """`apply_trunk` of c3 with K2 (its plain version on the CPU) and
    without: the same counts, the trunk's GEMM FLOPs."""
    pcfg, params = _c3()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((32, 17, 50))
                         .astype(np.float32))
    got = [analyze(pred.apply_raw, params, x, pcfg, use_kernel=uk) for uk in (True, False)]
    for k in ("flops", "bytes_accessed", "op_histogram", "dot_flops_by_shape"):
        assert got[0][k] == got[1][k], k
    head = 2.0 * 32 * (pcfg.seq_padded // 8 * 128) * 256 + 2.0 * 32 * 256 * pcfg.out_dim
    assert got[0]["flops"] == pytest.approx(_gemm_flops(params, x, pcfg) + head)
    assert got[0]["regions"] == {"cnn_trunk": 1}


def _ring_state(L, ctx, seed=0):
    rng = np.random.default_rng(seed)
    state = init_state(L, SimConfig(ctx_len=ctx), "cpu")
    feat = torch.from_numpy(rng.random(state.feat.shape).astype(np.float32))
    addr = torch.from_numpy(rng.integers(0, 6, state.addr.shape).astype(np.int32))
    valid = torch.from_numpy(rng.random(state.valid.shape) < 0.8)
    state = state._replace(feat=feat, addr=addr, valid=valid, head=torch.tensor(5))
    cur = (torch.from_numpy(rng.random((L, feat.shape[2])).astype(np.float32)),
           torch.from_numpy(rng.integers(0, 6, (L, 5)).astype(np.int32)))
    return state, cur


def _one_step(params, pcfg, use_kernel, L=24, device="cpu"):
    """`run_chunk` of one step of c3 on a ring state (K1's configuration)
    under a counter: (the counter's record, the state after)."""
    from repro_torch.serving.simnet_engine import chunk_specs, run_chunk

    cfg = SimConfig(ctx_len=pcfg.ctx_len)
    state, (cur_feat, cur_addr) = _ring_state(L, pcfg.ctx_len)
    state = state._replace(**{f: getattr(state, f).to(device) for f in state._fields})
    xs = {k: torch.zeros(shape, dtype=dt, device=device)
          for k, (shape, dt) in chunk_specs(L, 1).items()}
    xs.update(feat=cur_feat[None].to(device), addr=cur_addr[None].to(device),
              active=torch.ones(1, L, dtype=torch.bool, device=device))
    rw = torch.full((L,), cfg.retire_width, dtype=torch.int32, device=device)
    lc = torch.full((L,), cfg.ctx_len, dtype=torch.int32, device=device)
    res = analyze(run_chunk, pcfg, cfg, use_kernel, params, state, xs, rw, lc)
    return res, res.pop("out")


def test_k1_region_counts_the_same_as_the_plain_step():
    """One engine step of c3 on a ring state with K1 (its plain version on
    the CPU) and the plain route (`model_input` + the predictor): equal
    counts and states. The region's FLOPs are the trunk's and the head's
    GEMMs, as the plain route counted op by op without the region; its
    bytes, each plane and weight read once and the latencies written
    once, are below what the plain route's ops move."""
    pcfg, params = _c3()
    got = [_one_step(params, pcfg, uk) for uk in (True, False)]
    for k in ("flops", "bytes_accessed", "op_histogram", "dot_flops_by_shape", "regions"):
        assert got[0][0][k] == got[1][0][k], k
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)
    assert got[0][0]["regions"] == {"fused_step": 1}
    state, (cur_feat, cur_addr) = _ring_state(24, 16)
    region = opcount.fused_step_work(params, state, cur_feat, cur_addr, pcfg.seq_padded)
    head = 2.0 * 24 * (pcfg.seq_padded // 8 * 128) * 256 + 2.0 * 24 * 256 * pcfg.out_dim
    assert region["flops"] == _gemm_flops(params, torch.zeros(24, 17, 50), pcfg) + head
    predict = pred.make_predict_fn(params, pcfg)
    plain = analyze(lambda: predict(model_input(state, cur_feat, cur_addr, SimConfig(ctx_len=16))))
    assert plain["flops"] == region["flops"]
    assert region["bytes"] < plain["bytes_accessed"]


@pytest.mark.parametrize("cache_len, window", [(40, 0), (64, 0), (40, 16)])
def test_k4_region_counts_4bhsd_on_the_live_positions(cache_len, window):
    """Decode attention, K4 (its plain version on the CPU) or plain: 4 · B
    · H · S_live · hd FLOPs and the live K/V; on a full cache without a
    window, the plain einsums' FLOPs counted op by op."""
    B, S, H, KV, hd = 2, 64, 8, 2, 32
    rng = np.random.default_rng(cache_len + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    n = torch.tensor(cache_len, dtype=torch.int32)
    got = [analyze(attn.decode_attention, q, attn.KVCache(k, v), n, dtype=torch.float32,
                   window=window, use_kernel=uk) for uk in (True, False)]
    live = min(cache_len, window) if window else cache_len
    for res in got:
        assert res["flops"] == 4.0 * B * H * live * hd
        assert res["bytes_accessed"] == 4.0 * (2 * B * H * hd + 2 * B * live * KV * hd)
    if cache_len == S and not window:
        plain = analyze(attn._plain_attention, q, k, v, n, dtype=torch.float32, window=0)
        assert plain["flops"] == got[0]["flops"]


def test_k4_region_bytes_against_the_plain_path_op_by_op():
    """An independent count of K4's bytes, at the gemma3-4b decode shape
    of the card's smoke test (8 requests, 2112 positions, 8 heads, 4 KV
    heads of 256) on a full cache without a window: the plain path counted
    op by op, the region off. It moves K and V three times (the einsums'
    contiguous copies read and write them, the GEMMs read them again)
    where the region reads them once: between 2.9 and 3.2 times the
    region's bytes, and the same FLOPs."""
    mode = FakeTensorMode()
    B, S, H, KV, hd = 8, 2112, 8, 4, 256
    for dtype in (torch.bfloat16, torch.float32):
        with mode:
            q = torch.empty(B, H, hd, dtype=dtype)
            k, v = (torch.empty(B, S, KV, hd, dtype=dtype) for _ in range(2))
            n = torch.empty((), dtype=torch.int32)
            plain = analyze(attn._plain_attention, q, k, v, n, dtype=dtype, window=0,
                            fake_mode=mode)
            region = analyze(attn.decode_attention, q, attn.KVCache(k, v), n, dtype=dtype,
                             fake_mode=mode)
        assert region["regions"] == {"decode_attn": 1}
        assert plain["flops"] == region["flops"] == 4.0 * B * H * S * hd
        assert 2.9 <= plain["bytes_accessed"] / region["bytes_accessed"] <= 3.2


def test_a_loop_on_shape_only_tensors_counts_one_step_times_its_trips():
    """rwkv's wkv scan over T steps: on fake tensors (a dry run) the loop
    counts each step, as on real tensors, forward and backward."""
    from repro_torch.nn import ssm

    B, T, H, hd = 2, 12, 2, 8
    shapes = [(B, T, H, hd)] * 4 + [(H, hd)]

    def fwd_bwd(r, k, v, w, u, S):
        y, last = ssm._wkv_scan(r, k, v, w, u, S)
        torch.autograd.grad(y.sum() + last.sum(), [r, k, v, w, u])

    real = [torch.randn(s, requires_grad=True) for s in shapes] + [torch.zeros(B, H, hd, hd)]
    mode = FakeTensorMode()
    with mode:
        fake = [torch.empty(s, requires_grad=True) for s in shapes] + [torch.zeros(B, H, hd, hd)]
        got = analyze(fwd_bwd, *fake, fake_mode=mode)
    want = analyze(fwd_bwd, *real)
    assert got["flops"] == want["flops"] == 3 * T * 2 * B * H * hd * hd
    assert got["dot_flops_by_shape"] == want["dot_flops_by_shape"]


def test_the_wkv_backward_moves_bytes_linear_in_T():
    """rwkv's wkv scan backward at T and 2T: each input's gradient is
    stacked once, so the counted bytes at most 2.2 times (a select a step
    would scatter a full (B, T, H, hd) gradient a step: 3.4-3.8 times at
    these lengths)."""
    from repro_torch.nn import ssm

    B, H, hd = 2, 2, 8

    def backward_bytes(T):
        g = torch.Generator().manual_seed(0)
        ins = [torch.randn(B, T, H, hd, generator=g, requires_grad=True) for _ in range(4)]
        u = torch.randn(H, hd, generator=g, requires_grad=True)
        y, last = ssm._wkv_scan(*ins, u, torch.zeros(B, H, hd, hd))
        loss = y.sum() + last.sum()
        return analyze(lambda: torch.autograd.grad(loss, ins + [u]))["bytes_accessed"]

    for T in (32, 64):
        assert backward_bytes(2 * T) <= 2.2 * backward_bytes(T), T


def test_live_positions_of_a_shard():
    n = torch.tensor(100)
    assert opcount.live_positions(n, 64, offset=0) == 64
    assert opcount.live_positions(n, 64, offset=64) == 36
    assert opcount.live_positions(n, 64, offset=128) == 0
    assert opcount.live_positions(n, 64, window=50, offset=0) == 14  # [50, 64)
    assert opcount.live_positions(n, 64, window=50, offset=64) == 36


def test_lower_counts_a_c3_chunk_the_same_with_and_without_k1():
    """`SimNetEngine.lower` on fake tensors: the engine with K1 and
    without count the same (the plain ops trace; K1's region is the same
    work), the head and trunk GEMMs per step times the chunk."""
    from repro_torch.serving.simnet_engine import SimNetEngine

    pcfg, params = _c3()
    got = [SimNetEngine(params, pcfg, device="cpu", use_kernel=uk).lower(64, 4)
           for uk in (True, False)]
    for k in ("flops", "bytes_accessed", "op_histogram", "memory_analysis"):
        assert got[0][k] == got[1][k], k
    per_step = got[0]["flops"] / 4
    x = torch.zeros(64, 17, 50)
    head = 2.0 * 64 * (pcfg.seq_padded // 8 * 128) * 256 + 2.0 * 64 * 256 * pcfg.out_dim
    assert per_step == pytest.approx(_gemm_flops(params, x, pcfg) + head)
    assert got[0]["collectives"]["total_count"] == 0 and got[0]["regions"] == {"fused_step": 4}
    assert got[0]["memory_analysis"]["peak_live_bytes_est"] > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_count_the_same_as_plain_on_the_card(cuda):
    """K1 and K4 launched on the card under a counter: the counts of the
    plain paths, and the kernels ran (launch counts)."""
    from repro_torch.kernels import ops

    pcfg, params = _c3()
    params = {k: {kk: t.to(cuda) for kk, t in v.items()} for k, v in params.items()}
    before = dict(ops.launches)
    got = [_one_step(params, pcfg, uk, L=64, device=cuda)[0] for uk in (True, False)]
    assert ops.launches["fused_step"] == before["fused_step"] + 1
    for k in ("flops", "bytes_accessed", "dot_flops_by_shape"):
        assert got[0][k] == got[1][k], k
    q, k, v = (torch.randn(s, device=cuda, dtype=torch.bfloat16)
               for s in ((4, 8, 64), (4, 256, 2, 64), (4, 256, 2, 64)))
    n = torch.tensor(200, dtype=torch.int32, device=cuda)
    got = [analyze(attn.decode_attention, q, attn.KVCache(k, v), n, use_kernel=uk)
           for uk in (True, False)]
    assert ops.launches["decode_attn"] == before["decode_attn"] + 1
    assert got[0]["flops"] == got[1]["flops"] == 4.0 * 4 * 8 * 200 * 64
    assert got[0]["bytes_accessed"] == got[1]["bytes_accessed"]
