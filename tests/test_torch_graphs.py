"""The resident programs of the port — CUDA graphs of a SimNet chunk and
of a decode step — against the eager functions they capture.

On the card (``cuda`` tests) a graph's totals, tokens and final state must
equal the eager pass's bit for bit: a replay runs the same kernels in the
same order on the same inputs. On the CPU a program is the eager chunk
function, so the CPU cases hold the program path to a pass written out by
hand. This file imports neither JAX nor the reference package, so the
``cuda`` tests run on a machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs.py
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.features import trace_arrays  # noqa: E402
from repro_torch.core.predictor import PredictorConfig, init_predictor  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    SimConfig,
    init_state,
    pack_workloads,
    packed_tensors,
    pad_packed_lanes,
    workload_totals,
)
from repro_torch.des.o3 import O3Config, O3Simulator  # noqa: E402
from repro_torch.des.workloads import get_benchmark  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.lm import rehome_state  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.compile_cache import CompileCache, lane_bucket  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, lm_decoder  # noqa: E402
from repro_torch.serving.simnet_engine import ChunkGraph, SimNetEngine  # noqa: E402

CTX = 16
BENCHES = [("mlb_stream", 1300), ("sim_loop", 900)]
LANES, CHUNK = 4, 64  # 8 lanes in all; ~325 steps a lane, so six chunks chain
ROUTES = ["ring+fused_step", "roll+cnn_trunk", "plain", "teacher-forced"]
OTHER_KINDS = ["fc2", "fc3", "c1", "rb7", "lstm2", "ithemal_lstm2", "tx6"]
KERNEL = {"ring+fused_step": "fused_step", "roll+cnn_trunk": "cnn_trunk"}
B, PROMPT, STEPS = 2, 40, 8


@pytest.fixture(scope="module")
def arrs():
    sim = O3Simulator(O3Config())
    return [trace_arrays(sim.run(get_benchmark(n, s))) for n, s in BENCHES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the graphs and kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(seed, device, kind="c3"):
    pcfg = PredictorConfig(kind=kind, ctx_len=CTX)
    return init_predictor(torch.Generator().manual_seed(seed), pcfg, device), pcfg


def _engine(route, device, cache, seed=0):
    if route == "teacher-forced":
        return SimNetEngine(sim_cfg=SimConfig(ctx_len=CTX), device=device, cache=cache)
    params, pcfg = _params(seed, device)
    layout = "roll" if route.startswith("roll") else "ring"
    return SimNetEngine(params, pcfg, SimConfig(ctx_len=CTX, layout=layout),
                        use_kernel=route != "plain", device=device, cache=cache)


def _eager_totals(eng, arrs, lanes=LANES):
    """The engine's pass without its program: `_run_chunk` eagerly over
    the same pack, on the engine's device."""
    packed = pack_workloads(arrs, lanes, eng.sim_cfg, pad_to=CHUNK)
    packed = pad_packed_lanes(packed, lane_bucket(packed.n_lanes))
    dev = eng.device
    rw = torch.from_numpy(packed.retire_width).to(dev)
    lc = torch.from_numpy(packed.lane_ctx).to(dev)
    state = init_state(packed.n_lanes, eng.sim_cfg, dev)
    for lo in range(0, packed.n_steps, CHUNK):
        state = eng._run_chunk(state, packed_tensors(packed, dev, lo, lo + CHUNK), rw, lc)
    _, cycles, overflow = workload_totals(state, packed)
    return cycles.cpu().numpy().astype(np.float64), overflow.cpu().numpy()


def _check_route(route, device, arrs):
    eng = _engine(route, device, CompileCache())
    ops.reset_launches()
    got = eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK, timeit=True)
    counts = dict(ops.launches)
    assert got["n_steps"] > 2 * CHUNK and got["cache"]["misses"] == 1
    want_cycles, want_overflow = _eager_totals(eng, arrs)
    np.testing.assert_array_equal(got["workload_cycles"], want_cycles)
    np.testing.assert_array_equal(got["workload_overflow"], want_overflow)
    return eng, got, counts


@pytest.mark.parametrize("route", ROUTES)
def test_cpu_program_equals_the_eager_pass(arrs, route):
    eng, _, counts = _check_route(route, "cpu", arrs)
    assert sum(counts.values()) == 0  # CPU tensors take the plain versions


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_graph_equals_eager_bit_for_bit(cuda, arrs, route):
    """Totals of the chunk graph (six chained chunks, two passes) equal
    the eager pass; a replay counts the route's kernel once a step."""
    eng, got, counts = _check_route(route, cuda, arrs)
    assert isinstance(eng.executable(2 * LANES, CHUNK), ChunkGraph)
    want = {k: 0 for k in counts}
    if route in KERNEL:
        want[KERNEL[route]] = 2 * got["n_steps"]  # timeit: two passes
    assert counts == want


@pytest.mark.cuda
def test_graph_binds_each_engines_weights(cuda, arrs):
    """Two engines of the same kind with different weights through one
    cache: one graph, and each engine's totals equal its own eager ones."""
    cache = CompileCache()
    a, b = (_engine("ring+fused_step", cuda, cache, seed) for seed in (0, 1))
    results = [e.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"]
               for e in (a, b, a)]
    assert (cache.stats()["misses"], cache.stats()["hits"]) == (1, 2)
    for eng, cycles in zip((a, b, a), results):
        np.testing.assert_array_equal(cycles, _eager_totals(eng, arrs)[0])
    assert not np.array_equal(results[0], results[1])
    with torch.no_grad():
        a.params["fc1"]["b"] += 0.5  # an in-place update is seen at the next pass
    np.testing.assert_array_equal(a.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"],
                                  _eager_totals(a, arrs)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", OTHER_KINDS)
def test_every_kind_graph_equals_eager(cuda, arrs, kind):
    """Every other predictor kind through its chunk graph: totals equal the
    eager pass bit for bit, and no kernel runs (``use_kernel`` reaches only
    c1/c3, and c1's trunk kernel is C3-only, so c1 runs plain; rb7's convs
    are plain too); lstm runs through cuDNN."""
    params, pcfg = _params(0, cuda, kind)
    eng = SimNetEngine(params, pcfg, SimConfig(ctx_len=CTX), use_kernel=kind != "c1", device=cuda,
                       cache=CompileCache())
    ops.reset_launches()
    got = eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK, timeit=True)
    assert sum(ops.launches.values()) == 0
    assert isinstance(eng.executable(2 * LANES, CHUNK), ChunkGraph)
    want_cycles, want_overflow = _eager_totals(eng, arrs)
    np.testing.assert_array_equal(got["workload_cycles"], want_cycles)
    np.testing.assert_array_equal(got["workload_overflow"], want_overflow)


@pytest.mark.cuda
def test_rebound_params_reach_the_chunk_graph(cuda, arrs):
    """``engine.params = other`` (new tensors, at version 0 as the old ones
    were): the resident graph refills its slots and gives a fresh engine's
    totals."""
    cache = CompileCache()
    eng = _engine("ring+fused_step", cuda, cache, seed=0)
    first = eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"]
    eng.params, _ = _params(1, cuda)
    got = eng.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"]
    fresh = _engine("ring+fused_step", cuda, CompileCache(), seed=1)
    np.testing.assert_array_equal(got, fresh.simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"])
    assert not np.array_equal(got, first) and cache.stats()["misses"] == 1


@pytest.mark.cuda
def test_graph_passes_from_many_threads_take_turns(cuda, arrs):
    """A graph entry is not reentrant: eight threads run passes of two
    engines (other weights) through one cold cache at once; the graph is
    built once and every pass equals its engine's eager totals."""
    cache = CompileCache()
    engines = [_engine("ring+fused_step", cuda, cache, seed) for seed in (0, 1)]
    want = [_eager_totals(e, arrs)[0] for e in engines]
    results, errors = [], []

    def work(i):
        try:
            for _ in range(3):
                cycles = engines[i % 2].simulate_many(arrs, n_lanes=LANES, chunk=CHUNK)["workload_cycles"]
                results.append((i % 2, cycles))
        except BaseException as e:  # recorded and asserted below
            errors.append(e)
            raise

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(results) == 24 and cache.stats()["misses"] == 1
    for i, cycles in results:
        np.testing.assert_array_equal(cycles, want[i])


@pytest.mark.cuda
def test_graphs_built_on_several_threads_at_once(cuda, arrs):
    """Three threads each build the graph of another lane bucket at the
    same moment while a fourth runs passes of a graph built before (a
    service's drain thread beside another's, or beside a dispatch its
    watchdog abandoned): the builds take turns, the passes go on beside
    them, and every pass equals the eager totals at its shape."""
    cache = CompileCache()
    eng = _engine("ring+fused_step", cuda, cache)
    eng.simulate_many(arrs, n_lanes=8, chunk=CHUNK)  # resident before the threads start
    jobs = {1: 1, 2: 1, 4: 1, 8: 6}  # lanes a workload (buckets 2, 4, 8, 16): passes
    gate = threading.Barrier(len(jobs))
    got, errors = {n: [] for n in jobs}, []

    def work(n):
        try:
            gate.wait(60)
            for _ in range(jobs[n]):
                got[n].append(eng.simulate_many(arrs, n_lanes=n, chunk=CHUNK)["workload_cycles"])
        except BaseException as e:  # recorded and asserted below
            errors.append(e)
            raise

    threads = [threading.Thread(target=work, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert cache.stats()["misses"] == len(jobs)
    for n, runs in got.items():
        assert len(runs) == jobs[n]
        want = _eager_totals(eng, arrs, n)[0]
        for cycles in runs:
            np.testing.assert_array_equal(cycles, want)


def _decode_inputs(device):
    cfg = reduced(get_config("gemma3-4b"), n_layers=6, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), device=device)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    with torch.no_grad():
        logits, state = model.prefill(params, {"tokens": torch.from_numpy(prompts).to(device)})
    full = rehome_state(cfg, state, PROMPT + STEPS)
    return model, params, full, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [False, True])
def test_graph_decode_equals_eager(cuda, use_kernel):
    """The decode-step graph's greedy stream and final state equal the
    eager steps' bit for bit; the caller's state is untouched; K4 counts
    once a layer and replay (warm-up and timed pass)."""
    model, params, full, first = _decode_inputs(cuda)
    before = {k: v.clone() for k, v in full.items()}
    st, tok, eager = {k: v.clone() for k, v in full.items()}, first, []
    with torch.no_grad():
        for _ in range(STEPS):
            lg, st = model.decode_step(params, st, tok, use_kernel=use_kernel)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            eager.append(tok)
    engine = DecodeEngine(lm_decoder(model, use_kernel=use_kernel), params)
    ops.reset_launches()
    got, final, tps = engine.generate(full, first, STEPS)
    assert ops.launches["decode_attn"] == (model.cfg.n_layers * STEPS * 2 if use_kernel else 0)
    assert torch.equal(got, torch.stack(eager)) and tps > 0
    for k in full:
        assert torch.equal(final[k], st[k]), k
        assert torch.equal(full[k], before[k]), k
    again, _, _ = engine.generate(full, first, STEPS)  # the same graph, replayed
    assert torch.equal(again, got) and len(engine._graphs) == 1


@pytest.mark.cuda
def test_rebound_params_reach_the_decode_step_graph(cuda):
    """``engine.params = other``: the next pass captures the step again
    with the new weights and decodes as a fresh engine does."""
    model, params, full, first = _decode_inputs(cuda)
    engine = DecodeEngine(lm_decoder(model), params)
    before, _, _ = engine.generate(full, first, STEPS)
    other = model.init(torch.Generator().manual_seed(4), device=cuda)
    engine.params = other
    got, _, _ = engine.generate(full, first, STEPS)
    want, _, _ = DecodeEngine(lm_decoder(model), other).generate(full, first, STEPS)
    assert torch.equal(got, want) and not torch.equal(got, before)
    assert len(engine._graphs) == 1  # the stale graph was replaced, not kept beside


FAMILY_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b", "recurrentgemma-2b",
                "whisper-large-v3", "rwkv6-1.6b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_decode_graph_equals_eager(cuda, arch):
    """Each LM family's decode-step graph (reduced, f32, K4 on) gives the
    eager steps' greedy stream and final state bit for bit, the state a
    tree (the hybrid's per-layer dicts, whisper's constant ck/cv); K4
    counts once an attention layer and replay, none for rwkv6. mixtral
    runs at window 8 with a 6-token prompt so its ring wraps."""
    from repro_torch.serving.engine import copy_state

    over = dict(local_window=8) if arch == "mixtral-8x7b" else {}
    cfg = reduced(get_config(arch), dtype="float32", **over)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), device=cuda)
    # an MoE prefill's tokens fill whole routing groups (64 at reduced width)
    T = 6 if arch == "mixtral-8x7b" else 32 if cfg.family == "moe" else PROMPT
    g = torch.Generator(device=cuda).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=g, device=cuda,
                                     dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=g, device=cuda)
    with torch.no_grad():
        logits, state = model.prefill(params, batch)
    full = model.rehome_state(state, T + STEPS)
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    st, tok, eager = copy_state(full), first, []
    with torch.no_grad():
        for _ in range(STEPS):
            lg, st = model.decode_step(params, st, tok, use_kernel=True)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            eager.append(tok)
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))
    ops.reset_launches()
    got, final, _ = DecodeEngine(lm_decoder(model, use_kernel=True), params).generate(
        full, first, STEPS)
    assert ops.launches["decode_attn"] == n_attn * STEPS * 2
    assert torch.equal(got, torch.stack(eager))

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b)

    assert same(final, st)


@pytest.mark.cuda
def test_decode_attn_graph_replays_reset_the_merge_tickets(cuda):
    """One K4 call with several splits (qwen2-vl-72b's decode shape),
    captured in a CUDA graph and replayed three times with another
    cache_len each time, equals an eager call bit for bit every time: the
    last block of each merge leaves its ticket at 0 for the next replay."""
    B, H, KV, hd, S = 8, 64, 8, 128, 2112
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, torch.bfloat16)
               for shape in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    props = torch.cuda.get_device_properties(cuda)
    assert ops.decode_plan(B, S, H, KV, hd, 2, props.multi_processor_count).splits > 1
    cl = torch.tensor(S, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # first call on the capture stream: its tickets, the kernel loaded
        ops.decode_attn(q, k, v, cl)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = ops.decode_attn(q, k, v, cl)
    for n in (2049, 1, 1500):
        cl.fill_(n)
        graph.replay()
        want = ops.decode_attn(q, k, v, torch.tensor(n, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"replay with cache_len {n}"
