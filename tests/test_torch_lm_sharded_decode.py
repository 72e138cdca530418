"""Sharded LM prefill and decode against the JAX package, on the CPU:
gloo ranks of one machine, each a process holding its shards (params
placed by ``rules_for(cfg, mode)``, every KV cache split along its
sequence on ``kvseq``).

One world of four ranks is spawned for the module (``OMP_NUM_THREADS=1``
in each; results come back as numpy arrays). Its mesh (pair 2, data 1,
model 2) gives each pair of ranks a (data 1, model 2) submesh: ranks 0-1
run ``"decode"`` on theirs while ranks 2-3 run ``"decode_long"``; then
all four run ``"decode"`` on a (data 2, model 2) mesh.

For one arch of every family (``FAMILY_ARCHS`` of
test_torch_lm_sharded_train.py) and gemma3-4b at 6 layers (local window
32), reduced, in f32, from the reference's ``init`` crossed over as
numpy arrays: the sharded ``prefill``, the
re-homed state, then 8 greedy steps of ``DecodeEngine(mesh=)`` (each
step's logits kept by the decoder; K4's shard mode, its plain version on
CPU tensors, under ``"decode"``, the plain attention under
``"decode_long"``). Every run gives the reference's
unsharded tokens (jitted ``prefill`` and ``decode_step``, re-homed as
``examples/serve_lm.py`` does), and logits within 1e-5 (rtol and atol),
the RG-LRU hybrid's within 1e-4 (its scan sums in another order than
XLA's even unsharded).

Prompt and state lengths (`SHAPES`) put these cases in the (1, 2) runs,
where each rank holds half the positions (`test_the_runs_reach_every_shard_case`):
- a shard holds no live position before ``pos`` reaches its offset (28
  prompt tokens in 64 positions: rank 1's [32, 64) for the first 4
  steps);
- a window crosses a shard boundary, then a shard falls outside it
  (gemma3: 78 tokens in 96 positions, window 32: [47, 79) across 48 at
  the first step, then rank 0's [0, 48) outside every local layer's
  window);
- a ring write lands on rank 1 (mixtral's positions 16-23 go to slots
  16-23 of its ring of 32; the hybrid's 12-token prompt leaves a ring of
  12, whose slots 6 and 7 take positions 18 and 19).
A one-rank mesh is bit for bit the engine without a mesh (plain tensors,
the same step).
"""
import dataclasses
import faulthandler
import multiprocessing
import os
import pickle
import time
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.models.registry import build_model as ref_build_model  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, lm_decoder  # noqa: E402

FAMILY_ARCHS = ("tinyllama-1.1b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b",
                "recurrentgemma-2b", "whisper-large-v3", "rwkv6-1.6b", "gemma3-4b")
OVERRIDES = {"gemma3-4b": {"n_layers": 6}}  # local layers 0-4 (window 32), layer 5 global
# (prompt tokens, decode state positions), else DEFAULT_SHAPE; the MoE
# groups take B x T tokens in 64s, one group or an even number of them
# (the batch splits over "data"); rwkv's state has no positions, so its
# prompt is short (its scan is a loop over the prompt)
SHAPES = {"gemma3-4b": (78, 96), "mixtral-8x7b": (16, 64), "phi3.5-moe-42b-a6.6b": (16, 64),
          "recurrentgemma-2b": (12, 64), "rwkv6-1.6b": (8, 64)}
DEFAULT_SHAPE, B, STEPS, N_PATCHES = (28, 64), 4, 8, 4
# (mode, mesh) of every run, and the ranks that run it: both pairs of the
# (2, 1, 2) world first, one mode each, then all four ranks
RUNS = {("decode", (1, 2)): (0, 1), ("decode_long", (1, 2)): (2, 3),
        ("decode", (2, 2)): (0, 1, 2, 3)}
WORLD = 4
LOGIT_TOL = {"hybrid": 1e-4}  # else 1e-5
TIMEOUT_S = 300
# logits tied across the vocab shards (row 0) and within one (row 1)
TIED = np.array([[0, 0, 1, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 3, 0, 3]], dtype=np.float32)


def _cfg(arch):
    return reduced(registry.ARCHS[arch], dtype="float32", **OVERRIDES.get(arch, {}))


def _batch(cfg, T):
    """numpy inputs: tokens, and frames (whisper) or patches + M-RoPE
    positions (qwen2-vl: a 2 x 2 grid of patches, then text)."""
    rng = np.random.default_rng(7)
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


def _reference(arch, rparams):
    """The reference's unsharded run: jitted prefill, the state re-homed as
    examples/serve_lm.py does, STEPS greedy decode steps."""
    rm = ref_build_model(ref_reduced(REF_ARCHS[arch], dtype="float32", **OVERRIDES.get(arch, {})))
    T, S = SHAPES.get(arch, DEFAULT_SHAPE)
    jb = {k: jnp.asarray(v) for k, v in _batch(_cfg(arch), T).items()}
    logits, state = jax.jit(rm.prefill)(rparams, jb)
    full = rm.init_decode_state(B, S)
    for k in state:
        if k == "pos":
            full["pos"] = state["pos"]
        elif k in full and hasattr(full[k], "shape") and full[k].shape != state[k].shape:
            full[k] = full[k].at[tuple(slice(0, s) for s in state[k].shape)].set(state[k])
        else:
            full[k] = state[k]
    step = jax.jit(rm.decode_step)
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
    toks, lgs = [], []
    for _ in range(STEPS):
        lg, full = step(rparams, full, tok)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        lgs.append(np.asarray(lg))
    return {"prefill": np.asarray(logits)[:, -1], "tokens": np.stack(toks), "logits": np.stack(lgs)}


def _plain(tree):
    """``tree`` with every tensor as a numpy array: what a rank puts on the
    queue (a tensor would travel as a handle to storage that dies with
    the rank)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _recording(decoder, logits):
    """``decoder`` whose every step also keeps its logits, gathered."""
    def step(params, state, token, constrain=None):
        lg, state = decoder.step(params, state, token, constrain=constrain)
        logits.append(lg.full_tensor() if isinstance(lg, DTensor) else lg)
        return lg, state

    return dataclasses.replace(decoder, step=step)


def _decode_run(arch, params_np, mesh, mode):
    """One arch on ``mesh`` under ``mode``'s rules: sharded prefill, the
    re-homed state, then STEPS greedy steps through DecodeEngine(mesh=)
    (tokens, and each step's logits; K4 under "decode")."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    rules = sh.rules_for(cfg, mode)
    params = sh.shard_tree(model.params_from_numpy(params_np, "cpu"), model.param_specs(), rules,
                           mesh)
    T, S = SHAPES.get(arch, DEFAULT_SHAPE)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, T).items()}
    logits = []
    with torch.no_grad():
        first, state = model.prefill(params, batch, constrain=sh.make_constrain(mesh, rules))
        full = model.rehome_state(state, S)
        placed = sorted({str(tuple(t.placements)) for t in tree_leaves(full)
                         if isinstance(t, DTensor)})
        decoder = _recording(lm_decoder(model, use_kernel=mode == "decode"), logits)
        engine = DecodeEngine(decoder, params, mesh=mesh, rules_mode=mode)
        tokens, final, _ = engine.generate(full, sh.argmax_last(first[:, -1]), STEPS)
    return {"prefill": first[:, -1].full_tensor(), "tokens": tokens, "mode": engine.mode,
            "logits": torch.stack(logits[-STEPS:]), "placed": placed,
            "pos": int(sh.local(final["pos"]))}


def _rank(rank, init, params_file, queue):
    """One rank of the world: every run it takes part in, for every arch,
    once the fixture has written the params."""
    faulthandler.enable(all_threads=True)  # a crash prints every thread's stack
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT_S))
    out = {}
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not os.path.exists(params_file):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no params at {params_file}")
            time.sleep(0.05)
        with open(params_file, "rb") as f:
            params = pickle.load(f)
        world = mesh_mod.make_mesh((2, 1, 2), ("pair", "data", "model"), "cpu")
        pair = world["data", "model"]
        both = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
        split = sh.place(torch.from_numpy(TIED), pair, sh.to_placements(sh.P(None, "model"), pair))
        out["ties"] = sh.argmax_last(split)
        for (mode, shape), ranks in RUNS.items():
            if rank not in ranks:
                continue
            mesh = pair if shape == (1, 2) else both
            for arch in FAMILY_ARCHS:
                out[mode, shape, arch] = _decode_run(arch, params[arch], mesh, mode)
    except BaseException as e:  # the fixture reports it
        out = {"error": repr(e)}
        raise
    finally:
        dist.destroy_process_group()
        queue.put((rank, _plain(out)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The references, and every rank's results by rank. The ranks start
    first and read the params from a file once it is there: they import
    while the params are drawn (a large argument would also hold each
    start() until the child before it had read its pipe)."""
    work = tmp_path_factory.mktemp("world")
    params_file = work / "params.pkl"
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{work}/store"
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_rank, args=(r, init, str(params_file), queue), daemon=True)
                 for r in range(WORLD)]
        for p in procs:
            p.start()
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    try:
        params = {}
        for arch in FAMILY_ARCHS:
            rm = ref_build_model(ref_reduced(REF_ARCHS[arch], dtype="float32",
                                             **OVERRIDES.get(arch, {})))
            params[arch] = rm.init(jax.random.PRNGKey(3))[0]
        with open(work / "params.tmp", "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
        os.replace(work / "params.tmp", params_file)  # whole when it appears
        # the references run here while the ranks decode
        refs = {arch: _reference(arch, params[arch]) for arch in FAMILY_ARCHS}
        got = dict(queue.get(timeout=TIMEOUT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(TIMEOUT_S)
            if p.is_alive():
                p.kill()
    for rank in sorted(got):
        assert "error" not in got[rank], (rank, got[rank].get("error"))
    assert all(p.exitcode == 0 for p in procs)
    return refs, got


@pytest.mark.parametrize("run", list(RUNS), ids=lambda r: f"{r[0]}-{r[1][0]}x{r[1][1]}")
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_decode_equals_the_reference(worlds, arch, run):
    refs, got = worlds
    ref = refs[arch]
    tol = LOGIT_TOL.get(REF_ARCHS[arch].family, 1e-5)
    ranks = RUNS[run]
    mine = got[ranks[0]][run + (arch,)]
    np.testing.assert_allclose(mine["prefill"], ref["prefill"], rtol=tol, atol=tol)
    np.testing.assert_array_equal(mine["tokens"], ref["tokens"])
    np.testing.assert_allclose(mine["logits"], ref["logits"], rtol=tol, atol=tol)
    assert mine["pos"] == SHAPES.get(arch, DEFAULT_SHAPE)[0] + STEPS and mine["mode"] == "eager"
    for r in ranks[1:]:  # every rank returns the same tokens and logits
        theirs = got[r][run + (arch,)]
        for k in ("tokens", "logits"):
            np.testing.assert_array_equal(theirs[k], mine[k])


@pytest.mark.parametrize("run", list(RUNS), ids=lambda r: f"{r[0]}-{r[1][0]}x{r[1][1]}")
def test_caches_are_split_along_their_sequence(worlds, run):
    """Every attention family's re-homed caches hold each rank's positions
    only: Shard(seq dim) on "model"; at (2, 2) "decode" splits the batch
    over "data" (a mesh dim of one rank splits nothing)."""
    _, got = worlds
    mode, shape = run
    for arch in FAMILY_ARCHS:
        family = REF_ARCHS[arch].family
        if family == "rwkv":  # no cache: its wkv state is split by heads
            continue
        batch, seq = (0, 1) if family == "hybrid" else (1, 2)
        data = "Replicate()" if shape[0] == 1 else f"Shard(dim={batch})"
        placed = got[RUNS[run][0]][run + (arch,)]["placed"]
        assert f"({data}, Shard(dim={seq}))" in placed, (arch, placed)


def test_the_runs_reach_every_shard_case():
    """The setup's arithmetic: the cases the module docstring lists occur
    in the (1, 2) runs (each rank half of the positions; cache lengths
    T + 1 to T + STEPS)."""
    def lens(arch):
        T, S = SHAPES.get(arch, DEFAULT_SHAPE)
        return [T + 1 + i for i in range(STEPS)], S // 2

    n, half = lens("tinyllama-1.1b")
    assert n[0] <= half < n[-1]  # rank 1 empty before pos reaches its offset, then live
    window = _cfg("gemma3-4b").local_window
    n, half = lens("gemma3-4b")
    assert window == 32 and n[0] - window < half < n[0]  # the window across the boundary
    assert all(k - window >= half for k in n[1:])  # then rank 0 outside the window
    for arch in ("mixtral-8x7b", "recurrentgemma-2b"):
        T, S = SHAPES[arch]
        ring = min(S, T, _cfg(arch).local_window) if arch == "recurrentgemma-2b" else min(
            S, _cfg(arch).local_window)
        assert any((T + i) % ring >= ring // 2 for i in range(STEPS)), arch  # rank 1's half


def test_a_one_rank_mesh_is_the_engine_without_a_mesh():
    """DecodeEngine(mesh=) of one rank keeps plain tensors and the step:
    tokens bit for bit those of the engine without a mesh."""
    cfg = _cfg("gemma3-4b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 16).items()}
    with torch.no_grad():
        logits, state = model.prefill(params, batch)
    full = model.rehome_state(state, 32)
    first = sh.argmax_last(logits[:, -1])
    want, want_state, _ = DecodeEngine(lm_decoder(model, use_kernel=True), params).generate(
        full, first, 4)
    mesh_mod.ensure_process_group("cpu")
    try:
        mesh = mesh_mod.make_host_mesh(device_type="cpu")
        engine = DecodeEngine(lm_decoder(model, use_kernel=True), params, mesh=mesh)
        got, got_state, _ = engine.generate(full, first, 4)
    finally:
        dist.destroy_process_group()
    assert mesh.size() == 1 and not engine.sharded and engine.params is params
    assert engine.mode == "eager" and "cpu" in engine.mode_reason
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(got_state), tree_leaves(want_state)):
        assert not isinstance(a, DTensor) and torch.equal(a, b)


def test_argmax_of_vocab_shards_takes_the_first_maximum(worlds):
    """Greedy tokens from vocab-split logits (two shards of 4): a maximum
    tied across the shards and one tied within a shard go to the lower
    index, as jnp.argmax, on every rank."""
    _, got = worlds
    want = jnp.argmax(jnp.asarray(TIED), -1).tolist()
    assert want == [2, 5]
    for rank in range(WORLD):
        assert got[rank]["ties"].tolist() == want
