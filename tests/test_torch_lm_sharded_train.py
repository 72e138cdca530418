"""Sharded LM training against the JAX package, on the CPU: gloo ranks of
one machine, each a process holding its shards (DTensors placed by the
rule table ``rules_for(cfg, "train")``).

Every rank of each world is a spawned process (`_rank`, with
``OMP_NUM_THREADS=1`` and faulthandler on); they meet at a file store
of their own world, every rank runs the same program, and the test
process only collects what they put on a queue. (The test process, an
xdist worker that has run XLA's CPU runtime and a one-rank group, runs
no collective of these worlds: when rank 0 was this process, one run in
three under the full suite's load died of a segfault in gloo's
all-gather, ROADMAP F7.) Two worlds run in turn, a (data 2,
model 2) mesh of 4 ranks and a (data 1, model 2) mesh of 2; everything is
computed in the module's fixture and the tests read it.

At each mesh, for one arch of every family at reduced width in f32,
from the reference's ``init`` crossed over as numpy arrays:
- the sharded ``forward``'s logits equal the reference's unsharded
  ``forward`` within 1e-5 (rtol and atol; the RG-LRU hybrid within
  test_torch_lm_families.py's 1e-4, since its scan sums in another order
  than XLA's even unsharded);
- one sharded train step at accum_steps 1 and 2 equals the reference's
  unsharded ``make_train_step`` at test_torch_lm_train_loop.py's
  tolerances: loss 1e-5 relative, grad norm 1e-4 relative, every param
  within 2 x lr, and each update (new - old) within 1e-3 relative plus 4
  ulps of the reference's wherever the gradient is above 1e-3 of its
  leaf's largest. (The reference's own sharded launcher does not run with
  the installed JAX, so parity goes through its unsharded step.)

The launcher, ``launch.train.train(model_axis=2)`` on tinyllama-1.1b in
f32: on the (1, 2) ranks it equals ``train()`` in one process (losses
1e-5), every rank returning the same losses; its checkpoint written at
(2, 2) holds the full arrays (the reference's ``CheckpointManager``
reads them), restores onto the (1, 2) mesh as they were saved, and
resumes at (1, 2) and in one process as a one-process run checkpointed
at the same step resumes (the data restarts at step 0 on a resume, the
reference's quirk). Counted: a train step runs no collective on a
(1, 1) mesh, and only all-gathers, reduce-scatters and all-reduces on the
others (the sequence-parallel ``seq`` gathers and partial sums, the
vocab-sharded embedding and cross-entropy, the norm).
"""
import collections
import dataclasses
import faulthandler
import multiprocessing
import os
import shutil
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
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs.base import reduced as ref_reduced  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.models.registry import build_model as ref_build_model  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_train_loop  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.train import extras_for  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.training import optimizer, train_loop  # noqa: E402

# one arch a family; mixtral's experts split over "mlp", phi3.5-moe's
# over "expert" (moe_ep)
FAMILY_ARCHS = ("tinyllama-1.1b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b",
                "recurrentgemma-2b", "whisper-large-v3", "rwkv6-1.6b")
MESHES = ((2, 2), (1, 2))
B, T, LR = 4, 16, 1e-3
LOGIT_TOL = {"hybrid": 1e-4}  # else 1e-5
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
F32_ARCH = "tinyllama-f32"  # tinyllama-1.1b computing in f32, for the launcher
TRAIN_KW = dict(reduced=True, batch=4, seq=32, device="cpu", log_every=0)
IMPLIED = {"all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"}
TIMEOUT_S = 300


def _register_f32():
    registry.ARCHS[F32_ARCH] = dataclasses.replace(registry.ARCHS["tinyllama-1.1b"],
                                                   dtype="float32")


def _batch(cfg):
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "loss_mask": (rng.random((B, T)) < 0.8).astype(np.float32)}
    batch.update({k: np.asarray(f(B, T)) for k, f in extras_for(cfg).items()})
    return batch


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference(arch):
    """The reference's f32 params, batch, logits and one unsharded train
    step at accum_steps 1 and 2 (metrics, new params)."""
    rcfg = ref_reduced(REF_ARCHS[arch], dtype="float32")
    rm = ref_build_model(rcfg)
    rparams, _ = rm.init(jax.random.PRNGKey(3))
    batch = _batch(reduced(registry.ARCHS[arch], dtype="float32"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = np.asarray(jax.jit(lambda p, b: rm.forward(p, b)[0])(rparams, jb))
    steps = {}
    for accum in (1, 2):
        step = jax.jit(ref_train_loop.make_train_step(rm, ref_opt.AdamConfig(lr=LR),
                                                      accum_steps=accum))
        p, o, m = step(rparams, ref_opt.adam_init(rparams), jb)
        steps[accum] = ({k: float(v) for k, v in m.items()}, _np_tree(p), _np_tree(o["m"]))
    return {"params": _np_tree(rparams), "batch": batch, "logits": logits, "steps": steps}


def _sharded_step(model, mesh, params, accum):
    cfg = model.cfg
    rules, specs = sh.rules_for(cfg, "train"), model.param_specs()
    step = train_loop.make_train_step(
        model, optimizer.AdamConfig(lr=LR), constrain=sh.make_constrain(mesh, rules),
        accum_steps=accum, grad_shardings=sh.spec_tree_to_shardings(specs, rules, mesh),
        layer_specs=model.layer_specs())
    return (step, sh.shard_tree(params, specs, rules, mesh),
            sh.shard_tree(optimizer.adam_init(params), optimizer.adam_state_specs(specs), rules,
                          mesh))


def _counted_step(mesh, metrics=False):
    """Collectives (calls by kind) of one tinyllama train step on ``mesh``,
    after a first step; with ``metrics``, also that step's metrics."""
    model = build_model(reduced(registry.ARCHS["tinyllama-1.1b"], dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu", masters=True)
    step, p, o = _sharded_step(model, mesh, params, 2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    step(p, o, batch)
    with mesh_mod.CollectiveCounter() as counter:
        _, _, m = step(p, o, batch)
    if metrics:
        return dict(counter.calls), {k: float(v) for k, v in m.items()}
    return dict(counter.calls)


def _plain(tree):
    """``tree`` with every tensor as a numpy array: what a rank puts on a
    queue. A tensor would travel as a handle to its storage, which the
    parent can open only while the sending rank is alive, and a rank
    exits as soon as it has put its results."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _tensors(tree):
    """`_plain`'s inverse for what rank 0 sends: arrays back to tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


def _rank(rank, world, shape, init, inputs, ckpt, queue):
    """One rank's program in a world of ``shape``; it puts its results on
    ``queue`` (rank 0's in full, the others' metrics and losses)."""
    faulthandler.enable(all_threads=True)  # a crash prints every thread's stack
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    out = {"families": {}}
    try:
        _register_f32()
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
        for arch, (params_np, batch_np) in inputs.items():
            model = build_model(reduced(registry.ARCHS[arch], dtype="float32"))
            params = model.params_from_numpy(params_np, "cpu", masters=True)
            batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
            rules, specs = sh.rules_for(model.cfg, "train"), model.param_specs()
            logits, _ = model.forward(sh.shard_tree(params, specs, rules, mesh), batch,
                                      constrain=sh.make_constrain(mesh, rules),
                                      layer_specs=model.layer_specs())
            res = {"logits": logits.full_tensor().numpy(), "steps": {}}
            for accum in (1, 2):
                step, p, o = _sharded_step(model, mesh, params, accum)
                new_p, new_o, m = step(p, o, batch)
                assert all(a.placements == b.placements for a, b in
                           zip(tree_leaves(new_p), tree_leaves(p)))
                res["steps"][accum] = ({k: float(v) for k, v in m.items()},
                                       sh.full_tree(new_p), int(new_o["step"].full_tensor()))
            out["families"][arch] = res if rank == 0 else {
                a: r[0] for a, r in res["steps"].items()}
        out["collectives"] = _counted_step(mesh)
        if shape == (2, 2):  # a checkpoint at step 2, written by rank 0
            out["train"] = port_train.train(F32_ARCH, steps=2, model_axis=2, ckpt_dir=ckpt["22"],
                                            **TRAIN_KW)["losses"]
        else:
            res = port_train.train(F32_ARCH, steps=3, model_axis=2, **TRAIN_KW)
            out["train"], out["mesh"] = res["losses"], res["mesh"]
            model = build_model(reduced(registry.ARCHS[F32_ARCH]))
            like = model.init(torch.Generator().manual_seed(0), device="cpu", masters=True)
            rules, specs = sh.rules_for(model.cfg, "train"), model.param_specs()
            shardings = {"params": sh.spec_tree_to_shardings(specs, rules, mesh),
                         "opt": sh.spec_tree_to_shardings(optimizer.adam_state_specs(specs),
                                                          rules, mesh)}
            params, opt, step = port_train.restore_state(CheckpointManager(ckpt["12"]), model,
                                                         "cpu", like, shardings)
            restored = (step, sh.full_tree(params), sh.full_tree(opt),
                        [tuple(x.placements) for x in tree_leaves(params)])
            if rank == 0:  # the followers send no tensors
                out["restored"] = restored
            out["resumed"] = port_train.train(F32_ARCH, steps=4, model_axis=2,
                                              ckpt_dir=ckpt["12"], **TRAIN_KW)["losses"]
    finally:
        dist.destroy_process_group()
    queue.put((rank, _plain(out)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results: {shape: (rank 0's, [the others'])}, the
    references, and the one-process runs."""
    _register_f32()
    ckpt = {k: str(tmp_path_factory.mktemp(f"ckpt{k}")) for k in ("22", "12", "1", "alone")}
    ctx = multiprocessing.get_context("spawn")
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    out = {}
    try:
        # the one-process runs: train() alone, and a checkpoint at step 2
        # resumed to step 4
        out["alone"] = port_train.train(F32_ARCH, steps=3, **TRAIN_KW)["losses"]
        port_train.train(F32_ARCH, steps=2, ckpt_dir=ckpt["alone"], **TRAIN_KW)
        out["alone_resumed"] = port_train.train(F32_ARCH, steps=4, ckpt_dir=ckpt["alone"],
                                                **TRAIN_KW)["losses"]
        mesh_mod.ensure_process_group("cpu")
        try:
            out["collectives_1x1"] = _counted_step(mesh_mod.make_mesh((1, 1), ("data", "model"),
                                                                      "cpu"))
        finally:
            dist.destroy_process_group()
        out["refs"] = {a: _reference(a) for a in FAMILY_ARCHS}
        inputs = {a: (r["params"], r["batch"]) for a, r in out["refs"].items()}
        for shape in MESHES:
            world = shape[0] * shape[1]
            if shape == (1, 2):  # resume the (2, 2) checkpoint here and alone
                for k in ("12", "1"):
                    shutil.copytree(ckpt["22"], ckpt[k], dirs_exist_ok=True)
            init = f"file://{tmp_path_factory.mktemp('world')}/store"
            queue = ctx.Queue()
            procs = [ctx.Process(target=_rank, args=(r, world, shape, init, inputs, ckpt, queue),
                                 daemon=True) for r in range(world)]
            for p in procs:
                p.start()
            try:
                others = dict(queue.get(timeout=TIMEOUT_S) for _ in procs)
                mine = _tensors(others.pop(0))
            finally:
                for p in procs:
                    p.join(TIMEOUT_S)
                    if p.is_alive():
                        p.kill()
            assert all(p.exitcode == 0 for p in procs)
            out[shape] = (mine, [others[r] for r in sorted(others)])
        out["resumed_alone"] = port_train.train(F32_ARCH, steps=4, ckpt_dir=ckpt["1"],
                                                **TRAIN_KW)["losses"]
        out["saved"] = (CheckpointManager(ckpt["22"]).restore(),
                        RefCheckpointManager(ckpt["22"]).restore())
    finally:
        registry.ARCHS.pop(F32_ARCH, None)
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}#{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_forward_equals_the_reference(worlds, arch, shape):
    ref = worlds["refs"][arch]
    got = worlds[shape][0]["families"][arch]["logits"]
    tol = LOGIT_TOL.get(REF_ARCHS[arch].family, 1e-5)
    np.testing.assert_allclose(got, ref["logits"], rtol=tol, atol=tol)


@pytest.mark.parametrize("accum", (1, 2))
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_train_step_equals_the_reference(worlds, arch, shape, accum):
    r_metrics, r_params, r_m = worlds["refs"][arch]["steps"][accum]
    mine, others = worlds[shape]
    metrics, params, n = mine["families"][arch]["steps"][accum]
    assert n == 1 and sorted(metrics) == sorted(r_metrics)
    for k in metrics:
        rtol = NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(metrics[k], r_metrics[k], rtol=rtol, err_msg=k)
    for o in others:  # every rank returns the same metrics
        assert o["families"][arch][accum] == metrics
    model = build_model(reduced(registry.ARCHS[arch], dtype="float32"))
    want, old, want_m = (model.params_from_numpy(t, "cpu", masters=True)
                         for t in (r_params, worlds["refs"][arch]["params"], r_m))
    n_large = 0
    for p, w, o, wm in zip(*(tree_leaves(t) for t in (params, want, old, want_m))):
        assert p.shape == w.shape and float((p - w).abs().max()) <= 2 * LR
        # each update (new - old) is about lr x sign(g) where the gradient is
        # large: a missing, misplaced or wrong-signed update fails here
        du, want_du = p - o, w - o
        large = wm.abs() > 1e-3 * float(wm.abs().max())  # m = (1 - b1) g after one step
        tol = 1e-3 * want_du.abs() + 4 * torch.finfo(torch.float32).eps * o.abs()
        assert not bool((((du - want_du).abs() > tol) & large).any()), (
            f"update off the reference's where the gradient is large, max |diff| "
            f"{float((du - want_du)[large].abs().max()):.3e}")
        n_large += int(large.sum())
    assert n_large > 0


def test_launch_train_on_ranks_equals_one_process(worlds):
    mine, others = worlds[(1, 2)]
    assert mine["mesh"] == (1, 2)
    np.testing.assert_allclose(mine["train"], worlds["alone"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(worlds[(2, 2)][0]["train"], worlds["alone"][:2], rtol=LOSS_RTOL)
    for o in others:
        assert o["train"] == mine["train"]
    for o in worlds[(2, 2)][1]:
        assert o["train"] == worlds[(2, 2)][0]["train"]


def test_checkpoint_resumes_across_topologies(worlds):
    (saved, _), (ref_saved, ref_step) = worlds["saved"]
    flat = _flat(saved)
    assert ref_step == 2 and flat.keys() == _flat(ref_saved).keys()
    for k, v in _flat(ref_saved).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    step, params, opt, placements = worlds[(1, 2)][0]["restored"]
    assert step == 2
    got = _flat({"params": params, "opt": opt})
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert any(p != (Replicate(), Replicate()) for p in placements)  # placed, not copied
    # resumed at (1, 2) and alone from the (2, 2) checkpoint, as a one-process
    # run checkpointed at step 2 resumes
    for resumed in (worlds[(1, 2)][0]["resumed"], worlds["resumed_alone"]):
        assert len(resumed) == 2
        np.testing.assert_allclose(resumed, worlds["alone_resumed"], rtol=LOSS_RTOL)
    for o in worlds[(1, 2)][1]:
        assert o["resumed"] == worlds[(1, 2)][0]["resumed"]


def _staged_rank(rank, init, root, queue):
    """A rank of two: one step plain, then with the all-gather and the
    reduce-scatter exchanged through the ranks' shared buffers
    (`launch.mesh.exchange_through_peer_buffers`, here files under
    ``root`` in host memory: a process-wide override, so only in spawned
    ranks)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), "cpu")
        plain = _counted_step(mesh, metrics=True)
        mesh_mod.exchange_through_peer_buffers("cpu", root)
        staged = _counted_step(mesh, metrics=True)
        # a collective larger than the buffers makes every rank grow them
        mesh_mod.EXCHANGE_MIN_BYTES = 1 << 10
        mesh_mod.close_peer_buffers()
        x = torch.arange(4096, dtype=torch.float32) * (rank + 1)
        grown = [sh.place(x, mesh, (Replicate(), Shard(0))).full_tensor()
                 for x in (x[:64], x)]
        ops = torch.ops._c10d_functional
        group = mesh["model"].get_group().group_name
        summed = ops.wait_tensor(ops.reduce_scatter_tensor(x, "sum", 2, group))
        out = (plain, staged, dict(mesh_mod.EXCHANGED), grown, summed, os.listdir(root),
               _all_to_alls(rank, group))
        mesh_mod.close_peer_buffers()
    finally:
        dist.destroy_process_group()
    queue.put((rank, _plain(out)))


# the all-to-alls of `_all_to_alls`: rank r's input rows and how it splits
# them between the ranks (equal: empty sizes)
A2A_ROWS, A2A_SPLITS = (4, 7), ((1, 3), (2, 5))


def _a2a_input(rank, rows, cols=3):
    return torch.arange(rows * cols, dtype=torch.float32).view(rows, cols) + 100 * (rank + 1)


def _all_to_alls(rank, group):
    """What two ranks' all-to-alls give through the peer buffers:
    ``all_to_all_single`` with equal and unequal splits and
    ``_dtensor.shard_dim_alltoall`` (DTensor's ``Shard(0) → Shard(1)``),
    with the calls `CollectiveCounter` counts and the bytes `EXCHANGED`
    adds."""
    ops = torch.ops._c10d_functional
    before = collections.Counter(mesh_mod.EXCHANGED)
    with mesh_mod.CollectiveCounter() as counter:
        equal = ops.wait_tensor(ops.all_to_all_single(_a2a_input(rank, 8), [], [], group))
        outs = [s[rank] for s in A2A_SPLITS]
        unequal = ops.wait_tensor(ops.all_to_all_single(_a2a_input(rank, A2A_ROWS[rank]), outs,
                                                        list(A2A_SPLITS[rank]), group))
        moved = torch.ops._dtensor.shard_dim_alltoall(_a2a_input(rank, 4, 6), 0, 1, group)
    exchanged = dict(collections.Counter(mesh_mod.EXCHANGED) - before)
    return equal, unequal, moved, dict(counter.calls), dict(counter.bytes), exchanged


def test_the_all_gather_staged_through_host_gives_the_same_step(tmp_path):
    """What two ranks sharing a card run (gloo's functional all-gather
    crashes on CUDA tensors, its reduce-scatter crawls through the host),
    here on CPU tensors through buffers in host memory: the same
    collectives and metrics bit for bit (a sum of two addends is the same
    in either order), the bytes counted, buffers grown when a collective
    outgrows them, no file left behind; the all-to-alls (equal and
    unequal splits, and DTensor's ``Shard → Shard``) equal what chunking
    and joining the ranks' inputs gives, counted by `CollectiveCounter`
    and in `EXCHANGED`; and the backend each layout of ranks gets."""
    assert mesh_mod.rank_backend("cpu", 4) == "gloo"
    assert mesh_mod.rank_backend("cuda", 2, n_cards=1) == "cpu:gloo,cuda:gloo"
    assert mesh_mod.rank_backend("cuda", 4, n_cards=4) == "cpu:gloo,cuda:nccl"
    # two hosts of 8 cards and 8 ranks each: a card a rank, NCCL
    assert mesh_mod.rank_backend("cuda", 16, n_cards=8, local_world_size=8) == "cpu:gloo,cuda:nccl"
    assert mesh_mod.rank_backend("cuda", 16, n_cards=8, local_world_size=16) == "cpu:gloo,cuda:gloo"
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    init = f"file://{tmp_path}/store"
    root = tmp_path / "buffers"
    root.mkdir()
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_staged_rank, args=(r, init, str(root), queue), daemon=True)
                 for r in range(2)]
        for p in procs:
            p.start()
        got = dict(queue.get(timeout=TIMEOUT_S) for _ in procs)
        for p in procs:
            p.join(TIMEOUT_S)
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    assert all(p.exitcode == 0 for p in procs)
    x = torch.arange(4096, dtype=torch.float32)
    for rank, ((calls, metrics), (s_calls, s_metrics), moved, grown, summed, left,
               a2a) in got.items():
        assert calls == s_calls and metrics == s_metrics, rank
        equal, unequal, sdim, a2a_calls, a2a_bytes, a2a_moved = a2a
        assert np.array_equal(equal, torch.cat([_a2a_input(r, 8).chunk(2)[rank]
                                                for r in range(2)]).numpy())
        assert np.array_equal(unequal, torch.cat([
            _a2a_input(r, A2A_ROWS[r]).split(A2A_SPLITS[r])[rank] for r in range(2)]).numpy())
        assert np.array_equal(sdim, torch.cat([_a2a_input(r, 4, 6).chunk(2, dim=1)[rank]
                                               for r in range(2)], dim=0).numpy())
        sent = [8 * 3 * 4, A2A_ROWS[rank] * 3 * 4, 4 * 6 * 4]
        assert a2a_calls == {"all_to_all_single": 2, "shard_dim_alltoall": 1}, rank
        assert a2a_bytes == {"all_to_all_single": sent[0] + sent[1],
                             "shard_dim_alltoall": sent[2]}, rank
        assert a2a_moved == a2a_bytes, rank
        assert moved["all_gather_into_tensor"] > 0 and moved["reduce_scatter_tensor"] > 0, rank
        assert np.array_equal(grown[0], torch.cat([x[:32], 2 * x[32:64]]).numpy())
        assert np.array_equal(grown[1], torch.cat([x[:2048], 2 * x[2048:]]).numpy())
        assert np.array_equal(summed, (3 * x[2048 * rank:2048 * (rank + 1)]).numpy())
        assert left == [], rank


def test_a_step_runs_only_the_collectives_the_rules_imply(worlds):
    assert worlds["collectives_1x1"] == {}
    for shape in MESHES:
        for calls in [worlds[shape][0]["collectives"]] + [o["collectives"] for o in worlds[shape][1]]:
            assert calls and set(calls) <= IMPLIED, (shape, calls)
