"""The mesh substrate of the port against the reference: the rule tables
(`repro_torch.runtime.sharding` vs `repro.runtime.sharding`), DTensor
placements, the elastic plans, the mesh factory, the program key's mesh
fingerprint, Adam's state specs, ``CheckpointManager.restore(shardings=)``
and ``cross_pod_mean``.

The checks that need several ranks run once, in one gloo world of 4 ranks
(a (pod 2, data 2, model 1) mesh): this process is rank 0, the others are
processes started with the spawn method (one intra-op thread each) on a
file store under the module's temporary directory. Every rank runs
`_spmd`; rank 0's results and the followers' (through a queue) are held
to the reference here. The reference is imported only inside the tests,
so the spawned ranks import no JAX.
"""
import dataclasses
import inspect
import multiprocessing
import os
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores: one intra-op thread a
# process keeps torch from oversubscribing the cores the JAX tests time on
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.nn.init import ShardSpec  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime.sharding import (  # noqa: E402
    P,
    batch_pspec,
    make_constrain,
    named,
    rules_for,
    spec_tree_to_shardings,
    to_placements,
    to_pspec,
)
from repro_torch.serving.compile_cache import mesh_fingerprint  # noqa: E402
from repro_torch.training.compression import ErrorFeedbackCompressor, cross_pod_mean  # noqa: E402
from repro_torch.training.optimizer import adam_state_specs  # noqa: E402

MODES = ("train", "prefill", "decode", "decode_long")
MESH_AXES = (("data", "model"), ("pod", "data", "model"))
ARCHS = ("gemma3-4b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b", "qwen3-32b",
         "qwen3-4b", "recurrentgemma-2b", "rwkv6-1.6b", "tinyllama-1.1b", "whisper-large-v3")
WORLD, SHAPE, AXES = 4, (2, 2, 1), ("pod", "data", "model")
TIMEOUT_S = 300
# placements held to the PartitionSpec's meaning on an (8, 4) tensor (every
# split even, as the reference requires): a dim over several mesh axes is
# cut major to minor
PSPECS = (P("data"), P(("pod", "data")), P(None, "pod"), P("pod", "data"), P(None, ("pod", "data")))
# the checkpoint: a tree, and the ShardSpecs of the leaves restored placed
CKPT_SPECS = {"w": ShardSpec(("batch", None)), "e": ShardSpec((None, "batch"))}


def _ckpt_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "e": rng.normal(size=(2, 12)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32), "step": np.int64(5)}


def _grads(pod, data):
    rng = np.random.default_rng(100 + 10 * pod + data)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32) * 1e-3}


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


def _spmd(rank, init, ckpt_dir, queue):
    """One rank of the world: placements, restore and cross_pod_mean.
    Rank 0 returns its results; the others put theirs on ``queue``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        mesh = mesh_mod.make_mesh(SHAPE, AXES, "cpu")
        full = torch.arange(32, dtype=torch.float32).reshape(8, 4)
        constrain = make_constrain(mesh, {"rows": ("pod", "data")})
        out = {"coord": tuple(mesh.get_coordinate()),
               "placed": [named(mesh, *ps)[1] for ps in PSPECS],
               "local": [constrain(full, ("rows",)).to_local().numpy()]}
        for ps in PSPECS:
            out["local"].append(
                distribute_tensor(full, mesh, to_placements(ps, mesh)).to_local().numpy())
        shardings = spec_tree_to_shardings(CKPT_SPECS, rules_for(get_config("tinyllama-1.1b"), "train"),
                                           mesh)
        tree, step = CheckpointManager(ckpt_dir).restore(shardings=shardings)
        out["restored"] = {"step": step, "b": tree["b"], "n": tree["step"],
                           **{k: (tree[k].to_local().numpy(), tree[k].full_tensor().numpy())
                              for k in CKPT_SPECS}}
        pod, data, _ = out["coord"]
        grads = {k: torch.from_numpy(v) for k, v in _grads(pod, data).items()}
        plain, _ = cross_pod_mean(grads, mesh)
        comp = ErrorFeedbackCompressor(bits=8)
        reduced, resid = cross_pod_mean(grads, mesh, compressor=comp, residual=comp.init(grads))
        out["mean"] = {k: v.numpy() for k, v in plain.items()}
        out["mean_int8"] = {k: v.numpy() for k, v in reduced.items()}
        out["residual"] = {k: v.numpy() for k, v in resid.items()}
    finally:
        dist.destroy_process_group()
    if queue is None:
        return out
    queue.put((rank, _plain(out)))


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Every rank's `_spmd` results, by rank (the group ends with it)."""
    from repro.checkpoint.manager import CheckpointManager as RefManager

    ckpt = tmp_path_factory.mktemp("ckpt")
    RefManager(ckpt).save(9, _ckpt_tree())
    init = f"file://{tmp_path_factory.mktemp('world')}/store"
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_spmd, args=(r, init, str(ckpt), queue), daemon=True)
                 for r in range(1, WORLD)]
        for p in procs:
            p.start()
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    try:
        results = {0: _spmd(0, init, str(ckpt), None)}
        for _ in procs:
            rank, out = queue.get(timeout=TIMEOUT_S)
            results[rank] = out
        for p in procs:
            p.join(60)
        assert [p.exitcode for p in procs] == [0] * (WORLD - 1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return results


# ------------------------------------------------------------- rule tables


@pytest.mark.parametrize("arch", ARCHS)
def test_rule_tables_equal_the_reference(arch):
    """Every param's logical axes (the reference's own ShardSpecs, as plain
    tuples) map to the reference's PartitionSpec in every mode, on one pod
    and on two; the rules and the batch spec are the reference's."""
    import jax
    from repro.configs.registry import get_config as ref_get_config
    from repro.configs.registry import list_archs
    from repro.launch.specs import param_shapes_and_specs
    from repro.models.registry import build_model
    from repro.nn.init import ShardSpec as RefShardSpec
    from repro.runtime import sharding as ref

    assert ARCHS == tuple(sorted(list_archs()))
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    _, specs = param_shapes_and_specs(build_model(rcfg))
    axes = [tuple(s.axes) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, RefShardSpec))]
    assert axes
    for mode in MODES:
        rules = rules_for(cfg, mode)
        assert rules == ref.rules_for(rcfg, mode)
        for mesh_axes in MESH_AXES:
            assert batch_pspec(rules, mesh_axes) == tuple(ref.batch_pspec(rules, mesh_axes))
            for a in axes:
                got = to_pspec(a, rules, mesh_axes)
                assert got == tuple(ref.to_pspec(a, rules, mesh_axes)), (mode, mesh_axes, a)
                assert isinstance(got, P) and (not got or got[-1] is not None)


def test_partition_spec_is_a_tuple():
    import pickle

    ps = P(("pod", "data"), None, "model")
    assert ps == (("pod", "data"), None, "model") and pickle.loads(pickle.dumps(ps)) == ps
    assert repr(P("data")) == "PartitionSpec('data',)"


# ----------------------------------------------------------- elastic plans


def test_elastic_plans_equal_the_reference():
    """`tests/test_runtime.py::TestElastic`'s cases, then every world of 1
    to 600 devices at three model axes and two pod sizes, and the plan
    after losing devices: the reference's plans."""
    from repro.runtime import elastic as ref

    p = elastic.choose_mesh(512, model_axis=16, pod_size=256)
    assert p.shape == (2, 16, 16) and p.axes == ("pod", "data", "model")
    p = elastic.choose_mesh(511, model_axis=16, pod_size=256)
    assert p.axes == ("data", "model") and p.n_devices <= 511
    p0 = elastic.choose_mesh(512, model_axis=16, pod_size=256)
    assert elastic.replan_after_failure(p0, 256, model_axis=16).n_devices == 256
    assert elastic.choose_mesh(1, model_axis=16).n_devices == 1
    assert [f.name for f in dataclasses.fields(elastic.MeshPlan)] == [
        f.name for f in dataclasses.fields(ref.MeshPlan)]
    for n in range(1, 601):
        for model_axis in (1, 4, 16):
            for pod in (64, 256):
                got = elastic.choose_mesh(n, model_axis=model_axis, pod_size=pod)
                want = ref.choose_mesh(n, model_axis=model_axis, pod_size=pod)
                assert (got.shape, got.axes, got.n_devices) == (want.shape, want.axes, want.n_devices)
                lost = n // 3
                got = elastic.replan_after_failure(got, lost, model_axis=model_axis)
                want = ref.replan_after_failure(want, lost, model_axis=model_axis)
                assert (got.shape, got.axes) == (want.shape, want.axes)


# ----------------------------------------------------------- mesh factory


def test_mesh_factory_keeps_the_reference_shapes():
    """As `tests/test_system.py::test_mesh_factory_matches_spec` holds the
    reference's: the production meshes' literal shapes and axes."""
    src = inspect.getsource(mesh_mod.make_production_mesh)
    assert "(2, 16, 16)" in src and "(16, 16)" in src
    assert '("pod", "data", "model")' in src


@pytest.fixture
def no_group():
    """The test starts and ends without a default process group."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_host_mesh_starts_a_one_process_group(no_group):
    """Without a process group, `make_host_mesh` starts a one-rank gloo
    group on the CPU and spans it; the fingerprint is the reference's
    for a one-device (data, model) mesh; ``model_axis`` must divide the
    world; ``cuda`` without a GPU raises (no fallback)."""
    import jax
    from jax.sharding import Mesh
    from repro.serving.compile_cache import mesh_fingerprint as ref_fingerprint

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mesh_mod.make_host_mesh()
        assert not dist.is_initialized()
    mesh = mesh_mod.make_host_mesh(device_type="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert tuple(mesh.mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    assert mesh_fingerprint(mesh) == ref_fingerprint(ref_mesh) == (("data", "model"), (1, 1), (0,))
    assert mesh_fingerprint(None) is None
    with pytest.raises(ValueError, match="does not divide"):
        mesh_mod.make_host_mesh(model_axis=2, device_type="cpu")
    built = elastic.build(elastic.choose_mesh(1), device_type="cpu")
    assert tuple(built.mesh.shape) == (1, 1) and built.mesh_dim_names == ("data", "model")
    one = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    assert mesh_fingerprint(one) == (("pod", "data", "model"), (1, 1, 1), (0,))


# --------------------------------------------------------- placements


def _block(full, pspec, coord):
    """The block of ``full`` a device at ``coord`` of the (pod, data, model)
    mesh holds under ``pspec``, by the PartitionSpec's meaning: each dim
    cut into the product of its axes' sizes, major to minor."""
    sizes = dict(zip(AXES, SHAPE))
    where = dict(zip(AXES, coord))
    idx = []
    for d, n in enumerate(full.shape):
        entry = pspec[d] if d < len(pspec) else None
        names = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        parts, k = 1, 0
        for a in names:
            parts, k = parts * sizes[a], k * sizes[a] + where[a]
        idx.append(slice(k * n // parts, (k + 1) * n // parts))
    return full[tuple(idx)]


def test_to_placements_cut_as_the_partition_spec_says(spmd):
    """On the 4-rank mesh each rank's DTensor shard is its block of the
    PartitionSpec; ``("pod", "data")`` on one dim is Shard of that dim on
    both mesh dims, pod major."""
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    assert sorted(r["coord"] for r in spmd.values()) == sorted(np.ndindex(*SHAPE))
    for out in spmd.values():
        assert out["placed"][1] == (Shard(0), Shard(0), Replicate())
        np.testing.assert_array_equal(out["local"][0], _block(full, P(("pod", "data")), out["coord"]))
        for ps, local in zip(PSPECS, out["local"][1:]):
            np.testing.assert_array_equal(local, _block(full, ps, out["coord"]), err_msg=str(ps))


def test_to_placements_refuses_what_a_mesh_cannot_express(no_group):
    mesh = mesh_mod.make_mesh((1, 1, 1), AXES, "cpu")
    with pytest.raises(ValueError, match="major-to-minor"):
        to_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        to_placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        to_placements(P("expert"), mesh)
    assert to_placements(P(), mesh) == (Replicate(),) * 3


# ------------------------------------------------- state on the mesh


def test_adam_state_specs_equal_the_reference():
    from repro.nn.init import ShardSpec as RefShardSpec
    from repro.training.optimizer import adam_state_specs as ref_specs

    specs = {"w": ShardSpec(("embed", "mlp")), "b": ShardSpec((None,))}
    rspecs = {k: RefShardSpec(v.axes) for k, v in specs.items()}
    for keep in (False, True):
        got, want = adam_state_specs(specs, keep_master=keep), ref_specs(rspecs, keep_master=keep)
        assert sorted(got) == sorted(want)
        for k in got:
            g = got[k] if k == "step" else got[k]["w"]
            w = want[k] if k == "step" else want[k]["w"]
            assert tuple(g.axes) == tuple(w.axes), k


def test_restore_places_the_listed_leaves(spmd, tmp_path):
    """The reference's checkpoint restored on every rank with
    ``shardings``: each listed leaf is a DTensor whose full value is what
    the reference restores (on its one device) and whose shard is this
    rank's block; the others are numpy arrays, as without ``shardings``."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.runtime import sharding as ref

    RefManager(tmp_path).save(9, _ckpt_tree())
    ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), AXES)
    rules = ref.rules_for(get_config("tinyllama-1.1b"), "train")
    want, _ = RefManager(tmp_path).restore(shardings={
        k: NamedSharding(ref_mesh, ref.to_pspec(s.axes, rules, AXES)) for k, s in CKPT_SPECS.items()})
    for out in spmd.values():
        got = out["restored"]
        assert got["step"] == 9 and int(got["n"]) == 5
        np.testing.assert_array_equal(got["b"], np.asarray(want["b"]))
        for k, spec in CKPT_SPECS.items():
            local, full = got[k]
            np.testing.assert_array_equal(full, np.asarray(want[k]))
            pspec = to_pspec(spec.axes, rules, AXES)
            np.testing.assert_array_equal(local, _block(full, pspec, out["coord"]), err_msg=k)


@pytest.mark.parametrize("compressed", [False, True])
def test_cross_pod_mean_equals_the_reference(spmd, compressed):
    """Over the pod axis (2 ranks a group): each rank gets the mean of its
    data coordinate's two pods, bit for bit the reference's
    ``cross_pod_mean`` under ``vmap`` over a "pod" axis; int8 with error
    feedback averages the dequantised payloads and keeps each pod's
    residual."""
    import jax
    import jax.numpy as jnp
    from repro.training import compression as ref

    comp = ref.ErrorFeedbackCompressor(bits=8)
    for out in spmd.values():
        pod, data, _ = out["coord"]
        stacked = {k: jnp.stack([jnp.asarray(_grads(p, data)[k]) for p in range(SHAPE[0])])
                   for k in ("w", "b")}

        def one(g, r):
            return ref.cross_pod_mean(g, "pod", comp if compressed else None, r)

        resid = jax.tree_util.tree_map(jnp.zeros_like, stacked)
        mean, new_resid = jax.vmap(one, axis_name="pod")(stacked, resid)
        got = out["mean_int8" if compressed else "mean"]
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], np.asarray(mean[k][pod]), err_msg=k)
            if compressed:
                np.testing.assert_array_equal(out["residual"][k], np.asarray(new_resid[k][pod]))
