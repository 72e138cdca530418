"""The port's dry run (`repro_torch.launch.dryrun`) — the counterpart of
tests/test_system.py's dry-run tests: the mesh factory, a module that
starts no process group on import, cells run in a child process at the
reference's world of 512 ranks (``"fake"`` group), and a cell's group
ending with it."""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# the suite runs on six xdist workers on eight cores
torch.set_num_threads(1)
import torch.distributed as dist  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CHILD_ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
TERMS = ("memory", "compute", "collective")


def test_mesh_factory_matches_spec():
    import inspect

    import repro_torch.launch.mesh as mesh_mod

    src = inspect.getsource(mesh_mod.make_production_mesh)
    assert "(2, 16, 16)" in src and "(16, 16)" in src
    assert '("pod", "data", "model")' in src


def test_importing_the_dryrun_module_starts_no_process_group():
    code = ("import torch.distributed as dist, repro_torch.launch.dryrun as d; "
            "assert not dist.is_initialized(); print(d.SIMNET_SHAPES)")
    res = subprocess.run([sys.executable, "-c", code], env=CHILD_ENV, capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "simulate_64k" in res.stdout


def test_a_cells_group_ends_with_it():
    from repro_torch.launch import dryrun

    assert not dist.is_initialized()
    with dryrun.fake_world(False, "cpu") as mesh:
        assert dist.get_world_size() == 256 and tuple(mesh.shape) == (16, 16)
        with pytest.raises(RuntimeError, match="its own process group"):
            with dryrun.fake_world(True, "cpu"):
                pass
    assert not dist.is_initialized()
    with dryrun.fake_world(True, "cpu") as mesh:
        assert dist.get_world_size() == 512 and mesh.mesh_dim_names == ("pod", "data", "model")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def two_cells(tmp_path_factory):
    """tinyllama-1.1b × decode_32k and simnet-c3 × simulate_64k on the
    multi-pod mesh (2 × 16 × 16 = 512 fake ranks), one child process."""
    out = tmp_path_factory.mktemp("dryrun")
    code = ("import sys; from repro_torch.launch.dryrun import main; rcs = ["
            f"main(['--arch', a, '--shape', s, '--multi-pod', '--device', 'cpu', '--out', {str(out)!r}])"
            " for a, s in (('tinyllama-1.1b', 'decode_32k'), ('simnet-c3', 'simulate_64k'))];"
            " sys.exit(max(rcs))")
    res = subprocess.run([sys.executable, "-c", code], env=CHILD_ENV, capture_output=True,
                         text=True, timeout=560, cwd=str(REPO))
    return res, out


def test_dryrun_cells_in_a_child_process(two_cells):
    res, out = two_cells
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert res.stdout.count("done; 0 failures") == 2, res.stdout[-2000:]
    for name in ("tinyllama-1.1b__decode_32k__multipod.json",
                 "simnet-c3__simulate_64k__multipod.json"):
        rec = json.loads((out / name).read_text())
        assert rec["status"] == "ok" and rec["n_devices"] == 512
        assert rec["roofline"]["dominant"] in TERMS
        assert rec["roofline"]["bound_s"] > 0 and rec["compile_seconds"] > 0


def test_the_simnet_cell_runs_no_collective(two_cells):
    """The paper's zero-communication claim: lanes never talk."""
    _, out = two_cells
    rec = json.loads((out / "simnet-c3__simulate_64k__multipod.json").read_text())
    assert rec["collectives"]["total_count"] == 0 and rec["collectives"]["total_bytes"] == 0
    assert rec["lanes_per_device"] == 65536 // 32  # pod × data = 32 lane shards
    assert rec["instructions_per_call"] == 65536 * 64
    assert rec["op_histogram"]["fusion"] == 64  # K1's region, once a step


def test_the_decode_cell_counts_a_ranks_share(two_cells):
    """tinyllama's decode at 512 ranks: the model FLOPs a rank is its share
    of 2 · N · batch, the counted FLOPs at least that (attention and the
    unembed ride on top), and the collectives the sharded step runs."""
    _, out = two_cells
    rec = json.loads((out / "tinyllama-1.1b__decode_32k__multipod.json").read_text())
    mf = rec["model_flops"]
    assert mf["model_flops_per_device"] == mf["model_flops_total"] / 512
    assert 0 < rec["useful_flops_ratio"] <= 1
    assert rec["op_histogram"]["fusion"] == 22  # one decode-attention region a layer
    assert rec["collectives"]["total_count"] > 0
    mem = rec["memory_analysis"]
    assert mem["peak_live_bytes_est"] >= mem["argument_bytes"] > 0


def test_dryrun_artifacts_complete_if_present():
    """If the port's sweep has been run (``--all --both-meshes``), every LM
    cell is ok or skipped and every SimNet cell runs no collective."""
    art = REPO / "artifacts/dryrun_torch"
    if not art.exists():
        pytest.skip("sweep not run in this environment")
    recs = [json.loads(p.read_text()) for p in art.glob("*__*.json")]
    lm = [r for r in recs if not r["arch"].startswith("simnet")]
    assert len(lm) >= 80
    bad = [r for r in recs if not (str(r["status"]) == "ok" or str(r["status"]).startswith("SKIP"))]
    assert bad == [], [(r["arch"], r["shape"], r["status"]) for r in bad]
    for r in recs:
        if r["arch"].startswith("simnet"):
            assert r["collectives"]["total_count"] == 0


# recurrentgemma-2b at one layer (an RG-LRU block) and reduced widths: the
# ops a trace dispatches do not depend on the widths
HYBRID_REDUCED = dict(n_layers=1, d_model=256, n_heads=4, head_dim=64, d_ff=512, vocab=4096,
                      rnn_width=256, rnn_heads=4)


def test_a_shard_to_shard_counts_as_one_all_to_all(monkeypatch):
    """The dry run counts DTensor's ``Shard → Shard`` as the card runs it:
    one ``"all-to-all"`` of its input's bytes per redistribute (each
    counted where DTensor calls it, ``Shard._to_new_shard_dim``), in a
    recurrentgemma-2b × train_4k cell on the CPU. Torch's CPU fallback
    (gloo has no all-to-all) gathers the whole tensor and keeps a chunk:
    without the dry run's routing the same cell counts as many more
    all-gathers and no all-to-all, the group's size (16) times the
    bytes."""
    from torch.distributed.tensor import placement_types

    from repro_torch.launch import dryrun

    seen = [0]
    torch_own = placement_types.Shard._to_new_shard_dim

    def counted(self, *args, **kwargs):
        seen[0] += 1
        return torch_own(self, *args, **kwargs)

    monkeypatch.setattr(placement_types.Shard, "_to_new_shard_dim", counted)
    card = dryrun.lower_cell("recurrentgemma-2b", "train_4k", multi_pod=False,
                             overrides=HYBRID_REDUCED, device_type="cpu")
    n = seen[0]
    monkeypatch.setattr(dryrun, "card_all_to_alls", contextlib.nullcontext)
    fallback = dryrun.lower_cell("recurrentgemma-2b", "train_4k", multi_pod=False,
                                 overrides=HYBRID_REDUCED, device_type="cpu")
    assert n > 0 and seen[0] == 2 * n
    count, moved = card["collectives"]["count_by_op"], card["collectives"]["bytes_by_op"]
    f_count, f_moved = fallback["collectives"]["count_by_op"], fallback["collectives"]["bytes_by_op"]
    assert count["all-to-all"] == n and "all-to-all" not in f_count
    assert f_count["all-gather"] - count["all-gather"] == n
    assert f_moved["all-gather"] - moved["all-gather"] == 16 * moved["all-to-all"]
    for k in ("reduce-scatter", "all-reduce"):
        assert count[k] == f_count[k] and moved[k] == f_moved[k], k
    assert card["rank"] == 0 and set(card["ranks"]) == {"0"}  # a train cell: one trace


def test_a_decode_cell_is_taken_from_its_slower_rank():
    """gemma3-4b × decode_32k at 6 layers (five windowed, one global) on
    the pod mesh: traced as rank 0 and as rank 255. The caches are split
    along their sequence, so a windowed layer's live positions lie on the
    last rank: it reads more, and the record (its counts, its roofline)
    is that rank's, named in ``rank``."""
    from repro_torch.launch import dryrun

    rec = dryrun.lower_cell("gemma3-4b", "decode_32k", multi_pod=False,
                            overrides=dict(n_layers=6), device_type="cpu")
    first, last = rec["ranks"]["0"], rec["ranks"]["255"]
    assert set(rec["ranks"]) == {"0", "255"} and rec["rank"] == 255
    assert last["bytes_accessed"] > first["bytes_accessed"] and last["flops"] > first["flops"]
    assert rec["roofline"] == last["roofline"]
    assert rec["roofline"]["bound_s"] > first["roofline"]["bound_s"]
    assert rec["cost_analysis_raw"]["bytes accessed"] == last["bytes_accessed"]
    assert rec["compile_seconds"] == first["trace_seconds"] + last["trace_seconds"]
    assert not dist.is_initialized()
